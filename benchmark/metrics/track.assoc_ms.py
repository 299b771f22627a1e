"""ms a frame of the top-k cap, the re-ID embeddings and the association
(gated auction and track update) of one batch, alone between synchronizes,
from the same track state each time."""


def read(record):
    return record.get("assoc_ms")
