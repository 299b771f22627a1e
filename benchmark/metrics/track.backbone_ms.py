"""ms a frame of R101 + FPN (``model.features``) on one batch, alone between synchronizes."""


def read(record):
    return record.get("backbone_ms")
