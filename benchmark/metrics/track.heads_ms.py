"""ms a frame of the RPN (head, top-k, NMS) and the ROI heads (box, class NMS,
masks) on one batch, alone between synchronizes."""


def read(record):
    return record.get("heads_ms")
