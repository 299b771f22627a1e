"""ms a frame of device time in the C4 model's res5 ROI head over the
profiled stretch: the kernels and copies launched inside the program's
spans ``track.res5_box`` (ROIAlign, res5 and the box predictor on every
proposal) and ``track.res5_mask`` (res5 rerun on the detection slots and the
mask head)."""


def read(record):
    return record.get("res5_ms")
