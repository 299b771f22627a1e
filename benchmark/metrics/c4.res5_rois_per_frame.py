"""ROIs a frame that the C4 model ran through res5 in the profiled stretch:
the program's counter ``c4.res5_rois`` (B * N at every ROI transform: the
post-NMS proposals, then every detection slot for the masks, valid or not)
over the stretch's frames."""


def read(record):
    if not record.get("res5_rois") or not record.get("frames"):
        return None
    return record["res5_rois"] / record["frames"]
