"""The res5 box head's share of the card's float32 peak over the profiled
stretch, %: the FLOPs of res5 and the box predictor on every post-NMS
proposal (``benchkit/yardstick_c4.py``) over the device time launched inside
the program's span ``track.res5_box`` (which also holds the ROIAlign
gathers) and 67 TFLOP/s (TF32 is off)."""

from benchkit.yardstick import PEAK_F32


def read(record):
    if not record.get("res5_box_s") or not record.get("res5_box_flops"):
        return None
    return 100.0 * record["res5_box_flops"] / record["res5_box_s"] / PEAK_F32
