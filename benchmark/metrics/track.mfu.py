"""The whole step's share of the card's float32 peak over the measured
window, %: the model's FLOPs a frame (``benchkit/yardstick.py``: backbone,
FPN, RPN head, box head on every proposal, mask head on the detections
kept, re-ID head; not the resize) times the window's frames, over the window's
seconds and 67 TFLOP/s (TF32 is off)."""

from benchkit.yardstick import PEAK_F32


def read(record):
    if not record.get("flops_per_frame") or not record.get("e2e_window_s"):
        return None
    return 100.0 * record["flops_per_frame"] * record["e2e_frames"] / record["e2e_window_s"] / PEAK_F32
