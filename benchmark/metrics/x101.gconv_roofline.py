"""The grouped 3 x 3 convolutions' share of their roofline over the profiled
stretch, %: the least time the card needs for them (each call's larger of
its FLOPs over 67 TFLOP/s and its float32 bytes over 3.35 TB/s, from the
configuration's shapes by ``benchkit/yardstick_x101.py``, summed over the
stretch's forwards) over the device time launched inside the program's
span ``track.gconv``."""


def read(record):
    if not record.get("gconv_s") or not record.get("gconv_bound_s"):
        return None
    return 100.0 * record["gconv_bound_s"] / record["gconv_s"]
