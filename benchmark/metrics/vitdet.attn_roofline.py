"""ViTDet's attention cores' share of their roofline over the profiled
stretch, %: the least time the card needs for them (each call's larger of
its FLOPs over 67 TFLOP/s and its float32 bytes, q, k, v and the output
once each and the relative-position tables, over 3.35 TB/s, from the
configuration's shapes by ``benchkit/yardstick_vitdet.py``, summed over the
stretch's forwards) over the device time launched inside the program's
spans ``track.attn_global`` and ``track.attn_window``."""


def read(record):
    total = (record.get("attn_global_s") or 0.0) + (record.get("attn_window_s") or 0.0)
    if not total or not record.get("attn_bound_s"):
        return None
    return 100.0 * record["attn_bound_s"] / total
