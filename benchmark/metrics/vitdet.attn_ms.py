"""ms a frame of device time in ViTDet's attention cores over the profiled
stretch: the kernels and copies launched inside the program's spans
``track.attn_global`` and ``track.attn_window`` (the scaled scores, the
relative positions, the softmax and the product with the values; not the
qkv or output projections), 12 a forward of ViTDet-B."""


def read(record):
    total = (record.get("attn_global_s") or 0.0) + (record.get("attn_window_s") or 0.0)
    if not total or not record.get("frames"):
        return None
    return total * 1e3 / record["frames"]
