"""ms a frame of device time in ViTDet's global attention cores over the
profiled stretch: the kernels and copies launched inside the program's span
``track.attn_global`` (4 a forward of ViTDet-B, each over all 64 x 64
tokens)."""


def read(record):
    if not record.get("attn_global_s") or not record.get("frames"):
        return None
    return record["attn_global_s"] * 1e3 / record["frames"]
