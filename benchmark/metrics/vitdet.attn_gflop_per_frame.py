"""GFLOP a frame of ViTDet's attention cores in the profiled stretch: the
program's counter ``vitdet.attn_flops`` (4 x heads x N_q x N_k x d for the
two products plus 2 x heads x N_q x (k_h + k_w) x d for the
relative-position products, over each core's images or windows, from the
shapes) over the stretch's frames."""


def read(record):
    if not record.get("attn_flops") or not record.get("frames"):
        return None
    return record["attn_flops"] / record["frames"] / 1e9
