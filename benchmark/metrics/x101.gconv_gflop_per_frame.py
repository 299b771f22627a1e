"""GFLOP a frame of the X101 trunk's grouped 3 x 3 convolutions in the
profiled stretch: the program's counter ``x101.gconv_flops`` (2 x N x C_out
x H_out x W_out x C_in / groups x 9 at each grouped convolution, from the
shapes) over the stretch's frames."""


def read(record):
    if not record.get("gconv_flops") or not record.get("frames"):
        return None
    return record["gconv_flops"] / record["frames"] / 1e9
