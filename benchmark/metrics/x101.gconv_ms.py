"""ms a frame of device time in the X101 trunk's grouped 3 x 3 convolutions
over the profiled stretch: the kernels and copies launched inside the
program's span ``track.gconv`` (the convolution of each bottleneck's conv2
alone, not its frozen BN), 33 a forward of X101."""


def read(record):
    return record.get("gconv_ms")
