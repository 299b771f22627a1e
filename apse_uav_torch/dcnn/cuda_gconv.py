"""Wrapper of the grouped 3x3 convolution kernel (``csrc/gconv.cu``): a
ResNeXt bottleneck's conv2 on the card, float32, for inference.

Replaces no TPU kernel (the JAX package has no ResNeXt); on the card it takes
the place of cuDNN's grouped float32 convolution in
:class:`apse_uav_torch.dcnn.models.resnet.GroupedConvNorm`.  The plain
version is ``F.conv2d`` (``resnet.conv``), which that module keeps on the
CPU and under autograd.

:func:`supports` says, without CUDA, which convolutions the kernel takes:
3x3, padding 1, dilation 1, stride 1 or 2, as many channels out as in, and
8, 16, 32 or 64 channels a group (X101-32x8d's res2 ... res5).  :func:`conv`
launches it on a CUDA tensor, once a call on the current stream with no sync,
or raises; ``launch.gconv`` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from apse_uav_torch import _build

# The source, csrc/gconv.cu, and its launch-count name.
NAME = "gconv"
# The kernel's name in a profiler trace (a template: every instance's name holds it).
DEVICE_NAME = "gconv3x3_kernel"
# Channels a group and strides the kernel's instances take.
WIDTHS = (8, 16, 32, 64)
STRIDES = (1, 2)


def _pair(v) -> tuple:
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def supports(in_channels: int, out_channels: int, groups: int, kernel_size, stride, padding=1, dilation=1) -> bool:
    """Whether the kernel computes this convolution (a ``nn.Conv2d``'s
    fields); needs no CUDA."""
    if groups < 1 or in_channels != out_channels or in_channels % groups:
        return False
    s = _pair(stride)
    return (in_channels // groups in WIDTHS and _pair(kernel_size) == (3, 3) and _pair(padding) == (1, 1)
            and _pair(dilation) == (1, 1) and s[0] == s[1] and s[0] in STRIDES)


@functools.cache
def _entry():
    """The C entry point ``gconv_launch``, loaded (and built) once."""
    fn = _build.load(NAME).gconv_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    return fn


def conv(x: torch.Tensor, weight: torch.Tensor, stride, groups: int) -> torch.Tensor:
    """x (N, C, H, W) float32 NCHW-contiguous on a CUDA device, weight (C,
    C / groups, 3, 3) float32 contiguous on the same device -> (N, C, Ho,
    Wo), the grouped convolution with padding 1 (``F.conv2d(x, weight, None,
    stride, 1, 1, groups)``, summed in the kernel's fixed order)."""
    if x.device.type != "cuda" or weight.device != x.device:
        raise ValueError(f"x and weight must be on one CUDA device, got {x.device} and {weight.device}")
    if x.dtype != torch.float32 or weight.dtype != torch.float32:
        raise ValueError(f"x and weight must be float32, got {x.dtype} and {weight.dtype}")
    if x.dim() != 4 or weight.dim() != 4 or not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("x and weight must be 4-D and contiguous (NCHW)")
    n, c, h, w = x.shape
    if (weight.shape[0] != c or weight.shape[1] * groups != c
            or not supports(c, weight.shape[0], groups, tuple(weight.shape[2:]), stride)):
        raise ValueError(f"the grouped 3x3 kernel does not take x {tuple(x.shape)}, weight {tuple(weight.shape)}, "
                         f"stride {stride}, {groups} groups")
    s = _pair(stride)[0]
    y = torch.empty((n, c, (h - 1) // s + 1, (w - 1) // s + 1), dtype=torch.float32, device=x.device)
    err = _entry()(_build.ptr(x), _build.ptr(weight), _build.ptr(y), n, c, h, w, c // groups, s,
                   _build.stream_ptr(x.device))
    _build.check(err, DEVICE_NAME)
    _build.count(NAME)
    return y
