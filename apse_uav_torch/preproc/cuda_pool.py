"""Wrapper of kernel K5 (``csrc/pool.cu``): 4x4 mean pool of the planar u8 source.

Replaces the JAX reference's ``preproc/pallas_pool.py`` (``pool_packed_rows``), step
1 of the two-pass front.  The reference pools its i32 byte-packed source and
repacks the result on the MXU; those are TPU layout artefacts and are not
ported: the kernel takes planar u8 ``(B, 3, H, W)`` frames and writes the
pooled plan's planar u8 ``(B, 3, H', W')`` geometry, pad included.

On a CPU tensor the wrapper runs the plain version
(:func:`apse_uav_torch.preproc.twopass.pool_source_u8`); on a CUDA tensor it
launches the kernel or raises.  Both give the same bytes.
"""

from __future__ import annotations

import ctypes

import torch

from apse_uav_torch import _build
from apse_uav_torch.preproc.twopass import pool_source_u8

NAME = "pool"
STRIDE = 4  # the kernel pools by 4, as the reference's does
_MAX_GRID_YZ = 65535


def pool_source(frames: torch.Tensor, st: int, out_hw: tuple[int, int]) -> torch.Tensor:
    """Mean-pool planar u8 frames (B, C, H, W) by st, rounded as
    (sum + st*st/2) // (st*st), zero-padded to out_hw = (H', W')."""
    if frames.dtype != torch.uint8 or frames.dim() != 4:
        raise ValueError(f"frames must be planar (B, C, H, W) uint8, got {tuple(frames.shape)} {frames.dtype}")
    b, c, h, w = frames.shape
    hp, wp = out_hw
    if hp < h // st or wp < w // st:
        raise ValueError(f"out_hw {out_hw} smaller than the pooled frame {(h // st, w // st)}")
    if frames.device.type == "cpu":
        return pool_source_u8(frames, st, out_hw)
    if st != STRIDE:
        raise ValueError(f"the pool kernel pools by {STRIDE}, got stride {st}")
    if w % 4:
        raise ValueError(f"the pool kernel reads 4-byte words: width {w} must be a multiple of 4")
    if not frames.is_contiguous() or frames.data_ptr() % 4:
        raise ValueError("the pool kernel needs contiguous frames on a 4-byte aligned address")
    if b * c > _MAX_GRID_YZ or hp > _MAX_GRID_YZ:
        raise ValueError(f"{b * c} planes or {hp} rows exceed the kernel's grid")
    out = torch.empty((b, c, hp, wp), dtype=torch.uint8, device=frames.device)
    if out.numel() == 0:
        return out
    fn = _build.load("pool").pool4_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    err = fn(_build.ptr(frames), _build.ptr(out), b * c, h, w, hp, wp, _build.stream_ptr(frames.device))
    _build.check(err, "pool4_kernel")
    _build.count(NAME)
    return out
