"""Two-pass preprocessing helpers: pooled camera, pooled plan size, source pool.

Counterpart of the JAX reference's ``preproc/twopass.py``.  Pass 1 pools the
distorted source by the proposal stride and remaps it on a pooled camera
(proposal scoring only); pass 2 recomputes exact full-resolution gray under
the tiles that the candidates' patches cover (see
:mod:`apse_uav_torch.aruco.patch_select`).  The pool is plain PyTorch: the
shipped reference does this step in XLA, not in a Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch


def pooled_camera(mtx: np.ndarray, st: int) -> np.ndarray:
    """Camera matrix for remapping the st-pooled source on the pooled grid:
    fx' = fx/st, cx' = (cx - (st-1)/2)/st (pooled pixel p covers source
    pixels [st*p, st*p + st))."""
    c = (st - 1) / 2.0
    m = np.array(mtx, dtype=np.float64)
    m[0, 0] /= st
    m[1, 1] /= st
    m[0, 2] = (m[0, 2] - c) / st
    m[1, 2] = (m[1, 2] - c) / st
    return m


def pooled_frame_size(width: int, height: int, st: int) -> tuple[int, int]:
    """Pooled (W', H'): W // st padded to a multiple of 128, H // st to a
    multiple of 32, so the pooled plan's tile grid divides it."""
    w, h = width // st, height // st
    return (-(-w // 128) * 128, -(-h // 32) * 32)


def pool_source_u8(frames: torch.Tensor, st: int, out_hw: tuple[int, int]) -> torch.Tensor:
    """Mean-pool planar u8 frames (B, 3, H, W) by st, rounded as
    (sum + st*st/2) // (st*st), zero-padded to out_hw = (H', W')."""
    b, c, h, w = frames.shape
    h4, w4 = h // st, w // st
    s = frames[:, :, : h4 * st, : w4 * st].to(torch.int32).reshape(b, c, h4, st, w4, st).sum(dim=(3, 5))
    area = st * st
    pooled = torch.div(s + area // 2, area, rounding_mode="floor").to(torch.uint8)
    hp, wp = out_hw
    out = torch.zeros((b, c, hp, wp), dtype=torch.uint8, device=frames.device)
    out[:, :, :h4, :w4] = pooled
    return out
