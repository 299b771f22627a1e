"""Undistort (bilinear remap) + LAB gamma + gray in plain PyTorch.

Counterpart of the JAX reference's ``preproc/remap.py`` and the plain version of
kernels K3/K4 (``csrc/remap.cu``, wrapped by :mod:`.cuda_remap`).  Frames are
planar u8 ``(B, 3, H, W)`` in the reference's stored (BGR) order; the map is
the float32 ``(Ho, Wo, 2)`` source position of every output pixel
(:func:`apse_uav_torch.core.camera.undistort_rectify_map`).

Border semantics match cv2.remap's BORDER_CONSTANT(0): taps outside the
source contribute 0.  The blend is written one op per rounding, in the same
order as the kernel, so the kernel's output can be held to it bit for bit.
"""

from __future__ import annotations

import torch

from apse_uav_torch.core import camera, colorspace


def pick_tiles(width: int, height: int) -> tuple[int, int]:
    """Output tile (TH, TW) of a frame: the first supported tile height and
    width that divide it (the tile grid of the reference's fused kernel;
    the two-pass front's tile selection depends on it)."""
    for th in (40, 48, 32, 24, 16, 8):
        if height % th == 0:
            break
    else:
        raise ValueError(f"height {height} not divisible by any supported tile height")
    for tw in (256, 192, 128, 64):
        if width % tw == 0:
            break
    else:
        raise ValueError(f"width {width} not divisible by any supported tile width")
    return th, tw


def check_no_tilt(dist) -> None:
    """The remap path rejects tilted-sensor coefficients, as the reference's
    fused kernel does (the camera model itself supports them)."""
    if camera.has_tilt(dist):
        raise NotImplementedError("tilted-sensor (tau) coefficients not supported by the remap path")


def bilinear_remap_u8(src: torch.Tensor, map_xy: torch.Tensor) -> torch.Tensor:
    """cv2.remap(INTER_LINEAR, BORDER_CONSTANT 0) of planar u8 frames.

    src (B, C, H, W) u8, map_xy (Ho, Wo, 2) f32 -> (B, C, Ho, Wo) u8.
    """
    b, c, h, w = src.shape
    ho, wo = map_xy.shape[:2]
    x = map_xy[..., 0].reshape(-1)
    y = map_xy[..., 1].reshape(-1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0
    flat = src.reshape(b, c, h * w)

    def tap(yy: torch.Tensor, xx: torch.Tensor) -> torch.Tensor:
        valid = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
        idx = torch.where(valid, yy * w + xx, torch.zeros_like(yy)).to(torch.int64)
        vals = flat.index_select(2, idx).to(torch.float32)
        return torch.where(valid, vals, torch.zeros((), dtype=torch.float32, device=src.device))

    p00 = tap(y0, x0)
    p01 = tap(y0, x0 + 1.0)
    p10 = tap(y0 + 1.0, x0)
    p11 = tap(y0 + 1.0, x0 + 1.0)
    top = p00 * (1.0 - wx) + p01 * wx
    bot = p10 * (1.0 - wx) + p11 * wx
    out = top * (1.0 - wy) + bot * wy
    return torch.clamp(torch.round(out), 0.0, 255.0).to(torch.uint8).reshape(b, c, ho, wo)


def remap_gray_u8(src: torch.Tensor, map_xy: torch.Tensor, gamma: float = 2.0) -> torch.Tensor:
    """Plain K3: undistort, LAB gamma, BGR2GRAY.  (B, 3, H, W) u8 -> (B, Ho, Wo) u8."""
    und = bilinear_remap_u8(src, map_xy).permute(0, 2, 3, 1)
    return colorspace.bgr_to_gray_u8(colorspace.gamma_correct_u8(und, gamma=gamma))


def preprocess_frames(frames: torch.Tensor, mtx, dist, size_wh: tuple[int, int], gamma: float = 2.0):
    """Undistort + gamma-correct planar frames; returns ((B, H, W, 3), (B, H, W)) u8."""
    mtx_t = torch.as_tensor(mtx, dtype=torch.float32, device=frames.device)
    dist_t = camera.pad_dist_coeffs(dist, device=frames.device)
    map_xy = camera.undistort_rectify_map(mtx_t, dist_t, size_wh)
    out = colorspace.gamma_correct_u8(bilinear_remap_u8(frames, map_xy).permute(0, 2, 3, 1), gamma=gamma)
    return out, colorspace.bgr_to_gray_u8(out)
