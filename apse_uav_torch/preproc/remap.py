"""Undistort (bilinear remap) + LAB gamma + gray.

Counterpart of the JAX reference's ``preproc/remap.py`` (:class:`Preprocessor`)
and the plain version of kernels K3/K4 (``csrc/remap.cu``, wrapped by
:mod:`.cuda_remap`).  Frames are u8 in the reference's stored (BGR) order,
planar ``(B, 3, H, W)`` on the ArUco path and HWC ``(B, H, W, 3)`` at
:class:`Preprocessor`; the map is the float32 ``(Ho, Wo, 2)`` source position
of every output pixel (:func:`apse_uav_torch.core.camera.undistort_rectify_map`).

Border semantics match cv2.remap's BORDER_CONSTANT(0): taps outside the
source contribute 0.  The blend is written one op per rounding, in the same
order as the kernel, so the kernel's output can be held to it bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from apse_uav_torch.core import camera, colorspace
from apse_uav_torch.device import resolve_device


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


def remap_rgb_gray_u8(src: torch.Tensor, map_xy: torch.Tensor, gamma: float = 2.0, hwc: bool = False):
    """Plain K3 RGB mode: undistort + LAB gamma -> (rgb in src's layout, gray).

    src (B, 3, H, W) u8, or (B, H, W, 3) with ``hwc``; gray (B, Ho, Wo) u8."""
    planar = src.permute(0, 3, 1, 2) if hwc else src
    rgb = colorspace.gamma_correct_u8(bilinear_remap_u8(planar, map_xy).permute(0, 2, 3, 1), gamma=gamma)
    gray = colorspace.bgr_to_gray_u8(rgb)
    return (rgb if hwc else rgb.permute(0, 3, 1, 2).contiguous()), gray


class Preprocessor:
    """Undistort + LAB gamma (+ gray) of HWC frames, binding the camera.

    Counterpart of the reference's ``Preprocessor`` (the preprocessing that
    ``track_uav --preprocess`` feeds to the DCNN tracker).  The map is built
    once, on ``device``.  On the card each call is one launch of kernel K3's
    RGB mode on the HWC frames as they are; on the CPU the plain chain runs.

    Example:
        pre = Preprocessor.from_json("data/cam_params.json", (3840, 2160))
        frames_out, gray = pre(frames_u8)   # (B, H, W, 3), (B, H, W)
    """

    def __init__(self, mtx, dist, size_wh: tuple[int, int], gamma: float = 2.0, device="cuda"):
        self.device = resolve_device(device)
        dist = np.asarray(dist, np.float64).reshape(-1)
        if self.device.type == "cuda":
            check_no_tilt(dist)  # the kernel path draws the reference kernel's line
        self.size_wh = tuple(size_wh)
        self.gamma = float(gamma)
        mtx_t = torch.as_tensor(np.asarray(mtx, np.float64), dtype=torch.float32, device=self.device)
        self.map_xy = camera.undistort_rectify_map(mtx_t, camera.pad_dist_coeffs(dist, device=self.device),
                                                   self.size_wh, tilt=camera.has_tilt(dist))

    @classmethod
    def from_json(cls, path: str, size_wh: tuple[int, int], gamma: float = 2.0, device="cuda"):
        mtx, dist = camera.load_camera_params(path)
        return cls(mtx, dist, size_wh, gamma, device)

    def __call__(self, frames: torch.Tensor, with_gray: bool = True):
        """frames (B, H, W, 3) or (H, W, 3) u8 -> (out of the same shape, gray (B, H, W) / (H, W) u8 or None)."""
        from apse_uav_torch.preproc import cuda_remap

        if frames.dim() == 3:
            out, gray = self(frames[None], with_gray)
            return out[0], (None if gray is None else gray[0])
        if frames.device != self.device:
            raise ValueError(f"frames are on {frames.device}, the preprocessor on {self.device}")
        return cuda_remap.remap_rgb_gray(frames, self.map_xy, self.gamma, hwc=True, with_gray=with_gray)


def preprocess_frames(frames: torch.Tensor, mtx, dist, size_wh: tuple[int, int], gamma: float = 2.0):
    """Undistort + gamma-correct planar frames (B, 3, H, W) through
    :class:`Preprocessor`; returns ((B, H, W, 3), (B, H, W)) u8."""
    return Preprocessor(mtx, dist, size_wh, gamma, device=frames.device)(frames.permute(0, 2, 3, 1))
