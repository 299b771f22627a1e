"""Wrappers of kernels K3/K4 (``csrc/remap.cu``): fused remap + LAB gamma + gray.

Replace the JAX reference's ``preproc/pallas_remap.py``: K3 is its full-grid mode
(``_fused_preproc_packed_impl``), with its ``want_rgb`` output as
:func:`remap_rgb_gray`; K4 its selected-tile mode (``_fused_preproc_selected``).
The reference's i32 byte packing, span buckets and window DMA are TPU layout
artefacts and are not ported: the kernel takes u8 frames, planar
``(B, 3, H, W)`` or, in the RGB mode, HWC ``(B, H, W, 3)``, and the port's
float32 map.

On a CPU tensor each wrapper runs the plain version
(:func:`apse_uav_torch.preproc.remap.remap_gray_u8`,
:func:`apse_uav_torch.preproc.remap.remap_rgb_gray_u8`); on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from apse_uav_torch import _build
from apse_uav_torch.preproc.remap import remap_gray_u8, remap_rgb_gray_u8

K3 = "remap_full"
K3_RGB = "remap_full_rgb"
K4 = "remap_selected"
# Output tile of the RGB mode; it masks the overhang, so any frame size works.
RGB_TILE = (8, 128)


def _check(src: torch.Tensor, map_xy: torch.Tensor, th: int, tw: int) -> None:
    if src.dtype != torch.uint8 or src.dim() != 4 or src.shape[1] != 3:
        raise ValueError(f"src must be planar (B, 3, H, W) uint8, got {tuple(src.shape)} {src.dtype}")
    if map_xy.dtype != torch.float32 or map_xy.dim() != 3 or map_xy.shape[2] != 2:
        raise ValueError(f"map_xy must be (Ho, Wo, 2) float32, got {tuple(map_xy.shape)} {map_xy.dtype}")
    if map_xy.device != src.device:
        raise ValueError("src and map_xy must be on the same device")
    ho, wo = map_xy.shape[:2]
    if ho % th or wo % tw:
        raise ValueError(f"tile ({th}, {tw}) must divide the output ({ho}, {wo})")


def _launch(src, map_xy, out, sel, th, tw, t_sel, gamma):
    lib = _build.load("remap")
    fn = lib.remap_gray_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
    b, _, h, w = src.shape
    ho, wo = map_xy.shape[:2]
    err = fn(_build.ptr(src), _build.ptr(map_xy), _build.ptr(out),
             _build.ptr(sel) if sel is not None else None,
             b, h, w, ho, wo, th, tw, t_sel, float(gamma), _build.stream_ptr(src.device))
    _build.check(err, "remap_gray_kernel")


def remap_gray(src: torch.Tensor, map_xy: torch.Tensor, th: int, tw: int, gamma: float = 2.0) -> torch.Tensor:
    """K3: gray (B, Ho, Wo) u8 of every (th, tw) tile of the map's output."""
    _check(src, map_xy, th, tw)
    if src.device.type == "cpu":
        return remap_gray_u8(src, map_xy, gamma)
    if not (src.is_contiguous() and map_xy.is_contiguous()):
        raise ValueError("remap_gray needs contiguous src and map_xy")
    out = torch.empty((src.shape[0], *map_xy.shape[:2]), dtype=torch.uint8, device=src.device)
    _launch(src, map_xy, out, None, th, tw, 0, gamma)
    _build.count(K3)
    return out


def remap_gray_selected(src: torch.Tensor, map_xy: torch.Tensor, sel: torch.Tensor, th: int, tw: int,
                        gamma: float = 2.0) -> torch.Tensor:
    """K4: gray of the tiles named in ``sel`` (B, T_sel) i32 (tile id =
    ty * (Wo // tw) + tx; -1 = padding).  Unselected tiles are left
    unwritten on the card (``torch.empty``) and zero on the CPU; callers
    must invalidate whatever would read them (patch_select's ``covered``)."""
    _check(src, map_xy, th, tw)
    if sel.dtype != torch.int32 or sel.dim() != 2 or sel.shape[0] != src.shape[0]:
        raise ValueError(f"sel must be (B, T_sel) int32, got {tuple(sel.shape)} {sel.dtype}")
    ho, wo = map_xy.shape[:2]
    if src.device.type == "cpu":
        full = remap_gray_u8(src, map_xy, gamma)
        keep = torch.zeros((src.shape[0], (ho // th) * (wo // tw) + 1), dtype=torch.bool)
        keep.scatter_(1, torch.where(sel >= 0, sel, keep.shape[1] - 1).long(), True)
        keep = keep[:, :-1].reshape(-1, ho // th, 1, wo // tw, 1)
        keep = keep.expand(-1, -1, th, -1, tw).reshape(-1, ho, wo)
        return torch.where(keep, full, torch.zeros((), dtype=torch.uint8))
    if sel.device != src.device or not (src.is_contiguous() and map_xy.is_contiguous() and sel.is_contiguous()):
        raise ValueError("remap_gray_selected needs contiguous src, map_xy and sel on one device")
    out = torch.empty((src.shape[0], ho, wo), dtype=torch.uint8, device=src.device)
    if sel.shape[1] > 0:
        _launch(src, map_xy, out, sel, th, tw, sel.shape[1], gamma)
        _build.count(K4)
    return out


def remap_rgb_gray(src: torch.Tensor, map_xy: torch.Tensor, gamma: float = 2.0, hwc: bool = False,
                   with_gray: bool = True):
    """K3's RGB mode: the undistorted, gamma-corrected image and its gray.

    src (B, 3, H, W) u8, or (B, H, W, 3) with ``hwc``, in any strides ->
    (rgb in src's layout, (B, Ho, Wo) u8 gray or None).
    """
    if src.dtype != torch.uint8 or src.dim() != 4 or src.shape[3 if hwc else 1] != 3:
        layout = "(B, H, W, 3)" if hwc else "(B, 3, H, W)"
        raise ValueError(f"src must be {layout} uint8, got {tuple(src.shape)} {src.dtype}")
    if map_xy.dtype != torch.float32 or map_xy.dim() != 3 or map_xy.shape[2] != 2:
        raise ValueError(f"map_xy must be (Ho, Wo, 2) float32, got {tuple(map_xy.shape)} {map_xy.dtype}")
    if map_xy.device != src.device:
        raise ValueError("src and map_xy must be on the same device")
    if src.device.type == "cpu":
        rgb, gray = remap_rgb_gray_u8(src, map_xy, gamma, hwc=hwc)
        return rgb, gray if with_gray else None
    if not map_xy.is_contiguous():
        raise ValueError("remap_rgb_gray needs a contiguous map_xy")
    b = src.shape[0]
    ho, wo = map_xy.shape[:2]
    if hwc:
        h, w = src.shape[1:3]
        rgb = torch.empty((b, ho, wo, 3), dtype=torch.uint8, device=src.device)
        sb, sr, sx, sc = src.stride()
        rb, rr, rx, rc = rgb.stride()
    else:
        h, w = src.shape[2:]
        rgb = torch.empty((b, 3, ho, wo), dtype=torch.uint8, device=src.device)
        sb, sc, sr, sx = src.stride()
        rb, rc, rr, rx = rgb.stride()
    gray = torch.empty((b, ho, wo), dtype=torch.uint8, device=src.device) if with_gray else None
    if rgb.numel() == 0:
        return rgb, gray
    fn = _build.load("remap").remap_rgb_gray_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_longlong] * 4 + [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 4
                   + [ctypes.c_void_p] + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
    err = fn(_build.ptr(src), sb, sc, sr, sx, _build.ptr(map_xy), _build.ptr(rgb), rb, rc, rr, rx,
             _build.ptr(gray) if gray is not None else None, b, h, w, ho, wo, *RGB_TILE, float(gamma),
             _build.stream_ptr(src.device))
    _build.check(err, "remap_kernel (RGB mode)")
    _build.count(K3_RGB)
    return rgb, gray
