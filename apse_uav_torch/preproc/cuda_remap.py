"""Wrappers of kernels K3/K4 (``csrc/remap.cu``): fused remap + LAB gamma + gray.

Replace the JAX reference's ``preproc/pallas_remap.py``: K3 is its full-grid mode
(``_fused_preproc_packed_impl``), with its ``want_rgb`` output as
:func:`remap_rgb_gray`; K4 its selected-tile mode (``_fused_preproc_selected``).
The reference's i32 byte packing, span buckets and window DMA are TPU layout
artefacts and are not ported: the kernel takes u8 frames, planar
``(B, 3, H, W)`` or, in the RGB mode, HWC ``(B, H, W, 3)``, and the port's
float32 map.

On the card the LAB chain runs once per colour, not once per pixel: the
colour table (:func:`colour_table`, 2^24 entries built by the table kernel)
is an explicit device tensor that the caller builds once, with its
``gamma``, and passes to the wrappers; the remap gathers from it.  The RGB
mode takes the packed B|G|R|gray table.

On a CPU tensor each wrapper runs the plain version
(:func:`apse_uav_torch.preproc.remap.remap_gray_u8`,
:func:`apse_uav_torch.preproc.remap.remap_rgb_gray_u8`,
:func:`apse_uav_torch.preproc.remap.lab_gamma_table`) and needs no table; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from apse_uav_torch import _build
from apse_uav_torch.preproc.remap import N_COLOURS, lab_gamma_table, remap_gray_u8, remap_rgb_gray_u8

K3 = "remap_full"
K3_RGB = "remap_full_rgb"
K4 = "remap_selected"
TABLE = "colour_table"
# Output tile of the RGB mode; it masks the overhang, so any frame size works.
RGB_TILE = (8, 128)


def colour_table(gamma: float, device, rgb: bool = False) -> torch.Tensor:
    """The colour table of ``gamma``: (2^24,) u8 gray, or with ``rgb`` the (2^24,)
    int32 table whose bits are the u32 B | G << 8 | R << 16 | gray << 24, of
    every stored-order colour c0 << 16 | c1 << 8 | c2.  One launch of the table
    kernel on a CUDA device; the plain version on the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return lab_gamma_table(gamma, rgb)
    table = torch.empty(N_COLOURS, dtype=torch.int32 if rgb else torch.uint8, device=device)
    fn = _build.load("remap").remap_table_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p]
    gray, bgrg = (None, _build.ptr(table)) if rgb else (_build.ptr(table), None)
    err = fn(gray, bgrg, float(gamma), _build.stream_ptr(device))
    _build.check(err, "table_kernel")
    _build.count(TABLE)
    return table


def _check(src: torch.Tensor, map_xy: torch.Tensor, th: int, tw: int) -> None:
    if src.dtype != torch.uint8 or src.dim() != 4 or src.shape[1] != 3:
        raise ValueError(f"src must be planar (B, 3, H, W) uint8, got {tuple(src.shape)} {src.dtype}")
    _check_map(src, map_xy)
    ho, wo = map_xy.shape[:2]
    if ho % th or wo % tw:
        raise ValueError(f"tile ({th}, {tw}) must divide the output ({ho}, {wo})")


def _check_map(src: torch.Tensor, map_xy: torch.Tensor) -> None:
    if map_xy.dtype != torch.float32 or map_xy.dim() != 3 or map_xy.shape[2] != 2:
        raise ValueError(f"map_xy must be (Ho, Wo, 2) float32, got {tuple(map_xy.shape)} {map_xy.dtype}")
    if map_xy.device != src.device:
        raise ValueError("src and map_xy must be on the same device")


def _check_card(src: torch.Tensor, map_xy: torch.Tensor, table, dtype: torch.dtype) -> None:
    """What the kernel needs on the card: a contiguous map aligned for its 8-byte
    reads and the colour table of ``dtype`` on the frames' device."""
    if not map_xy.is_contiguous() or map_xy.data_ptr() % 8:
        raise ValueError("the kernel needs a contiguous, 8-byte aligned map_xy")
    if table is None:
        raise ValueError(f"the remap on {src.device} needs its colour table: pass colour_table(gamma, device)")
    if table.dtype != dtype or table.shape != (N_COLOURS,) or table.device != src.device:
        raise ValueError(f"table must be the ({N_COLOURS},) {dtype} colour table on {src.device}, got "
                         f"{tuple(table.shape)} {table.dtype} on {table.device} (see colour_table)")


def _launch(src, map_xy, table, out, sel, th, tw, t_sel):
    fn = _build.load("remap").remap_gray_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    b, _, h, w = src.shape
    ho, wo = map_xy.shape[:2]
    err = fn(_build.ptr(src), _build.ptr(map_xy), _build.ptr(table), _build.ptr(out),
             _build.ptr(sel) if sel is not None else None,
             b, h, w, ho, wo, th, tw, t_sel, _build.stream_ptr(src.device))
    _build.check(err, "remap_kernel")


def remap_gray(src: torch.Tensor, map_xy: torch.Tensor, th: int, tw: int, gamma: float = 2.0,
               table: torch.Tensor | None = None) -> torch.Tensor:
    """K3: gray (B, Ho, Wo) u8 of every (th, tw) tile of the map's output.
    On the card ``table`` is :func:`colour_table` of ``gamma``."""
    _check(src, map_xy, th, tw)
    if src.device.type == "cpu":
        return remap_gray_u8(src, map_xy, gamma)
    _check_card(src, map_xy, table, torch.uint8)
    if not src.is_contiguous():
        raise ValueError("remap_gray needs a contiguous src")
    out = torch.empty((src.shape[0], *map_xy.shape[:2]), dtype=torch.uint8, device=src.device)
    _launch(src, map_xy, table, out, None, th, tw, 0)
    _build.count(K3)
    return out


def remap_gray_selected(src: torch.Tensor, map_xy: torch.Tensor, sel: torch.Tensor, th: int, tw: int,
                        gamma: float = 2.0, table: torch.Tensor | None = None) -> torch.Tensor:
    """K4: gray of the tiles named in ``sel`` (B, T_sel) i32 (tile id =
    ty * (Wo // tw) + tx; -1 = padding).  Unselected tiles are left
    unwritten on the card (``torch.empty``) and zero on the CPU; callers
    must invalidate whatever would read them (patch_select's ``covered``).
    On the card ``table`` is :func:`colour_table` of ``gamma``."""
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
    _check_card(src, map_xy, table, torch.uint8)
    if sel.device != src.device or not (src.is_contiguous() and sel.is_contiguous()):
        raise ValueError("remap_gray_selected needs contiguous src and sel on one device")
    out = torch.empty((src.shape[0], ho, wo), dtype=torch.uint8, device=src.device)
    if sel.shape[1] > 0:
        _launch(src, map_xy, table, out, sel, th, tw, sel.shape[1])
        _build.count(K4)
    return out


def remap_rgb_gray(src: torch.Tensor, map_xy: torch.Tensor, gamma: float = 2.0, hwc: bool = False,
                   with_gray: bool = True, table: torch.Tensor | None = None):
    """K3's RGB mode: the undistorted, gamma-corrected image and its gray.

    src (B, 3, H, W) u8, or (B, H, W, 3) with ``hwc``, in any strides ->
    (rgb in src's layout, (B, Ho, Wo) u8 gray or None).  On the card
    ``table`` is the packed :func:`colour_table` of ``gamma`` (``rgb=True``).
    """
    if src.dtype != torch.uint8 or src.dim() != 4 or src.shape[3 if hwc else 1] != 3:
        layout = "(B, H, W, 3)" if hwc else "(B, 3, H, W)"
        raise ValueError(f"src must be {layout} uint8, got {tuple(src.shape)} {src.dtype}")
    _check_map(src, map_xy)
    if src.device.type == "cpu":
        rgb, gray = remap_rgb_gray_u8(src, map_xy, gamma, hwc=hwc)
        return rgb, gray if with_gray else None
    _check_card(src, map_xy, table, torch.int32)
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
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_longlong] * 4 + [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 4
                   + [ctypes.c_void_p] + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    err = fn(_build.ptr(src), sb, sc, sr, sx, _build.ptr(map_xy), _build.ptr(table), _build.ptr(rgb), rb, rc, rr, rx,
             _build.ptr(gray) if gray is not None else None, b, h, w, ho, wo, *RGB_TILE, _build.stream_ptr(src.device))
    _build.check(err, "remap_kernel (RGB mode)")
    _build.count(K3_RGB)
    return rgb, gray
