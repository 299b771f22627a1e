"""K3's and K4's plain versions on every device: remap + LAB gamma + gray.

The plain chain needs no colour table: :func:`colour_table` returns None and
the ``table`` arguments are ignored."""

from __future__ import annotations

import torch

from refplain.preproc.remap import remap_gray_u8, remap_rgb_gray_u8


def colour_table(gamma: float, device, rgb: bool = False):
    return None


def remap_gray(src, map_xy, th: int, tw: int, gamma: float = 2.0, table=None):
    """K3: gray (B, Ho, Wo) u8 over the whole map."""
    return remap_gray_u8(src, map_xy, gamma)


def remap_gray_selected(src, map_xy, sel, th: int, tw: int, gamma: float = 2.0, table=None):
    """K4: gray of the (th, tw) tiles named in ``sel`` (B, T_sel) i32 (-1 =
    padding); the other tiles are 0."""
    ho, wo = map_xy.shape[:2]
    full = remap_gray_u8(src, map_xy, gamma)
    keep = torch.zeros((src.shape[0], (ho // th) * (wo // tw) + 1), dtype=torch.bool, device=src.device)
    keep.scatter_(1, torch.where(sel >= 0, sel, keep.shape[1] - 1).long(), True)
    keep = keep[:, :-1].reshape(-1, ho // th, 1, wo // tw, 1)
    keep = keep.expand(-1, -1, th, -1, tw).reshape(-1, ho, wo)
    return torch.where(keep, full, torch.zeros((), dtype=torch.uint8, device=src.device))


def remap_rgb_gray(src, map_xy, gamma: float = 2.0, hwc: bool = False, with_gray: bool = True, table=None):
    """K3's RGB mode: (rgb in src's layout, gray or None)."""
    rgb, gray = remap_rgb_gray_u8(src, map_xy, gamma, hwc=hwc)
    return rgb, gray if with_gray else None
