"""K5's plain version on every device: 4x4 mean pool of the planar u8 source."""

from __future__ import annotations

from refplain.preproc.twopass import pool_source_u8


def pool_source(frames, st: int, out_hw: tuple[int, int]):
    """Mean-pool planar u8 frames (B, C, H, W) by st, zero-padded to out_hw."""
    return pool_source_u8(frames, st, out_hw)
