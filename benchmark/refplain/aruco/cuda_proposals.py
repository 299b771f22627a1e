"""K2's plain version on every device: multi-scale proposal scoring."""

from __future__ import annotations

from refplain.aruco.detector import _proposals_from_pool


def proposals_from_pool(pool, h: int, w: int, p):
    """pool (B, >=h//st, >=w//st) f32 -> centers, sizes, scores, valid."""
    return _proposals_from_pool(pool, h, w, p)
