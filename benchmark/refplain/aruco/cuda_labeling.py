"""K1's plain version on every device: component labels of candidate windows."""

from __future__ import annotations

from refplain.aruco.detector import _label_sweeps


def labels(dark, rounds: int = 3, mop: int = 8):
    """dark (K, win, win) bool -> (K, win, win) int32 labels."""
    return _label_sweeps(dark, rounds, mop)
