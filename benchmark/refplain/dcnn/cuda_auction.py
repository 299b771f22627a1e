"""The gated auction's plain version on every device: the tracker's association solver."""

from __future__ import annotations

from refplain.dcnn.hungarian import gated_auction_sweeps


def gated_auction_match(cost, row_valid, col_valid, threshold: float, max_sweeps: int = 128):
    """col_of_row (R,) int64, -1 = unmatched."""
    return gated_auction_sweeps(cost, row_valid, col_valid, threshold, max_sweeps)[0]
