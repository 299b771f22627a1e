"""Threshold-gated assignment for the tracker: an auction with a null option.

Counterpart of ``gated_auction_match`` and ``pad_cost`` in the JAX reference's
``dcnn/hungarian.py`` (the exact Jonker-Volgenant solver and
``auction_assignment`` wait; ``ROADMAP.md``).  Each sweep is dense (R, C)
tensor work.  A sweep with no bidding row changes nothing, so the sweeps run
through :func:`~apse_uav_torch.dcnn.ops.loops.run_until`, testing for
bidders only every ``CHECK_EVERY`` sweeps, with the reference's result and
sweep budget.
"""

from __future__ import annotations

import torch

from apse_uav_torch.dcnn.ops.loops import run_until

# Pad value of pad_cost (the reference's _BIG): dominates any real cost, keeps f32 resolution.
_BIG = 1e4
# Auction sweeps between two tests for remaining bidders (host syncs on the card).
CHECK_EVERY = 4
_BIDDING, _NULL = -2, -1


def set_at(field: torch.Tensor, idx: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``field.at[idx].set(values, mode="drop")`` for idx in [0, len(field)]:
    index len(field) lands in a spare row that is dropped.  ``values`` is a
    tensor on field's device (a Python scalar would be copied to the card,
    a host sync)."""
    ext = torch.cat([field, field[:1]])
    ext[idx] = values
    return ext[:-1]


def gated_auction_match(cost: torch.Tensor, row_valid: torch.Tensor, col_valid: torch.Tensor, threshold: float,
                        max_sweeps: int = 128) -> torch.Tensor:
    """Min-cost matching of rows (tracks) to columns (detections), each at most
    once, where a pair may match only if its cost is below ``threshold``
    (every row may take the null option instead).  Returns col_of_row (R,)
    int64, -1 = unmatched.  Jacobi auction: every bidding row bids its full
    surplus over its second-best-or-null on its best column; a column goes to
    its highest bid (ties: lower row); eps = spread / 1024 breaks exact ties.
    Rows still bidding when the budget runs out exit to null."""
    cost = cost.to(torch.float32)
    n_rows, n_cols = cost.shape
    dev = cost.device
    neg_inf = torch.full((), -1e30, dtype=torch.float32, device=dev)
    benefit = torch.where(row_valid[:, None] & col_valid[None, :], -cost, neg_inf)
    reserve = torch.full((), -threshold, dtype=torch.float32, device=dev)
    spread = torch.clamp(torch.where(benefit > neg_inf / 2, benefit, reserve).max() - reserve, min=1e-6)
    eps = spread / 1024.0
    rows = torch.arange(n_rows, device=dev)
    cols = torch.arange(n_cols, device=dev)

    def sweep(state):
        col_of_row, owner, prices = state
        bidding = col_of_row == _BIDDING
        values = benefit - prices[None, :]
        v1, j_star = values.max(dim=1)
        masked = values.clone()
        masked[rows, j_star] = neg_inf
        v2 = torch.maximum(masked.max(dim=1).values, reserve)
        exits = bidding & (v1 <= reserve)
        col_of_row = torch.where(exits, torch.full_like(col_of_row, _NULL), col_of_row)
        bidders = bidding & ~exits
        bid = v1 - v2 + eps
        bids = torch.where(bidders[:, None] & (cols[None, :] == j_star[:, None]), bid[:, None], neg_inf)
        best_bid, best_row = bids.max(dim=0)
        got = best_bid > neg_inf / 2
        prices = torch.where(got, prices + best_bid, prices)
        # Previous owners of rebid columns go back to bidding.
        prev_owner = torch.where(got, owner, torch.full_like(owner, -1))
        displaced = set_at(torch.zeros(n_rows, dtype=torch.bool, device=dev),
                            torch.where(prev_owner >= 0, prev_owner, n_rows), prev_owner >= 0)
        col_of_row = torch.where(displaced, torch.full_like(col_of_row, _BIDDING), col_of_row)
        owner = torch.where(got, best_row, owner)
        col_of_row = set_at(col_of_row, torch.where(got, best_row, n_rows), cols)
        return col_of_row, owner, prices

    col0 = torch.where(row_valid, torch.full((n_rows,), _BIDDING, device=dev), torch.full((n_rows,), _NULL, device=dev))
    state = (col0, torch.full((n_cols,), -1, dtype=torch.int64, device=dev),
             torch.zeros(n_cols, dtype=torch.float32, device=dev))
    col_of_row, _, _ = run_until(sweep, state, lambda s: ~(s[0] == _BIDDING).any(), max_sweeps, CHECK_EVERY)
    return torch.where(col_of_row == _BIDDING, torch.full_like(col_of_row, _NULL), col_of_row)


def pad_cost(cost: torch.Tensor, row_valid: torch.Tensor, col_valid: torch.Tensor, pad_value: float = _BIG):
    """Invalid rows/columns and non-finite entries of a cost matrix set to a
    large finite constant, so real pairs are always preferred."""
    c = torch.where(row_valid[:, None] & col_valid[None, :], cost, torch.full_like(cost, pad_value))
    return torch.where(torch.isfinite(c), c, torch.full_like(c, pad_value))
