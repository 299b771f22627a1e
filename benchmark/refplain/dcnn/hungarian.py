"""The tracker's assignment solver: the threshold-gated auction.

Counterpart of the JAX reference's ``dcnn/hungarian.py``
``gated_auction_match`` (on the card the tracker runs it as one kernel
launch, ``dcnn/cuda_auction.py``, and this is its plain version).  The
reference runs it as a ``lax.while_loop`` on the device.  Here each loop step is dense tensor work
that maps a finished state to itself (a step past the end is masked out), so
the loops run through :func:`~refplain.dcnn.ops.loops.run_until`,
testing for the end only every ``CHECK_EVERY`` steps, with the reference's
results and budgets.  Ties go to the lower index, as ``jnp.argmax`` /
``jnp.argmin`` break them.
"""

from __future__ import annotations

import torch

from refplain.dcnn.ops.loops import run_until

# Auction sweeps between two tests for remaining bidders (host syncs on the card).
CHECK_EVERY = 4
_BIDDING, _NULL = -2, -1


def set_at(field: torch.Tensor, idx: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``field.at[idx].set(values, mode="drop")`` for idx in [0, len(field)]:
    index len(field) lands in a spare row that is dropped.  ``values`` is a
    tensor on field's device (a Python scalar would be copied to the card,
    a host sync)."""
    ext = torch.cat([field, field[:1]])
    ext[idx] = values.to(field.dtype)
    return ext[:-1]


def gated_auction_sweeps(cost: torch.Tensor, row_valid: torch.Tensor, col_valid: torch.Tensor, threshold: float,
                         max_sweeps: int = 128) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`gated_auction_match`, the number of sweeps it ran, (1,) int32
    (the reference loop's iterations, at most ``max_sweeps``), and the rows
    bidding at the start of each of those sweeps, summed, (1,) int32 (the
    rows a sweep scans).  The plain version of the ``csrc/auction.cu`` kernel
    (``dcnn/cuda_auction.py``)."""
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
        col_of_row, owner, prices, sweeps, scanned = state
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
        # A sweep past the end (no row bidding) changes nothing and is not counted.
        return (col_of_row, owner, prices, sweeps + bidding.any().to(torch.int32),
                scanned + bidding.sum().to(torch.int32))

    col0 = torch.where(row_valid, torch.full((n_rows,), _BIDDING, device=dev), torch.full((n_rows,), _NULL, device=dev))
    state = (col0, torch.full((n_cols,), -1, dtype=torch.int64, device=dev),
             torch.zeros(n_cols, dtype=torch.float32, device=dev), torch.zeros(1, dtype=torch.int32, device=dev),
             torch.zeros(1, dtype=torch.int32, device=dev))
    col_of_row, _, _, sweeps, scanned = run_until(sweep, state, lambda s: ~(s[0] == _BIDDING).any(), max_sweeps,
                                                  CHECK_EVERY)
    return torch.where(col_of_row == _BIDDING, torch.full_like(col_of_row, _NULL), col_of_row), sweeps, scanned
