"""Assignment solvers for the tracker: the threshold-gated auction, the exact
Jonker-Volgenant solve and the eps-scaled auction.

Counterpart of the JAX reference's ``dcnn/hungarian.py``:
``gated_auction_match`` (the tracker's default), ``linear_sum_assignment``
(exact, scipy's interface; the tracker's ``exact=True``),
``auction_assignment`` and ``pad_cost``.  The reference runs each as
``lax.while_loop``s on the device.  Here each loop step is dense tensor work
that maps a finished state to itself (a step past the end is masked out), so
the loops run through :func:`~apse_uav_torch.dcnn.ops.loops.run_until`,
testing for the end only every ``CHECK_EVERY`` steps, with the reference's
results and budgets.  Ties go to the lower index, as ``jnp.argmax`` /
``jnp.argmin`` break them.
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
    ext[idx] = values.to(field.dtype)
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


def _guard(go: torch.Tensor, new: tuple, old: tuple) -> tuple:
    """``new`` where the 0-d bool ``go`` holds, else ``old`` (a masked loop step)."""
    return tuple(torch.where(go, a, b) for a, b in zip(new, old))


def linear_sum_assignment(cost: torch.Tensor, maximize: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Optimal assignment of a square (N, N) cost matrix (Jonker-Volgenant:
    shortest augmenting paths with dual potentials), the reference's float32
    operations in its order.  Returns (row_ind, col_ind) as scipy does:
    row_ind = arange(N), col_ind[i] the column of row i (int64).  Pad a
    rectangular problem to square first (:func:`pad_cost`)."""
    cost = cost.to(torch.float32)
    if maximize:
        cost = -cost
    n = cost.shape[0]
    dev = cost.device
    inf = torch.full((), float("inf"), device=dev)
    zero = torch.zeros((), device=dev)
    cols = torch.arange(n + 1, device=dev)
    virtual = cols == n  # index n is the virtual source column
    u = torch.zeros(n, device=dev)
    v = torch.zeros(n + 1, device=dev)
    p = torch.full((n + 1,), -1, dtype=torch.int64, device=dev)  # p[j]: row owning column j

    def dijkstra(s):
        """One scan step; a no-op once the last column reached is free."""
        u, v, p, minv, way, used, j0 = s
        go = p[j0] != -1
        used = used | (cols == j0)
        i0 = p[j0].clamp(min=0)
        cur = cost[i0] - u[i0] - v[:n]
        better = ~used[:n] & (cur < minv[:n])
        minv_n = torch.where(better, cur, minv[:n])
        way = torch.cat([torch.where(better, j0, way[:n]), way[n:]])
        masked = torch.where(used[:n], inf, minv_n)
        j1 = torch.argmin(masked)
        delta = masked[j1]
        u = u.index_add(0, torch.where(used, p, 0).clamp(min=0), torch.where(used, delta, zero))
        v = v - torch.where(used, delta, zero)
        minv = torch.cat([minv_n, minv[n:]])
        minv = torch.where(used, minv, minv - delta)
        return _guard(go, (u, v, p, minv, way, used, j1), s)

    def augment(s):
        """One step back along the alternating path; a no-op at the virtual column."""
        p, j0, way = s
        go = j0 != n
        j1 = way[j0]
        p = torch.where(cols == j0, p[j1], p)
        return _guard(go, (p, j1), (s[0], s[1])) + (way,)

    for i in range(n):
        p = torch.where(virtual, torch.full_like(p, i), p)
        state = (u, v, p, inf.expand(n + 1).clone(),
                 torch.full((n + 1,), n, dtype=torch.int64, device=dev), torch.zeros(n + 1, dtype=torch.bool,
                                                                                      device=dev),
                 torch.full((), n, dtype=torch.int64, device=dev))
        u, v, p, _, way, _, j0 = run_until(dijkstra, state, lambda s: s[2][s[6]] == -1, n + 1, CHECK_EVERY)
        p, _, _ = run_until(augment, (p, j0, way), lambda s: s[1] == n, n + 1, CHECK_EVERY)
    col_of_row = torch.empty(n, dtype=torch.int64, device=dev)
    col_of_row[p[:n]] = torch.arange(n, device=dev)
    return torch.arange(n, device=dev), col_of_row


def auction_assignment(cost: torch.Tensor, maximize: bool = False,
                       max_sweeps: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """Near-optimal assignment of a square (N, N) cost matrix: Bertsekas'
    auction with eps-scaling (eps = spread x 1/4, 1/32, 1/256, 1/4096, prices
    kept between phases, assignments reset), Jacobi bidding sweeps and one
    sweep budget shared by the phases.  The total cost is within N x the last
    eps of the optimum.  Rows left unassigned when the budget runs out take
    the free columns in rank order.  Same interface as
    :func:`linear_sum_assignment`."""
    cost = cost.to(torch.float32)
    n = cost.shape[0]
    dev = cost.device
    benefit = cost if maximize else -cost
    neg_inf = torch.full((), -1e30, device=dev)
    spread = torch.clamp(benefit.max() - benefit.min(), min=1e-6)
    rows = torch.arange(n, device=dev)
    cols = torch.arange(n, device=dev)

    def sweep(s):
        """One bidding sweep; a no-op once every row is assigned or the budget is spent."""
        col_of_row, prices, eps, budget = s
        unassigned = col_of_row < 0
        go = unassigned.any() & (budget > 0)
        values = benefit - prices[None, :]
        v1, j_star = values.max(dim=1)
        masked = values.clone()
        masked[rows, j_star] = neg_inf
        v2 = masked.max(dim=1).values
        bid = v1 - v2 + eps
        bids = torch.where(unassigned[:, None] & (cols[None, :] == j_star[:, None]), bid[:, None], neg_inf)
        best_bid, best_row = bids.max(dim=0)
        got = best_bid > neg_inf / 2
        new_prices = torch.where(got, prices + best_bid, prices)
        displaced = got[col_of_row.clamp(min=0)] & (col_of_row >= 0)
        new_col = torch.where(displaced, torch.full_like(col_of_row, -1), col_of_row)
        new_col = set_at(new_col, torch.where(got, best_row, n), cols)
        return _guard(go, (new_col, new_prices, eps, budget - 1), s)

    state = (torch.full((n,), -1, dtype=torch.int64, device=dev), torch.zeros(n, device=dev), spread,
             torch.full((), max_sweeps, dtype=torch.int64, device=dev))
    for frac in (1.0 / 4.0, 1.0 / 32.0, 1.0 / 256.0, 1.0 / 4096.0):
        _, prices, _, budget = state
        state = (torch.full((n,), -1, dtype=torch.int64, device=dev), prices, spread * frac, budget)
        state = run_until(sweep, state, lambda s: ~(s[0] < 0).any() | (s[3] <= 0), max_sweeps, CHECK_EVERY)
    col_of_row = state[0]
    unassigned = col_of_row < 0
    taken = set_at(torch.zeros(n, dtype=torch.bool, device=dev), torch.where(unassigned, n, col_of_row),
                   ~unassigned)
    # The reference scatters ~unassigned at col_of_row, unassigned rows at
    # column 0, and the last write wins: column 0 reads the last such row.
    at0 = unassigned | (col_of_row == 0)
    last0 = torch.where(at0, rows, -1).max()
    taken[0] = at0.any() & ~unassigned[last0.clamp(min=0)]
    row_rank = torch.cumsum(unassigned.to(torch.int64), 0) - 1
    free_sorted = torch.sort(torch.where(~taken, cols, n)).values
    col_of_row = torch.where(unassigned, free_sorted[row_rank.clamp(0, n - 1)], col_of_row)
    return rows, col_of_row
