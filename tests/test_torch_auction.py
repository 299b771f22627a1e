"""PyTorch port, the gated auction's wrapper (``dcnn/cuda_auction.py``) and
its plain version (``dcnn/hungarian.py``) on the CPU against the JAX
package's ``gated_auction_match``.

On a CPU tensor the wrapper runs the plain version, which is the oracle of
the ``csrc/auction.cu`` kernels (``tests/test_torch_cuda.py`` holds them to
it on the card); which kernel a shape takes is decided on the CPU, and
tested here.  Problems are made with numpy from fixed seeds and handed to
both packages; assignments must be identical, budget exits included.  The
sweep count is pinned through JAX: it is the number of iterations of the
reference's ``lax.while_loop``, counted in the loop's carry.
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apse_uav_tpu.dcnn import hungarian as jhung
from apse_uav_torch.dcnn import cuda_auction, hungarian as thung
from apse_uav_torch.utils.synthetic import AUCTION_KINDS, auction_problem

import torch_parity

KINDS = AUCTION_KINDS + ("wide",)
# Random problems at the warp kernel's edges (rows x columns).
EDGES = ("32x32", "32x1", "1x32", "31x32")


def problem(kind: str, rng):
    """A seeded 12 x 10 problem of ``kind`` (``utils.synthetic.auction_problem``);
    ``wide`` is a random 7 x 20 one, more columns than rows; an EDGES name a
    random one of that shape."""
    if kind in EDGES:
        return auction_problem("random", rng, *map(int, kind.split("x")))
    return auction_problem("random", rng, 7, 20) if kind == "wide" else auction_problem(kind, rng, 12, 10)


def wrapper_problems(kind: str) -> list:
    """The three problems test_wrapper_matches_jax draws for ``kind``."""
    rng = np.random.default_rng(KINDS.index(kind))
    return [problem(kind, rng) for _ in range(3)]


def cost_case_problems(kind: str) -> list:
    """Four problems of ``torch_parity.cost_case`` (its ``ties`` are float64;
    both packages' wrappers take them as float32)."""
    rng = np.random.default_rng(5)
    return [torch_parity.cost_case(kind, rng) for _ in range(4)]


def jax_match(cost, rv, cv, thr, max_sweeps=128):
    return np.asarray(jhung.gated_auction_match(jnp.asarray(cost), jnp.asarray(rv), jnp.asarray(cv), thr,
                                                max_sweeps=max_sweeps))


@functools.cache
def counting_solver(max_sweeps: int):
    """JAX's ``gated_auction_match`` at ``max_sweeps``, jitted once, with the
    threshold an argument, and the iterations of its ``lax.while_loop``:
    traced with a loop that carries an iteration counter beside the
    reference's own state, and returns it."""
    loop = jax.lax.while_loop

    def run(c, r, v, thr):
        counts = []

        def counting(cond, body, init):
            state, n = loop(lambda s: cond(s[0]), lambda s: (body(s[0]), s[1] + 1), (init, jnp.int32(0)))
            counts.append(n)
            return state

        with mock.patch.object(jax.lax, "while_loop", counting):
            return jhung.gated_auction_match.__wrapped__(c, r, v, thr, max_sweeps), counts[0]

    return jax.jit(run)


def jax_loop(cost, rv, cv, thr, max_sweeps=128) -> tuple[np.ndarray, int]:
    col_of_row, n = counting_solver(max_sweeps)(jnp.asarray(cost), jnp.asarray(rv), jnp.asarray(cv), thr)
    return np.asarray(col_of_row), int(n)


def wrapper(cost, rv, cv, thr, max_sweeps=128):
    col, sweeps = cuda_auction.solve(torch.from_numpy(cost), torch.from_numpy(rv), torch.from_numpy(cv), thr,
                                     max_sweeps)
    assert col.dtype == torch.int64 and sweeps.dtype == torch.int32 and tuple(sweeps.shape) == (1,)
    return col.numpy(), int(sweeps[0])


GENERATED = [pytest.param(wrapper_problems, kind, id=kind) for kind in KINDS] + [
    pytest.param(cost_case_problems, kind, id=f"cost_case-{kind}") for kind in torch_parity.COST_CASES]


@pytest.mark.parametrize("problems, kind", GENERATED)
def test_wrapper_matches_jax(problems, kind):
    """Identical assignments at the tracker's threshold and at 2.0, from
    both problem generators: the wrapper's, its ``gated_auction_match``'s
    and the plain ``gated_auction_match``'s; the wrapper counts at least one
    sweep and at most the budget (test_sweep_count_is_jax_loop_count holds
    the count to JAX's loop on the same problems)."""
    for cost, rv, cv in problems(kind):
        cost32 = cost.astype(np.float32)
        for thr in (0.6, 2.0):
            got, sweeps = wrapper(cost32, rv, cv, thr)
            want = jax_match(cost, rv, cv, thr)
            np.testing.assert_array_equal(got, want, err_msg=f"{kind} thr {thr}")
            assert 1 <= sweeps <= 128 or not rv.any()
            t = [torch.from_numpy(a) for a in (cost32, rv, cv)]
            np.testing.assert_array_equal(cuda_auction.gated_auction_match(*t, thr).numpy(), want)
            t[0] = torch.from_numpy(cost)
            np.testing.assert_array_equal(thung.gated_auction_match(*t, thr).numpy(), want,
                                          err_msg=f"{kind} thr {thr}")
            if kind == "above" and thr == 0.6:
                assert (got == -1).all() and sweeps == 1


@pytest.mark.parametrize("budget", [1, 2, 3, 5])
def test_budget_exit_matches_jax(budget):
    """At small sweep budgets the rows still bidding exit to -1 as in JAX; the
    count is the budget where the solve needed more."""
    rng = np.random.default_rng(10 + budget)
    exhausted = 0
    for kind in ("random", "ties", "contested", "wide"):
        cost, rv, cv = problem(kind, rng)
        got, sweeps = wrapper(cost, rv, cv, 0.6, budget)
        np.testing.assert_array_equal(got, jax_match(cost, rv, cv, 0.6, budget), err_msg=f"{kind} budget {budget}")
        _, full = wrapper(cost, rv, cv, 0.6)
        assert sweeps == min(full, budget)
        exhausted += full > budget
    assert exhausted >= 2


@pytest.mark.parametrize("kind", KINDS + EDGES)
def test_sweep_count_is_jax_loop_count(kind):
    """The wrapper's assignment is JAX's and its sweep count exactly the number
    of iterations of JAX's loop, at the full budget and at a budget of 3, at
    the tracker's threshold and at 2.0, on a problem of its own and on the
    three test_wrapper_matches_jax draws, also at the warp kernel's edge
    shapes (EDGES); the plain version's bidding-row total lies between the
    sweeps and rows x sweeps; last_sweeps holds the last call's count."""
    rng = np.random.default_rng(30 + (KINDS + EDGES).index(kind))
    for i, (cost, rv, cv) in enumerate([problem(kind, rng)] + (wrapper_problems(kind) if kind in KINDS else [])):
        for thr in (0.6, 2.0):
            for budget in (128, 3):
                col, got = wrapper(cost, rv, cv, thr, budget)
                want, iterations = jax_loop(cost, rv, cv, thr, budget)
                np.testing.assert_array_equal(col, want, err_msg=f"problem {i} thr {thr} budget {budget}")
                assert got == iterations, (i, thr, budget)
                assert int(cuda_auction.last_sweeps[0]) == got
                t = [torch.from_numpy(a) for a in (cost, rv, cv)]
                _, sweeps, bids = thung.gated_auction_sweeps(*t, thr, budget)
                assert int(sweeps[0]) == got and got <= int(bids[0]) <= int(rv.sum()) * got


@pytest.mark.parametrize("rows, cols, want", [(32, 32, "auction_warp"), (1, 1, "auction_warp"),
                                              (33, 32, "auction_block"), (32, 33, "auction_block"),
                                              (40, 70, "auction_block"), (1024, 1024, "auction_block")])
def test_kernel_for(rows, cols, want):
    """Shapes up to 32 x 32 (the tracker's) go to the warp kernel, shapes above
    32 in either dimension to the block kernel."""
    assert cuda_auction.kernel_for(rows, cols) == want


BAD = {
    "float64 cost": (torch.zeros((4, 3), dtype=torch.float64), torch.ones(4, dtype=torch.bool),
                     torch.ones(3, dtype=torch.bool)),
    "1-D cost": (torch.zeros(4), torch.ones(4, dtype=torch.bool), torch.ones(4, dtype=torch.bool)),
    "int row_valid": (torch.zeros((4, 3)), torch.ones(4, dtype=torch.int32), torch.ones(3, dtype=torch.bool)),
    "short col_valid": (torch.zeros((4, 3)), torch.ones(4, dtype=torch.bool), torch.ones(2, dtype=torch.bool)),
    "no columns": (torch.zeros((4, 0)), torch.ones(4, dtype=torch.bool), torch.ones(0, dtype=torch.bool)),
    "too many rows": (torch.zeros((cuda_auction.MAX_ROWS + 1, 2)), torch.ones(cuda_auction.MAX_ROWS + 1,
                                                                              dtype=torch.bool),
                      torch.ones(2, dtype=torch.bool)),
}


@pytest.mark.parametrize("what", list(BAD))
def test_wrapper_rejects_bad_inputs(what):
    with pytest.raises(ValueError):
        cuda_auction.solve(*BAD[what], 0.6)
