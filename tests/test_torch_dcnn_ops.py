"""PyTorch port, DCNN ops: box math, exact NMS, ROIAlign, the flat
multi-level ROIAlign, the gated auction, the exact Jonker-Volgenant solver,
the eps-scaled auction and the fixed-point loop, against the JAX package
(and scipy) on the CPU.

Inputs are made with numpy from fixed seeds and handed to both packages.
Discrete outputs (keep masks, assignments) must be identical; float outputs
are held to the tolerance each test states.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.optimize
import torch

from apse_uav_tpu.dcnn import hungarian as jhung
from apse_uav_tpu.dcnn.models import roi_heads as jrh
from apse_uav_tpu.dcnn.ops import boxes as jboxes, nms as jnms
from apse_uav_tpu.dcnn.ops.roi_align import roi_align_hwc as j_roi_align_hwc
from apse_uav_torch.dcnn import hungarian as thung
from apse_uav_torch.dcnn.models import roi_heads as trh
from apse_uav_torch.dcnn.ops import boxes as tboxes, loops, nms as tnms, roi_align as troi


def _boxes(rng, n, size=100.0, dup=0):
    xy = rng.uniform(0, size, (n, 2))
    wh = rng.uniform(1, size / 3, (n, 2))
    b = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
    if dup:
        b[-dup:] = b[:dup]  # exact duplicates: IoU 1
    return b


def test_box_math_matches_jax():
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, 40), _boxes(rng, 30)
    deltas = rng.normal(0, 1.5, (40, 4)).astype(np.float32)  # dw/dh beyond the clamp too
    w = (10.0, 10.0, 5.0, 5.0)
    for name, got, want in [
        ("area", tboxes.box_area(torch.from_numpy(a)), jboxes.box_area(a)),
        ("iou", tboxes.box_iou(torch.from_numpy(a), torch.from_numpy(b)), jboxes.box_iou(a, b)),
        ("clip", tboxes.clip_boxes(torch.from_numpy(a * 1.5 - 20), (90, 70)),
         jboxes.clip_boxes(a * 1.5 - 20, (90, 70))),
        ("deltas", tboxes.get_deltas(torch.from_numpy(a), torch.from_numpy(a[::-1].copy()), w),
         jboxes.get_deltas(a, a[::-1].copy(), w)),
        ("apply", tboxes.apply_deltas(torch.from_numpy(deltas), torch.from_numpy(a), w),
         jboxes.apply_deltas(deltas, a, w)),
    ]:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(tboxes.nonempty(torch.from_numpy(a), 10.0).numpy(),
                                  np.asarray(jboxes.nonempty(a, 10.0)))


def _nms_case(kind: str, rng):
    n = 96
    boxes = _boxes(rng, n, dup=12)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    valid = np.ones(n, bool)
    if kind == "ties":
        scores = np.round(scores * 4) / 4  # many exact ties: order by index
    if kind == "invalid":
        valid = rng.uniform(size=n) > 0.3
    if kind == "chain":  # a long suppression chain: boxes shifted a little at a time
        x = np.arange(n, dtype=np.float32) * 1.5
        boxes = np.stack([x, np.zeros(n), x + 10, np.full(n, 10.0)], axis=1).astype(np.float32)
        scores = np.linspace(1, 0, n).astype(np.float32)
    return boxes, scores, valid


@pytest.mark.parametrize("kind", ["random", "ties", "invalid", "chain"])
def test_nms_keep_mask_identical(kind):
    """Identical keep masks on boxes with duplicates, score ties, invalid
    entries and a long suppression chain; a batch of problems at once gives
    each problem's own mask."""
    rng = np.random.default_rng(1)
    cases = [_nms_case(kind, rng) for _ in range(3)]
    got = tnms.nms_mask(*(torch.from_numpy(np.stack([c[i] for c in cases])) for i in (0, 1)), 0.5,
                        torch.from_numpy(np.stack([c[2] for c in cases])))
    for i, (b, s, v) in enumerate(cases):
        want = np.asarray(jnms.nms_mask(jnp.asarray(b), jnp.asarray(s), 0.5, jnp.asarray(v)))
        np.testing.assert_array_equal(got[i].numpy(), want)
        np.testing.assert_array_equal(tnms.nms_mask(torch.from_numpy(b), torch.from_numpy(s), 0.5,
                                                    torch.from_numpy(v)).numpy(), want)
    if kind == "chain":
        assert got[0].numpy().sum() not in (0, 96)


def test_batched_nms_identical():
    rng = np.random.default_rng(2)
    b, s, v = _nms_case("ties", rng)
    idxs = rng.integers(0, 3, b.shape[0])
    want = jnms.batched_nms(jnp.asarray(b), jnp.asarray(s), jnp.asarray(idxs), 0.4, jnp.asarray(v))
    got = tnms.batched_nms(torch.from_numpy(b), torch.from_numpy(s), torch.from_numpy(idxs), 0.4, torch.from_numpy(v))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_run_until_tests_every_k_steps_same_result():
    """Testing convergence every k steps gives the result of testing after
    every step, within the step budget; the number of tests is counted as
    ``sync.<site>``."""
    from apse_uav_torch.utils import profiling

    def step(x):
        return torch.clamp(x - 1, min=0)

    for every in (1, 3, 8):
        profiling.reset_counters()
        got = loops.run_until(step, torch.tensor([5, 2, 0]), lambda x: (x == 0).all(), 100, every,
                              site="nms_converge")
        assert got.tolist() == [0, 0, 0]
        assert profiling.counters == {"sync.nms_converge": -(-5 // every)}
    capped = loops.run_until(step, torch.tensor([50]), lambda x: (x == 0).all(), 7, 4, site="nms_converge")
    assert capped.tolist() == [43]


@pytest.mark.parametrize("aligned,ratio", [(True, 1), (True, 2), (False, 4)])
def test_roi_align_hwc_matches_jax(aligned, ratio):
    """<= 1e-5 of the map's max-abs, boxes reaching past the border band too."""
    rng = np.random.default_rng(3)
    feat = rng.normal(size=(24, 30, 8)).astype(np.float32)
    extra = [[-30, -30, -5, -5], [0, 0, 0.3, 0.2]]  # outside the border band; below 1 px
    boxes = np.concatenate([_boxes(rng, 20, size=140.0) - 10, extra]).astype(np.float32)
    want = j_roi_align_hwc(jnp.asarray(feat), jnp.asarray(boxes), 5, 0.25, ratio, aligned)
    got = troi.roi_align_hwc(torch.from_numpy(feat), torch.from_numpy(boxes), 5, 0.25, ratio, aligned)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5 * np.abs(feat).max())


def _fpn_feats(rng, hw=(32, 48), c=8):
    h, w = hw
    return {f"p{i + 2}": rng.normal(size=(2, -(-h // 2**i), -(-w // 2**i), c)).astype(np.float32) for i in range(4)}


@pytest.mark.parametrize("ratio", [1, 2])
def test_fpn_roi_align_matches_jax_and_dense_oracle(ratio):
    """Batched flat multi-level ROIAlign against the JAX one per image, and
    against the dense every-level oracle: <= 1e-5 of the maps' max-abs.
    Boxes span every FPN level (sizes 2..900 px on a 128x192 image)."""
    rng = np.random.default_rng(4)
    feats = _fpn_feats(rng)
    sizes = np.exp(rng.uniform(np.log(2), np.log(900), (2, 24, 1)))
    xy = rng.uniform(-20, 180, (2, 24, 2))
    boxes = np.concatenate([xy, xy + sizes * rng.uniform(0.5, 1.5, (2, 24, 2))], axis=-1).astype(np.float32)
    tfeats = {k: torch.from_numpy(v) for k, v in feats.items()}
    got = trh.fpn_roi_align(tfeats, torch.from_numpy(boxes), 7, ratio)
    dense = trh.fpn_roi_align_dense(tfeats, torch.from_numpy(boxes), 7, ratio)
    scale = max(np.abs(v).max() for v in feats.values())
    assert len(set(trh.assign_boxes_to_levels(torch.from_numpy(boxes)).reshape(-1).tolist())) == 4
    for b in range(2):
        want = jrh.fpn_roi_align({k: jnp.asarray(v[b]) for k, v in feats.items()}, jnp.asarray(boxes[b]), 7, ratio)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want), rtol=0, atol=1e-5 * scale)
        np.testing.assert_allclose(got[b].numpy(), dense[b].numpy(), rtol=0, atol=1e-5 * scale)
    want_lvl = np.asarray(jrh.assign_boxes_to_levels(jnp.asarray(boxes.reshape(-1, 4)))).reshape(2, 24)
    np.testing.assert_array_equal(trh.assign_boxes_to_levels(torch.from_numpy(boxes)).numpy(), want_lvl)


def _cost_case(kind, rng, r=12, c=10):
    cost = rng.uniform(0, 1.2, (r, c)).astype(np.float32)
    rv, cv = np.ones(r, bool), np.ones(c, bool)
    if kind == "ties":
        cost = np.round(cost * 3) / 3  # exact ties between columns and rows
    if kind == "invalid":
        rv[rng.uniform(size=r) < 0.3] = False
        cv[rng.uniform(size=c) < 0.3] = False
    if kind == "contested":  # every row prefers the same few columns
        cost = (rng.uniform(0, 0.05, (r, c)) + np.arange(c)[None, :] * 0.1).astype(np.float32)
    return cost, rv, cv


@pytest.mark.parametrize("kind", ["random", "ties", "invalid", "contested"])
def test_gated_auction_identical(kind):
    """Identical assignments on random costs, exact ties, invalid rows and
    columns and crowded columns, at two thresholds."""
    rng = np.random.default_rng(5)
    for _ in range(4):
        cost, rv, cv = _cost_case(kind, rng)
        for thr in (0.6, 2.0):
            want = np.asarray(jhung.gated_auction_match(jnp.asarray(cost), jnp.asarray(rv), jnp.asarray(cv), thr))
            got = thung.gated_auction_match(torch.from_numpy(cost), torch.from_numpy(rv), torch.from_numpy(cv), thr)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{kind} thr {thr}")


def test_pad_cost_matches_jax():
    rng = np.random.default_rng(6)
    cost, rv, cv = _cost_case("invalid", rng)
    cost[0, 0] = np.inf
    np.testing.assert_array_equal(
        thung.pad_cost(torch.from_numpy(cost), torch.from_numpy(rv), torch.from_numpy(cv)).numpy(),
        np.asarray(jhung.pad_cost(jnp.asarray(cost), jnp.asarray(rv), jnp.asarray(cv))))


def _cost(n: int, seed: int) -> np.ndarray:
    """Uniform costs in [0, 4) (the tracker's embedding distances); odd seeds
    rounded to integers, so many optima tie."""
    c = np.random.default_rng(seed).uniform(0, 4, (n, n)).astype(np.float32)
    return np.round(c) if seed % 2 else c


@pytest.mark.parametrize("maximize", [False, True])
@pytest.mark.parametrize("n,seed", [(1, 0), (2, 1), (5, 2), (8, 3), (16, 4), (32, 5), (32, 6)])
def test_linear_sum_assignment_matches_jax_and_scipy(n, seed, maximize):
    """Jonker-Volgenant: the reference's assignment exactly (ties included),
    and scipy's optimal cost within float32 rounding (1e-5 per row)."""
    c = _cost(n, seed)
    rows, cols = thung.linear_sum_assignment(torch.from_numpy(c), maximize)
    np.testing.assert_array_equal(rows.numpy(), np.arange(n))
    np.testing.assert_array_equal(cols.numpy(), np.asarray(jhung.linear_sum_assignment(jnp.asarray(c), maximize)[1]))
    r, sc = scipy.optimize.linear_sum_assignment(c, maximize=maximize)
    assert sorted(cols.tolist()) == list(range(n))
    assert abs(float(c[rows.numpy(), cols.numpy()].sum()) - float(c[r, sc].sum())) <= 1e-5 * n


@pytest.mark.parametrize("max_sweeps", [256, 3])
@pytest.mark.parametrize("n,seed", [(1, 0), (5, 2), (8, 3), (16, 4), (32, 5), (32, 6)])
def test_auction_assignment_matches_jax_and_scipy(n, seed, max_sweeps):
    """The eps-scaled auction: the reference's assignment exactly, both ways
    (``maximize``), also when the budget runs out and leftover rows take the
    free columns (a 3-sweep budget; integer costs with many ties exhaust even
    the full 256 at n = 32, in both packages).  On continuous costs with the
    full budget, within n x the last eps (spread / 4096) of scipy's optimum."""
    c = _cost(n, seed)
    for maximize in (False, True):
        _, cols = thung.auction_assignment(torch.from_numpy(c), maximize, max_sweeps)
        want = jhung.auction_assignment(jnp.asarray(c), maximize=maximize, max_sweeps=max_sweeps)[1]
        np.testing.assert_array_equal(cols.numpy(), np.asarray(want))
        assert sorted(cols.tolist()) == list(range(n))
        if max_sweeps == 256 and seed % 2 == 0:
            r, sc = scipy.optimize.linear_sum_assignment(c, maximize=maximize)
            gap = abs(float(c[np.arange(n), cols.numpy()].sum()) - float(c[r, sc].sum()))
            assert gap <= n * (float(c.max() - c.min()) + 1e-6) / 4096 + 1e-5 * n
