"""PyTorch port, the ArUco candidate stage's constants and its split, on the CPU.

``ArucoPipeline`` makes the dictionary's rotation table and the slots' patch
sizes once, and runs the candidate stage as two functions with K1 between
them (on a card, two CUDA graphs).  Each is held bit for bit to the path
that copies its constant from the host at every call, and the split stage to
the benchmark's frozen plain copy of the unsplit one
(``benchmark/refplain/aruco/detector.py``).
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from refplain.aruco import detector as rdet  # noqa: E402

from apse_uav_torch.aruco import cuda_labeling, detector as det, dictionary as dict_mod, patch_select  # noqa: E402
from apse_uav_torch.aruco.pipeline import ArucoPipeline, ArucoPipelineConfig  # noqa: E402
from apse_uav_torch.core import camera  # noqa: E402
from apse_uav_torch.utils import profiling  # noqa: E402
from apse_uav_torch.utils.synthetic import MarkerSpec, render_scene  # noqa: E402

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
W, H = 960, 544


def test_match_dictionary_with_the_table_matches_the_copy():
    """Every exact code in each rotation, codes 1 and 2 bits off, and random
    codes: ids, rotations and distances bit for bit with and without the
    table made once; only the call without it counts a copy."""
    rng = np.random.default_rng(11)
    rotations = dict_mod._ALL_ROTATIONS.reshape(-1)
    flips = (1 << rng.integers(0, 16, (2, rotations.size))).sum(0)
    codes = np.concatenate([rotations, rotations ^ (1 << rng.integers(0, 16, rotations.size)), rotations ^ flips,
                            rng.integers(0, 1 << 16, 400)])
    bits = torch.from_numpy(codes).reshape(4, -1)
    table = dict_mod.rotation_table("cpu")
    for rate in (2.0, 0.0):
        profiling.reset_counters()
        want = dict_mod.match_dictionary(bits, rate)
        assert profiling.counted("sync") == {"dictionary_table": 1}
        got = dict_mod.match_dictionary(bits, rate, table)
        assert profiling.counted("sync") == {"dictionary_table": 1}
        for g, wnt in zip(got, want):
            assert g.dtype == wnt.dtype and torch.equal(g, wnt)
        assert bool((want[0] >= 0).any()) and bool((want[0] < 0).any())


@pytest.mark.parametrize("t_sel", [256, 6], ids=["budget", "overflow"])
def test_select_tiles_with_the_patch_sizes_matches_the_copy(t_sel):
    """sel and covered bit for bit with and without the patch sizes made
    once (4K slots, at the shipped budget and at one that overflows); only
    the call without them counts a copy."""
    h, w = 2160, 3840
    p = det.DetectorParams()
    groups = tuple(det._patch_groups(h, w, p))
    k = groups[-1][1]
    rng = np.random.default_rng(5)
    centers = torch.from_numpy(np.stack([rng.random((3, k)) * h, rng.random((3, k)) * w], -1).astype(np.float32))
    valid = torch.from_numpy(rng.random((3, k)) < 0.4)
    kw = dict(h=h, w=w, th=40, tw=256, groups=groups, t_sel=t_sel, per_scale_k=p.per_scale_k)
    profiling.reset_counters()
    want = patch_select.select_tiles_batched(centers, valid, **kw)
    assert profiling.counted("sync") == {"tile_sizes": 1}
    got = patch_select.select_tiles_batched(centers, valid, psize=patch_select.patch_sizes(groups, k, "cpu"), **kw)
    assert profiling.counted("sync") == {"tile_sizes": 1}
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if t_sel == 6:
        assert got[1].sum() < valid.sum()


@pytest.fixture(scope="module")
def frames():
    mtx, dist = camera.load_camera_params(os.path.join(REPO, "data", "cam_params.json"))
    mtx = mtx * np.array([[W / 3840, 1, W / 3840], [1, H / 2160, H / 2160], [1, 1, 1]])
    specs = [MarkerSpec(4, (0.0, 0.5), 5), MarkerSpec(1, (-4.0, -2.0), 30), MarkerSpec(2, (4.0, 1.5), -20)]
    one = render_scene(mtx, dist, (W, H), specs, altitude=12.0, device="cpu").permute(2, 0, 1)
    return (mtx, dist), torch.stack([one, (one.to(torch.int32) * 7 // 8).to(torch.uint8)]).contiguous()


@pytest.mark.parametrize("two_pass", [True, False], ids=["two_pass", "single_pass"])
def test_split_candidate_stage_matches_the_unsplit_one(frames, two_pass):
    """The candidate stage of a pipeline call, on what the front gave it:
    the pipeline's own (windows, K1, the rest, with the table made once),
    the same three functions called here, and ``det.candidates`` without
    the table, all bit for bit the plain reference's unsplit stage; the
    pipeline's counts no copy."""
    cam, batch = frames
    pipe = ArucoPipeline(*cam, (W, H), ArucoPipelineConfig(two_pass=two_pass), device="cpu")
    seen = []
    stage = pipe._candidates
    pipe._candidates = lambda *a: seen.append((a, stage(*a))) or seen[-1][1]
    profiling.reset_counters()
    pipe.front(batch)
    assert profiling.counted("sync") == {}
    (gray, centers, sizes, scores, valid, covered), (corners, ids) = seen[0]
    assert (covered is not None) == two_pass
    p = pipe.params
    want = rdet.candidates(gray, centers, sizes, scores, valid, rdet.DetectorParams(**dataclasses.asdict(p)),
                           covered)
    assert bool((want[1] >= 0).sum(1).ge(3).all())
    pres, darks = det.binarized_windows(gray, centers, sizes, p)
    split = det.candidates_from_labels(cuda_labeling.labels(darks), pres, scores, valid, (H, W), p, covered,
                                       dict_mod.rotation_table("cpu"))
    for got in ((corners, ids), split, det.candidates(gray, centers, sizes, scores, valid, p, covered)):
        assert got[0].dtype == want[0].dtype and torch.equal(got[0], want[0])
        assert got[1].dtype == want[1].dtype and torch.equal(got[1], want[1])
