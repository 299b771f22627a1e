"""PyTorch port, detector: labeling (plain K1), proposals (plain K2 and the
decimated pyramid), tile selection, the candidate stage and ArucoDetector
against the JAX package on the CPU."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from apse_uav_tpu.aruco import detector as jdet, patch_select as jps
from apse_uav_tpu.core import camera as jcam
from apse_uav_tpu.preproc import remap as jremap
from apse_uav_tpu.utils.synthetic import MarkerSpec, render_scene
from apse_uav_torch.aruco import cuda_labeling, cuda_proposals, detector as tdet, patch_select as tps

import torch_parity

W, H = 960, 544
WIN = 64


@pytest.fixture(scope="module")
def gray():
    """The scene of test_aruco_detector (4 markers, 12 m), through the JAX
    preprocessing, so both detectors read the same gray."""
    mtx, dist = jcam.load_camera_params(os.path.join(os.path.dirname(__file__), "..", "data", "cam_params.json"))
    ms = mtx * np.array([[W / 3840, 1, W / 3840], [1, H / 2160, H / 2160], [1, 1, 1]])
    specs = [
        MarkerSpec(4, (0.0, 0.5), 5, leds=0b10110010),
        MarkerSpec(1, (-4.0, -2.0), 30),
        MarkerSpec(2, (4.0, 1.5), -20),
        MarkerSpec(3, (1.5, -2.5), 90),
    ]
    img = render_scene(ms, dist, (W, H), specs, altitude=12.0)
    _, g = jremap.preprocess_frames(jnp.asarray(img[None]), jnp.asarray(ms, jnp.float32),
                                    jnp.asarray(dist, jnp.float32), (W, H))
    return np.asarray(g)


@pytest.fixture(scope="module")
def jax_detect(gray):
    """The reference detector on that gray: corners (K, 4, 2) x,y, ids (K,)."""
    cj, ij = jdet.ArucoDetector(jdet.DetectorParams()).detect(jnp.asarray(gray))
    return np.asarray(cj)[0], np.asarray(ij)[0]


def _masks():
    """The mask set of test_aruco_detector's Pallas-labeling parity test."""
    masks = []
    ring = np.zeros((WIN, WIN), bool)
    ring[2:62, 2:62] = True
    ring[5:59, 5:59] = False
    masks.append(ring)
    c = ring.copy()
    c[2:5, 28:36] = False
    masks.append(c)
    for seed in range(3):
        noise = np.random.default_rng(seed).random((WIN, WIN))
        masks.append(ndi.uniform_filter(noise, 7) < 0.47)
        masks.append(noise < 0.5)
    masks.append(np.zeros((WIN, WIN), bool))
    return np.stack(masks)


def test_labeling_plain_matches_jax_bit_for_bit():
    """K1's plain version: the largest-component masks are bit-identical to
    the reference's _largest_component (same fixed schedule, integer keys)."""
    masks = _masks()
    want = np.asarray(jax.vmap(lambda d: jdet._largest_component(d, WIN))(jnp.asarray(masks)))
    labels = cuda_labeling.labels(torch.from_numpy(masks))  # CPU tensor: the plain version
    assert labels.dtype == torch.int32
    got = tdet._largest_from_labels(labels, WIN).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(tdet._largest_component(torch.from_numpy(masks), WIN).numpy(), want)
    # Root labels: y*win + x of a component cell; sentinel win*win off the mask.
    assert (labels.numpy()[~masks] == WIN * WIN).all()


@pytest.mark.slow
def test_labeling_label_field_matches_pallas_interpret():
    """The full label field against the reference kernel in interpret mode."""
    from apse_uav_tpu.aruco import pallas_labeling

    masks = _masks()
    want = np.asarray(pallas_labeling.labels_batched(jnp.asarray(masks), interpret=True))
    assert np.array_equal(tdet._label_sweeps(torch.from_numpy(masks)).numpy(), want)


def test_proposals_plain_match_jax(gray):
    """K2's plain version against _proposals_from_pool: the same valid
    candidate set per scale, scores within 5e-4 (the JAX contract,
    test_aruco_detector.py:224-257; the port sums its integral image in
    float64, the reference in float32)."""
    p = jdet.DetectorParams()
    tp = tdet.DetectorParams()
    pool = np.asarray(jdet._pool_gray(jnp.asarray(gray[0]), p.proposal_stride))
    want = [np.asarray(x) for x in jdet._proposals_from_pool(jnp.asarray(pool), H, W, p)]
    got = [x[0].numpy() for x in cuda_proposals.proposals_from_pool(torch.from_numpy(pool[None]), H, W, tp)]
    assert got[0].shape == want[0].shape
    k = p.per_scale_k
    n_valid = 0
    for a in range(0, want[1].shape[0], k):
        sl = slice(a, a + k)
        ours = {(float(c[0]), float(c[1]), float(s)): float(v) for c, s, v, ok in zip(*(x[sl] for x in got)) if ok}
        theirs = {(float(c[0]), float(c[1]), float(s)): float(v) for c, s, v, ok in zip(*(x[sl] for x in want)) if ok}
        assert set(ours) == set(theirs), (a // k, ours, theirs)
        for key in ours:
            assert abs(ours[key] - theirs[key]) < 5e-4
        n_valid += len(ours)
    assert n_valid >= 4
    assert tdet._kept_scales(H, W, tp) == jdet._kept_scales(H, W, p)
    for size in ((3840, 2160), (1280, 736)):
        assert tdet._patch_groups(size[1], size[0], tp) == jdet._patch_groups(size[1], size[0], p)


@pytest.mark.parametrize("t_sel", [256, 6], ids=["budget", "overflow"])
def test_select_tiles_matches_jax(t_sel):
    """sel and covered identical, including when the tile budget overflows
    and both packages must drop the same candidates."""
    h, w = 2160, 3840
    p = jdet.DetectorParams()
    groups = tuple(jdet._patch_groups(h, w, p))
    k = groups[-1][1]
    rng = np.random.default_rng(4)
    centers = np.stack([rng.random((2, k)) * h, rng.random((2, k)) * w], -1).astype(np.float32)
    valid = rng.random((2, k)) < 0.3
    th, tw = 40, 256
    kw = dict(h=h, w=w, th=th, tw=tw, groups=groups, t_sel=t_sel, per_scale_k=p.per_scale_k)
    sel_j, cov_j = jps.select_tiles_batched(jnp.asarray(centers), jnp.asarray(valid), **kw)
    sel_t, cov_t = tps.select_tiles_batched(torch.from_numpy(centers), torch.from_numpy(valid), **kw)
    assert sel_t.dtype == torch.int32
    assert np.array_equal(sel_t.numpy(), np.asarray(sel_j))
    assert np.array_equal(cov_t.numpy(), np.asarray(cov_j))
    if t_sel == 6:
        assert cov_t.sum() < torch.from_numpy(valid).sum()


def test_candidate_stage_matches_jax(gray, jax_detect):
    """The full detector on the same gray: the same decoded ids, and every
    marker's corners within 0.05 px of the reference's -- directly, or once
    the port restarts its refinement from the reference's own coarse
    corners.  The coarse corners agree within 1e-4 px (ulps of atan2, sin,
    cos and long sums), but the corner refinement is not continuous in its
    start (test_reference_refinement_moves_with_its_start), so those ulps
    can move a refined corner by tenths of a pixel; from one and the same
    start the two refinements agree."""
    tp = tdet.DetectorParams()
    cj, ij = jax_detect
    g = torch.from_numpy(gray)
    pool = g.to(torch.float32).reshape(1, H // 4, 4, W // 4, 4).mean(dim=(2, 4))
    props = cuda_proposals.proposals_from_pool(pool, H, W, tp)
    ct, it = tdet.candidates(g, *props, tp)
    ct, it = ct[0].numpy(), it[0].numpy()
    want = {int(i): cj[n] for n, i in enumerate(ij) if i >= 0}
    slot = {int(i): n for n, i in enumerate(it) if i >= 0}
    assert set(slot) == set(want) and {1, 2, 3, 4} <= set(slot)
    for i, k in slot.items():
        err = torch_parity.corner_errors(gray[0], props[0][0, k].numpy(), float(props[1][0, k]), k, ct[k], want[i])
        assert err["replay"] <= 1e-3 and err["coarse"] <= 1e-4, (i, err)
        assert min(err["direct"], err["restarted"]) <= 0.05, (i, err)


def test_reference_refinement_moves_with_its_start(gray):
    """Evidence for the restart above: the reference's own window-pass
    refinement, started from the port's coarse corners instead of its own
    (at most 1e-4 px apart), moves a marker's corners by more than 0.1 px,
    while it stays within 0.01 px for the other markers."""
    tp = tdet.DetectorParams()
    g = torch.from_numpy(gray)
    pool = g.to(torch.float32).reshape(1, H // 4, 4, W // 4, 4).mean(dim=(2, 4))
    props = cuda_proposals.proposals_from_pool(pool, H, W, tp)
    _, it = tdet.candidates(g, *props, tp)
    moves = []
    for k in np.flatnonzero(it[0].numpy() >= 0):
        center, size, ps = props[0][0, k].numpy(), float(props[1][0, k]), torch_parity.slot_psize(H, W, k)
        coarse_ref, win = torch_parity.reference_coarse(gray[0], center, size, ps)
        coarse_port = torch_parity.port_candidate(gray[0], center, size, ps)[2]
        assert np.abs(coarse_port - coarse_ref).max() <= 1e-4

        def refine(coarse):
            return np.asarray(jdet._refine_edges(win, jnp.asarray(coarse), tp.edge_points, jnp.float32(1.0),
                                                 step_scale=1.04, n_taps=11)[0])

        moves.append(float(np.abs(refine(coarse_port) - refine(coarse_ref)).max()))
    moves.sort()
    assert moves[-1] > 0.1 and moves[-2] <= 0.01, moves


def test_detector_detect_matches_jax(gray, jax_detect):
    """ArucoDetector.detect on the CPU, on (H, W) and on (B, H, W) gray,
    against the reference's ArucoDetector.detect: the same decoded ids, and
    the port's output is bit for bit its staged path (pool, proposals,
    candidate stage), whose corners test_candidate_stage_matches_jax holds
    within 0.05 px of the reference's (directly or restarted from the
    reference's coarse corners)."""
    tp = tdet.DetectorParams()
    detector = tdet.ArucoDetector(tp, device="cpu")
    g = torch.from_numpy(gray)
    corners, ids = detector.detect(g)
    one_corners, one_ids = detector.detect(g[0])
    assert corners.shape == (1, *one_corners.shape) and torch.equal(corners[0], one_corners)
    assert torch.equal(ids[0], one_ids)
    pool = tdet.pool_gray(g, tp.proposal_stride)
    assert torch.equal(pool, g.to(torch.float32).reshape(1, H // 4, 4, W // 4, 4).mean(dim=(2, 4)))
    assert np.array_equal(pool[0].numpy(), np.asarray(jdet._pool_gray(jnp.asarray(gray[0]), 4)))
    staged = tdet.candidates(g, *cuda_proposals.proposals_from_pool(pool, H, W, tp), tp)
    assert torch.equal(staged[0], corners) and torch.equal(staged[1], ids)
    _, ij = jax_detect
    assert set(ids[0][ids[0] >= 0].tolist()) == set(ij[ij >= 0].tolist()) >= {1, 2, 3, 4}
    with pytest.raises(ValueError):
        detector.detect(g[0, 0])


def test_decimated_proposals_match_jax(gray):
    """decimate=True: the pyramid, per-level integrals and cross-level NMS of
    the reference's _proposals_from_pool, in plain PyTorch: the same valid
    candidate set per scale, scores within 5e-4; the same scale ladder and
    patch groups.  The kernel wrapper refuses decimate=True on the card."""
    p = jdet.DetectorParams(decimate=True)
    tp = tdet.DetectorParams(decimate=True)
    pool = np.asarray(jdet._pool_gray(jnp.asarray(gray[0]), p.proposal_stride))
    want = [np.asarray(x) for x in jax.jit(lambda a: jdet._proposals_from_pool(a, H, W, p))(jnp.asarray(pool))]
    got = [x[0].numpy() for x in tdet.proposals(torch.from_numpy(pool[None]), H, W, tp)]
    assert got[0].shape == want[0].shape
    assert len({e.q for e in tdet.scale_plans(H, W, tp)}) > 1  # the pyramid is in use
    k = p.per_scale_k
    n_valid = 0
    for a in range(0, want[1].shape[0], k):
        sl = slice(a, a + k)
        ours = {(float(c[0]), float(c[1]), float(s)): float(v) for c, s, v, ok in zip(*(x[sl] for x in got)) if ok}
        theirs = {(float(c[0]), float(c[1]), float(s)): float(v) for c, s, v, ok in zip(*(x[sl] for x in want)) if ok}
        assert set(ours) == set(theirs), (a // k, ours, theirs)
        assert all(abs(ours[key] - theirs[key]) < 5e-4 for key in ours)
        n_valid += len(ours)
    assert n_valid >= 4
    for size in ((960, 544), (3840, 2160), (320, 180)):
        assert tdet._kept_scales(size[1], size[0], tp) == jdet._kept_scales(size[1], size[0], p)
        assert tdet._patch_groups(size[1], size[0], tp) == jdet._patch_groups(size[1], size[0], p)
