"""PyTorch port, the DCNN engines against the JAX package on the CPU: the
resize operators, ``TrackPredictor``, and the slice end to end
(``TrackPredictor`` + ``RcnnTracker`` -> CSV rows) on 3 frames of 100x160.

Both packages load one seeded detectron2-format checkpoint and one re-ID
head; frames are made with numpy from a seed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import E2E_HW, e2e_frames, jax_mask_rcnn, port_config, tiny_dcnn_config

from apse_uav_tpu.dcnn import engines as jeng
from apse_uav_tpu.dcnn.config import TrackerConfig as JTrackerConfig
from apse_uav_tpu.dcnn.models.association import AssociationHead as JAssociationHead
from apse_uav_tpu.dcnn.weights import flatten
from apse_uav_tpu.utils import mask_geometry as jmg
from apse_uav_torch import convert
from apse_uav_torch.dcnn import engines as teng
from apse_uav_torch.utils import mask_geometry as tmg
from apse_uav_torch.utils.synthetic import detectron2_checkpoint

HOST_ID = 2


@pytest.fixture(scope="module")
def setup():
    """The JAX tracker's 3-frame run (its predictor's detections and maps,
    and its snapshots) and the port's tracker built from the same weights."""
    jcfg = tiny_dcnn_config(num_classes=2)
    ckpt = detectron2_checkpoint(0, 50, 2)
    _, jparams = jax_mask_rcnn(jcfg, ckpt)
    jtcfg = JTrackerConfig(max_tracks=8, max_detections=3, embedding_dim=8, roi_size=4)
    assoc = JAssociationHead(embedding_dim=8).init(jax.random.PRNGKey(1), jnp.zeros((1, 256, 4, 4)))["params"]
    frames = e2e_frames()
    jtracker = jeng.RcnnTracker(jcfg, jtcfg, jparams, assoc, E2E_HW)
    jdets, jfeats = jax.tree_util.tree_map(np.asarray, jtracker.predictor(frames))
    jrecents = jtracker.process_frames(frames)
    assoc_sd = convert.association_state_dict(flatten(jax.tree_util.tree_map(np.asarray, assoc)))
    tcfg, ttcfg = port_config(jcfg), convert.tracker_config(dataclasses.asdict(jtcfg))

    def port_tracker():
        return teng.RcnnTracker(tcfg, ttcfg, ckpt, assoc_sd, E2E_HW, device="cpu")

    return {"frames": frames, "jdets": jdets, "jfeats": jfeats, "jrecents": jrecents, "port_tracker": port_tracker}


def test_resize_target_semantics():
    (ph, pw), (nh, nw) = teng.resize_target((2160, 3840), 800, 1333, 32)
    assert (nh, nw) == (750, 1333) and (ph, pw) == (768, 1344)
    assert teng.resize_target((100, 160), 64, 128, 32) == jeng.resize_target((100, 160), 64, 128, 32)


@pytest.mark.parametrize("n_in,n_out", [(45, 16), (64, 64), (30, 83), (2160, 750), (3840, 1333)])
def test_linear_resize_matrix_matches_jax(n_in, n_out):
    np.testing.assert_allclose(teng.linear_resize_matrix(n_in, n_out), jeng.linear_resize_matrix(n_in, n_out),
                               rtol=0, atol=1e-7)


def test_resize_frames_matmul_bound_and_flips():
    """The port's separable resize against the reference's on u8 frames
    (4K / 10, resized as 4K is): both round the first product to bfloat16,
    which a last-bit difference of the float32 sums can flip to the
    neighbouring bfloat16 value (1 at u8 magnitudes 128-255).  Bound: 1.0
    (one such step, through the second operator's unit column sums); the
    share of flipped intermediates is printed and must stay below 1e-3."""
    frames = np.random.default_rng(7).integers(0, 256, (2, 216, 384, 3), np.uint8)
    a_h, a_w = teng.linear_resize_matrix(216, 75), teng.linear_resize_matrix(384, 133)
    got = teng.resize_frames_matmul(torch.from_numpy(frames), torch.from_numpy(a_h), torch.from_numpy(a_w)).numpy()
    want = np.asarray(jeng.resize_frames_matmul(jnp.asarray(frames), jnp.asarray(a_h), jnp.asarray(a_w)))
    assert got.shape == want.shape == (2, 75, 133, 3)
    inter_t = teng._bf16(torch.matmul(torch.from_numpy(frames).float().permute(0, 2, 3, 1),
                                      teng._bf16(torch.from_numpy(a_h)))).numpy()
    inter_j = np.asarray(jax.lax.dot_general(
        jnp.asarray(frames).astype(jnp.bfloat16), jnp.asarray(a_h).astype(jnp.bfloat16), (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32).astype(jnp.bfloat16).astype(jnp.float32))
    flips = float((inter_t != inter_j).mean())
    print(f"bf16 flips of the first product: {flips:.3e}; max |diff| {np.abs(got - want).max()}")
    assert flips < 1e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=1.0)


def test_track_predictor_matches_jax(setup):
    """TrackPredictor on 3 frames of 100x160: identical validity and classes,
    boxes within 0.05 px, scores within 1e-4, masks within 1e-3; p2-p6 within
    1e-4 of each map's max-abs."""
    tracker = setup["port_tracker"]()
    dets, feats = tracker.predictor(setup["frames"])
    jdets, jfeats = setup["jdets"], setup["jfeats"]
    np.testing.assert_array_equal(dets["valid"].numpy(), jdets["valid"])
    np.testing.assert_array_equal(dets["classes"].numpy(), jdets["classes"])
    np.testing.assert_allclose(dets["boxes"].numpy(), jdets["boxes"], rtol=0, atol=0.05)
    np.testing.assert_allclose(dets["scores"].numpy(), jdets["scores"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(dets["masks"].numpy(), jdets["masks"], rtol=0, atol=1e-3)
    for name in ("p2", "p3", "p4", "p5", "p6"):
        err = np.abs(feats[name].numpy() - jfeats[name]).max() / np.abs(jfeats[name]).max()
        assert err <= 1e-4, (name, err)
    assert ((dets["boxes"][..., [0, 2]] <= E2E_HW[1]) & (dets["boxes"][..., [1, 3]] <= E2E_HW[0])).all()


def test_slice_end_to_end_matches_jax(setup):
    """The slice: TrackPredictor + RcnnTracker over 3 frames in both
    packages.  Each frame: identical ``valid``, ids and classes, boxes within
    0.05 px, masks within 1e-3, and identical DCNN CSV rows."""
    got = setup["port_tracker"]().process_frames(setup["frames"])
    want = setup["jrecents"]
    assert want["valid"].any(axis=1).all()
    for t in range(3):
        for k in ("valid", "ids", "classes"):
            np.testing.assert_array_equal(got[k][t], want[k][t], err_msg=f"frame {t} {k}")
        v = want["valid"][t]
        np.testing.assert_allclose(got["boxes"][t][v], want["boxes"][t][v], rtol=0, atol=0.05)
        np.testing.assert_allclose(got["masks"][t][v], want["masks"][t][v], rtol=0, atol=1e-3)
        trow = tmg.dcnn_log_line({k: a[t] for k, a in got.items()}, HOST_ID, t, E2E_HW)
        jrow = jmg.dcnn_log_line({k: a[t] for k, a in want.items()}, HOST_ID, t, E2E_HW)
        assert trow == jrow, (trow, jrow)
    assert len(set(want["ids"][want["valid"]].tolist())) > 1


def test_pipelined_dispatch_matches_sequential(setup):
    """Dispatching batch N+1 before materialising batch N (the CLI's loop)
    gives bit-identical snapshots to sequential process_frames calls; the
    engine's one-frame API, frame count and reset work."""
    frames = e2e_frames(4, seed=3)
    seq = setup["port_tracker"]()
    want = [seq.process_frames(frames[:2]), seq.process_frames(frames[2:])]
    pip = setup["port_tracker"]()
    p1 = pip.process_frames_async(frames[:2])
    p2 = pip.process_frames_async(frames[2:])
    for w, g in zip(want, [pip.materialize(p1), pip.materialize(p2)]):
        for k in w:
            np.testing.assert_array_equal(w[k], g[k], err_msg=k)
    assert pip.frame_count == 4
    one = pip.next_frame(frames[0])
    assert one["valid"].shape == (8,) and pip.frame_count == 5
    pip.reset()
    assert pip.frame_count == 0 and not pip.state["active"].any()


def test_selective_predictor_matches_jax():
    """``SelectivePredictor`` (proposals from p6 alone, anchors of p6's own
    size) on the 3 frames of 100x160 against JAX's: identical validity and
    classes, boxes within 0.05 px (scaled to the frames, not re-clipped),
    scores within 1e-4, masks within 1e-3; both stage timings recorded; on
    these frames p6 proposes other boxes than the whole pyramid does."""
    jcfg = tiny_dcnn_config(num_classes=2)
    ckpt = detectron2_checkpoint(0, 50, 2)
    _, jparams = jax_mask_rcnn(jcfg, ckpt)
    frames = e2e_frames()
    jsel = jeng.SelectivePredictor(jcfg, jparams, E2E_HW)
    want = jax.tree_util.tree_map(np.asarray, jsel(frames))
    sel = teng.SelectivePredictor(port_config(jcfg), ckpt, E2E_HW, device="cpu")
    got = sel(frames)
    np.testing.assert_array_equal(got["valid"].numpy(), want["valid"])
    np.testing.assert_array_equal(got["classes"].numpy(), want["classes"])
    np.testing.assert_allclose(got["boxes"].numpy(), want["boxes"], rtol=0, atol=0.05)
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["masks"].numpy(), want["masks"], rtol=0, atol=1e-3)
    assert set(sel.timings) == {"backbone", "selective_scan"} and min(sel.timings.values()) > 0
    full, _ = sel.base(frames)
    assert not np.array_equal(full["boxes"].numpy(), got["boxes"].numpy())


def test_engines_raise_for_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the no-fallback rule is exercised on the CPU-only host")
    cfg = port_config(tiny_dcnn_config())
    with pytest.raises(RuntimeError, match="cuda"):
        teng.TrackPredictor(cfg, None, E2E_HW)  # the default device is cuda
    with pytest.raises(RuntimeError, match="cuda"):
        teng.SelectivePredictor(cfg, None, E2E_HW)
    with pytest.raises(RuntimeError, match="cuda"):
        teng.RcnnTracker(cfg, convert.tracker_config({}), None, {}, E2E_HW)


def test_full_fp32_scopes_tf32_off():
    """Inside the engines' calls TF32 is off for matmuls and cuDNN; the
    caller's settings come back after, also when the block raises."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        with pytest.raises(KeyError):
            with teng.full_fp32():
                assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
                raise KeyError("inside")
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
