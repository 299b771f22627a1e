"""PyTorch port, the JAX package's last public functions against their JAX
counterparts on the CPU: the single-basin pose (``solve_pnp_planar``,
``estimate_pose_single_markers``), the per-frame ``select_tiles``,
``tracker_step``, the dense ``fpn_roi_align_dense`` oracle and
``batch_sharding``; and (``slow``) the 4K operating point against ground
truth in both packages.  ``build_mask_rcnn`` and ``run_inference`` are held
to JAX's in test_torch_mask_rcnn.py, on that file's shared JAX model.

Inputs are made with numpy from fixed seeds and handed to both packages;
tolerances are stated per test.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apse_uav_tpu.aruco import detector as jdet, patch_select as jps, pose as jpose
from apse_uav_tpu.core import camera as jcam
from apse_uav_tpu.dcnn import structures as jstructures, tracker as jtracker
from apse_uav_tpu.dcnn.config import TrackerConfig as JTrackerConfig
from apse_uav_tpu.dcnn.models import roi_heads as jrh
from apse_uav_tpu.dcnn.models.association import AssociationHead as JAssociationHead
from apse_uav_tpu.dcnn.weights import flatten
from apse_uav_tpu.parallel import mesh as jmesh
from apse_uav_torch import convert
from apse_uav_torch.aruco import patch_select as tps, pose as tpose
from apse_uav_torch.core import camera as tcam
from apse_uav_torch.dcnn import structures as tstructures, tracker as ttracker
from apse_uav_torch.dcnn.models import roi_heads as trh
from apse_uav_torch.dcnn.models.association import AssociationHead
from apse_uav_torch.parallel import mesh as tmesh

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


@pytest.fixture(scope="module")
def cam():
    mtx, dist = jcam.load_camera_params(os.path.join(REPO, "data", "cam_params.json"))
    return mtx.astype(np.float32), dist.astype(np.float32)


def test_single_basin_pose_matches_jax(cam):
    """``estimate_pose_single_markers`` on (4, 6) markers (two leading
    dimensions) projected from seeded poses at 8-40 m with 0.05 px corner
    noise against JAX's, and ``solve_pnp_planar`` on each of the first six
    with the 0.55 m object points against JAX's results for them (JAX's
    ``estimate_pose_single_markers`` is its ``solve_pnp_planar`` over those
    object points, batched): tvec within 1e-3 relative and rvec within 1e-3
    rad (test_torch_pose.py's two-basin bounds); the port's result is the
    best basin of its ``estimate_pose_single_markers_two``."""
    mtx, dist = cam
    rng = np.random.default_rng(5)
    obj = np.asarray(jpose.marker_object_points(1.0))
    corners = []
    for _ in range(24):
        rvec = np.r_[rng.normal(scale=0.15, size=2), rng.uniform(-np.pi, np.pi)].astype(np.float32)
        tvec = np.r_[rng.uniform(-4, 4, size=2), rng.uniform(8, 40)].astype(np.float32) / 0.55
        pts = np.asarray(jcam.project_points(jnp.asarray(obj), jnp.asarray(rvec), jnp.asarray(tvec),
                                             jnp.asarray(mtx), jnp.asarray(dist)))
        corners.append(pts + rng.normal(scale=0.05, size=pts.shape))
    corners = np.stack(corners).astype(np.float32).reshape(4, 6, 4, 2)
    tm, td = torch.from_numpy(mtx), tcam.pad_dist_coeffs(dist)
    want_r, want_t = (np.asarray(x) for x in jpose.estimate_pose_single_markers(jnp.asarray(corners), 0.55,
                                                                               jnp.asarray(mtx), jnp.asarray(dist)))
    got_r, got_t = (x.numpy() for x in tpose.estimate_pose_single_markers(torch.from_numpy(corners), 0.55, tm, td))
    assert got_r.shape == got_t.shape == (4, 6, 3)
    np.testing.assert_allclose(got_t, want_t, rtol=1e-3)
    np.testing.assert_allclose(got_r, want_r, atol=1e-3)
    two = tpose.estimate_pose_single_markers_two(torch.from_numpy(corners), 0.55, tm, td)
    np.testing.assert_array_equal(got_r, two[0].numpy())
    np.testing.assert_array_equal(got_t, two[1].numpy())
    for i, c in enumerate(corners[0]):
        r, t = tpose.solve_pnp_planar(tpose.marker_object_points(0.55), torch.from_numpy(c), tm, td)
        assert r.shape == t.shape == (3,)
        np.testing.assert_allclose(t.numpy(), want_t[0, i], rtol=1e-3)
        np.testing.assert_allclose(r.numpy(), want_r[0, i], atol=1e-3)


@pytest.mark.parametrize("t_sel", [256, 6], ids=["budget", "overflow"])
def test_select_tiles_per_frame_matches_jax(t_sel):
    """The per-frame ``select_tiles`` on seeded 4K proposals: sel and covered
    identical to JAX's, also when the budget overflows."""
    h, w = 2160, 3840
    p = jdet.DetectorParams()
    groups = tuple(jdet._patch_groups(h, w, p))
    k = groups[-1][1]
    rng = np.random.default_rng(6)
    centers = np.stack([rng.random(k) * h, rng.random(k) * w], -1).astype(np.float32)
    valid = rng.random(k) < 0.3
    kw = dict(h=h, w=w, th=40, tw=256, groups=groups, t_sel=t_sel, per_scale_k=p.per_scale_k)
    sel_j, cov_j = jps.select_tiles(jnp.asarray(centers), jnp.asarray(valid), **kw)
    sel_t, cov_t = tps.select_tiles(torch.from_numpy(centers), torch.from_numpy(valid), **kw)
    assert sel_t.dtype == torch.int32 and sel_t.shape == (t_sel,)
    np.testing.assert_array_equal(sel_t.numpy(), np.asarray(sel_j))
    np.testing.assert_array_equal(cov_t.numpy(), np.asarray(cov_j))
    assert (t_sel == 6) == bool(cov_t.sum() < valid.sum())


TRACK_HW, TRACK_C = (128, 160), 8


def _frame_det(rng, boxes, cap=8):
    """tests/test_tracker.py's detections: full-box masks, seeded distinct scores."""
    det = {"boxes": np.zeros((cap, 4), np.float32), "scores": np.zeros(cap, np.float32),
           "classes": np.zeros(cap, np.int32), "masks": np.zeros((cap, 28, 28), np.float32),
           "valid": np.zeros(cap, bool)}
    for i, b in enumerate(boxes):
        det["boxes"][i] = b
        det["scores"][i] = rng.uniform(0.5, 1.0)
        det["classes"][i] = i % 2
        det["masks"][i] = 1.0
        det["valid"][i] = True
    return det


def test_tracker_step_matches_jax():
    """``tracker_step`` over 5 frames of tests/test_tracker.py's kind (128x160,
    8 channels of seeded p2 features, 16-d embeddings), with 8 detection slots
    capped at 6: new ids, the same boxes moved, one object more than the cap,
    an empty frame, a new object.  Identical ids, ``valid``, classes and
    ``active`` every frame; boxes, scores and embeddings within 1e-6."""
    jcfg = JTrackerConfig(max_tracks=16, max_detections=6, embedding_dim=16, roi_size=4)
    tcfg = convert.tracker_config(dataclasses.asdict(jcfg))
    params = JAssociationHead(embedding_dim=16).init(jax.random.PRNGKey(0), jnp.zeros((1, TRACK_C, 4, 4)))["params"]
    head = AssociationHead(TRACK_C * 16, 16)
    sd = convert.association_state_dict(flatten(jax.tree_util.tree_map(np.asarray, params)))
    head.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    rng = np.random.default_rng(7)
    feats = rng.normal(size=(TRACK_HW[0] // 4, TRACK_HW[1] // 4, TRACK_C)).astype(np.float32)
    frames = [[[10, 10, 40, 40], [80, 20, 120, 60]], [[12, 11, 42, 41], [82, 21, 122, 61]],
              [[12, 11, 42, 41], [82, 21, 122, 61], [20, 70, 50, 100], [100, 80, 140, 110], [60, 5, 75, 30],
               [130, 40, 155, 70], [5, 100, 25, 125]], [], [[12, 11, 42, 41], [90, 90, 120, 120]]]
    jstate = jstructures.init_track_state(16, 16)
    tstate = tstructures.init_track_state(16, 16, device="cpu")
    step = jax.jit(lambda s, d, f: jtracker.tracker_step(s, d, f, params, jcfg, TRACK_HW))
    for boxes in frames:
        det = _frame_det(rng, boxes)
        jstate, jrecent = step(jstate, {k: jnp.asarray(v) for k, v in det.items()}, jnp.asarray(feats))
        with torch.no_grad():
            tstate, trecent = ttracker.tracker_step(tstate, {k: torch.from_numpy(v) for k, v in det.items()},
                                                    torch.from_numpy(feats), head, tcfg, TRACK_HW)
        for k in ("valid", "ids", "classes"):
            np.testing.assert_array_equal(trecent[k].numpy(), np.asarray(jrecent[k]), err_msg=k)
        for k in ("boxes", "scores", "embeddings"):
            np.testing.assert_allclose(trecent[k].numpy(), np.asarray(jrecent[k]), rtol=0, atol=1e-6, err_msg=k)
        np.testing.assert_array_equal(tstate["active"].numpy(), np.asarray(jstate["active"]))
    assert int(tstate["next_id"]) == int(jstate["next_id"]) > 7


@pytest.mark.parametrize("res,ratio", [(7, 1), (14, 2)])
def test_fpn_roi_align_dense_matches_jax(res, ratio):
    """``fpn_roi_align_dense`` as tests/test_dcnn_ops.py:197-222 runs it: 16
    channels on a 64x96 p2, boxes of every FPN level plus a degenerate one and
    one past the edge, against JAX's dense oracle per image within 1e-5 of
    the maps' max-abs (the same bf16 rows; the float32 sums differ in order),
    and against the port's flat ``fpn_roi_align`` within 3e-5 (the JAX
    test's bound)."""
    rng = np.random.default_rng(11)
    feats = {name: rng.normal(size=(2, 64 >> i, 96 >> i, 16)).astype(np.float32)
             for i, name in enumerate(("p2", "p3", "p4", "p5"))}
    boxes = np.asarray([[10.0, 12.0, 30.0, 32.0], [5.0, 5.0, 95.0, 90.0], [0.0, 0.0, 250.0, 250.0],
                        [-20.0, -20.0, 500.0, 480.0], [40.0, 40.0, 40.0, 40.0], [350.0, 200.0, 420.0, 260.0]],
                       np.float32)
    boxes = np.stack([boxes, boxes[::-1] + 3.0])
    tfeats = {k: torch.from_numpy(v) for k, v in feats.items()}
    got = trh.fpn_roi_align_dense(tfeats, torch.from_numpy(boxes), res, ratio)
    assert got.shape == (2, 6, 16, res, res) and got.dtype == torch.float32
    scale = max(np.abs(v).max() for v in feats.values())
    for b in range(2):
        want = jrh.fpn_roi_align_dense({k: jnp.asarray(v[b]) for k, v in feats.items()}, jnp.asarray(boxes[b]),
                                       res, ratio)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want), rtol=0, atol=1e-5 * scale)
    flat = trh.fpn_roi_align(tfeats, torch.from_numpy(boxes), res, ratio)
    np.testing.assert_allclose(got.numpy(), flat.numpy(), rtol=0, atol=3e-5)


def test_batch_sharding_matches_jax_rows():
    """``batch_sharding`` over 4 devices gives each device the rows JAX's
    ``NamedSharding(mesh, P("data"))`` gives it on a 4-device CPU mesh;
    ``shard_batch`` applies it; a batch that is not a multiple raises."""
    jsh = jmesh.batch_sharding(jmesh.data_mesh(4))
    want = jsh.devices_indices_map((8, 3))
    rows = tmesh.batch_sharding([torch.device("cpu")] * 4, 8)
    assert [r for _, r in rows] == [want[d][0] for d in jmesh.data_mesh(4).devices.tolist()]
    parts = tmesh.shard_batch([torch.device("cpu")] * 4, np.arange(8))
    assert [p.tolist() for p in parts] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    with pytest.raises(ValueError, match="multiple"):
        tmesh.batch_sharding([torch.device("cpu")] * 3, 8)


@pytest.mark.slow
@pytest.mark.parametrize("altitude", [40.0, 65.0])
def test_operating_point_corners_against_truth(altitude):
    """One 4K scene (yaw 30, chip_smoke.py phase 21's layout) at 40 and 65 m,
    each package rendering it with its own ``SceneRenderer`` (supersample 2)
    and measuring it with its two-pass pipeline on the CPU (JAX:
    ``use_pallas_preproc=False``): ids 1-4 measured and LEDs 0b10110010 in
    both; the port's mean corner error against the projected world corners
    within the JAX package's plus 0.1 px, and its worst corner within phase
    21's 1.5 px.

    Measured (mean, worst px): 40 m JAX 0.2880, 0.5862, the port 0.2880,
    0.5862; 65 m JAX 0.3441, 0.5926, the port 0.3589, 0.7589.  At 65 m one
    corner of marker 3 lands 0.76 px from the truth in the port and 0.40 px
    in JAX, also when the port reads JAX's frame: the two grays differ by a
    few levels on a few pixels (ROADMAP.md section 3) and the corner
    refinement is not continuous in its input, so a single corner may move
    by tenths of a pixel either way (the card's run of the same scene:
    worst 0.5926 px)."""
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from apse_uav_tpu.aruco.pipeline import ArucoPipeline as JPipeline, ArucoPipelineConfig as JConfig
    from apse_uav_tpu.aruco.pipeline import init_carry as jinit
    from apse_uav_tpu.utils import synthetic as js
    from apse_uav_torch.aruco.pipeline import ArucoPipeline, ArucoPipelineConfig, init_carry
    from apse_uav_torch.utils import synthetic as ts

    w, h = 3840, 2160
    mtx, dist = jcam.load_camera_params(os.path.join(REPO, "data", "cam_params.json"))
    specs = cs.op_specs(30.0)
    jspecs = [js.MarkerSpec(s.marker_id, s.center_xy, s.yaw_deg, s.roof_halfsize, s.leds) for s in specs]
    jimg = js.SceneRenderer(mtx, dist, (w, h), altitude=altitude, supersample=2, cache=False).render(jspecs)
    jcfg = JConfig(use_pallas_preproc=False)
    jpipe = JPipeline(mtx, dist, (w, h), jcfg)
    _, jout = jpipe.scan(jinit(jcfg), jpipe.front(jnp.asarray(np.transpose(jimg, (2, 0, 1))[None])),
                         jnp.ones(1, bool), jnp.zeros((1, 17), jnp.int32))
    del jimg
    want = cs.score_scene({k: np.asarray(v) for k, v in jout.items()}, specs, mtx, altitude)
    trenderer = ts.SceneRenderer(mtx, dist, (w, h), altitude=altitude, supersample=2, cache=False, device="cpu")
    timg = trenderer.render(specs)
    cfg = ArucoPipelineConfig()
    _, tout = ArucoPipeline(mtx, dist, (w, h), cfg, device="cpu").process(timg.permute(2, 0, 1)[None].contiguous(),
                                                                          init_carry(cfg, "cpu"), first=True)
    got = cs.score_scene({k: v.numpy() for k, v in tout.items()}, specs, mtx, altitude)
    for s in (want, got):
        assert all(s["present"]) and s["leds"] == cs.OP_LEDS, s
    assert got["corner_mean_px"] <= want["corner_mean_px"] + 0.1, (got, want)
    assert got["corner_worst_px"] <= cs.OP_WORST_PX, (got, want)
