"""PyTorch port, the slice end to end: the two-pass and the single-pass ArUco
measurement pipeline on the CPU against the JAX pipeline (XLA path), resuming
from a JAX carry, the altitude fallback, and the port's CLI."""

import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apse_uav_tpu.aruco import geometry as jgeo
from apse_uav_tpu.aruco.detector import _proposals_from_pool as jproposals
from apse_uav_tpu.aruco.pipeline import ArucoPipeline as JPipeline, ArucoPipelineConfig as JConfig
from apse_uav_tpu.aruco.pipeline import init_carry as jinit
from apse_uav_tpu.core import camera as jcam
from apse_uav_tpu.preproc import twopass as jtwopass
from apse_uav_tpu.utils.synthetic import MarkerSpec, render_scene
from apse_uav_torch.utils.synthetic import marker_world_corners, project_world_to_undistorted
from apse_uav_torch import convert
from apse_uav_torch.aruco import cuda_proposals, detector as tdet, patch_select
from apse_uav_torch.aruco.pipeline import ArucoPipeline, ArucoPipelineConfig, init_carry

import torch_parity

W, H = 960, 544
ALT = 12.0
LEDS = 0b10110010


@pytest.fixture(scope="module")
def cam():
    mtx, dist = jcam.load_camera_params(os.path.join(os.path.dirname(__file__), "..", "data", "cam_params.json"))
    ms = mtx.copy()
    ms[0] *= W / 3840.0
    ms[1] *= H / 2160.0
    return ms, dist


def sequence_specs(t: int) -> list:
    """Frame t of the 5-frame sequence of test_aruco_pipeline (moving markers, LEDs)."""
    return [
        MarkerSpec(4, (0.0 + 0.05 * t, 0.5), 5, leds=LEDS),
        MarkerSpec(1, (-4.0 + 0.1 * t, -2.0), 30),
        MarkerSpec(2, (4.0, 1.5 - 0.1 * t), -20),
        MarkerSpec(3, (1.5, -2.5), 90),
    ]


@pytest.fixture(scope="module")
def sequence(cam):
    """The 5-frame sequence, rendered by the JAX package's ``render_scene``."""
    ms, dist = cam
    frames = [render_scene(ms, dist, (W, H), sequence_specs(t), altitude=ALT) for t in range(5)]
    return np.ascontiguousarray(np.stack(frames).transpose(0, 3, 1, 2))


@pytest.fixture(scope="module")
def jax_run(cam, sequence):
    ms, dist = cam
    cfg = JConfig(use_pallas_preproc=False)
    pipe = JPipeline(ms, dist, (W, H), cfg)
    front = pipe.front(jnp.asarray(sequence))
    firsts = jnp.zeros(5, bool).at[0].set(True)
    _, out = pipe.scan(jinit(cfg), front, firsts, jnp.zeros((5, 17), jnp.int32))
    return pipe, front, {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def port_run(cam, sequence):
    ms, dist = cam
    cfg = ArucoPipelineConfig()
    pipe = ArucoPipeline(ms, dist, (W, H), cfg, device="cpu")
    front = pipe.front(torch.from_numpy(sequence))
    _, out = pipe.scan(init_carry(cfg, "cpu"), front, [True, False, False, False, False])
    return pipe, {k: v.numpy() for k, v in out.items()}, front["gray"].numpy()


def test_slice_matches_jax(jax_run, port_run):
    """Port on the CPU against the JAX pipeline (use_pallas_preproc=False),
    end to end, each package on its own gray.

    Exact: detected, measured and the LED value of every frame.  Markers 1,
    3 and 4: corners within 0.05 px, and vehicles 1 and 3's distance columns
    within 1 cm (measured: 1.2e-3 px, 1e-5 m).  Marker 2 (vehicle 2) reads a
    different gray: the two grays differ on ~3e-5 of the pixels by a few
    levels (test_torch_preproc), and the reference itself moves marker 2's
    corners by more than a pixel when fed the port's gray (next test).  Its
    corners are pinned within 3 px and its distance columns within 5 cm
    (measured: 2.8 px, 3.8 cm).  On one and the same gray every marker is
    held to 0.05 px and 1 cm (test_slice_on_reference_gray).
    """
    _, _, want = jax_run
    _, got, _ = port_run
    for key in ("detected", "measured", "leds"):
        assert np.array_equal(got[key], want[key]), key
    assert (got["leds"] == LEDS).all() and got["measured"].all()
    corner_err = np.abs(got["corners"] - want["corners"]).max(axis=(2, 3))  # (T, 4): ids 1-4
    assert corner_err[:, [0, 2, 3]].max() <= 0.05 and corner_err[:, 1].max() <= 3.0, corner_err
    for key in ("dist_aruco", "dist_aruco_bbox"):
        err = np.abs(got[key] - want[key])  # (T, 3): vehicles 1-3
        assert err[:, [0, 2]].max() <= 0.01 and err[:, 1].max() <= 0.05, (key, err)
    np.testing.assert_allclose(got["altitude"], want["altitude"], atol=1e-3)
    np.testing.assert_allclose(got["marker_length"], want["marker_length"], atol=1e-6)


def test_both_packages_against_ground_truth(cam, jax_run, port_run):
    """Both packages' two-pass runs against the renderer's truth, frame by
    frame: the corners of ids 1-4 against their projected world corners
    (``project_world_to_undistorted(marker_world_corners(spec))``), and
    dist_aruco of vehicles 1-3 against the world distance of their marker
    centres from the host's.

    Measured (px: mean of a frame's 16 corners, worst corner; m: worst
    |error|): the port 0.386 px, 0.720 px and 0.149 m; the JAX package the
    same on markers 1, 3 and 4, but on marker 2 (the known 2.8 px divergence
    between the packages) its corners are 3.37 px off the truth in frame 2,
    where the port's are 0.49 px off (that frame's mean: JAX 0.571 px, the
    port 0.328 px): the port is the closer one.  Bounds: the operating
    point's (chip_smoke.py phase 21), 0.5 px mean and 1.5 px worst, for the
    port on every marker and for JAX on markers 1, 3 and 4; JAX's marker 2 is
    held to 3.5 px; distances within 0.2 m for both (the reference's marker
    length correction shortens them by 0.08-0.16 m here)."""
    ms, _ = cam
    _, _, want = jax_run
    _, got, _ = port_run
    worst_m2 = {}
    for name, out in (("port", got), ("jax", want)):
        for t in range(len(out["corners"])):
            specs = {s.marker_id: s for s in sequence_specs(t)}
            truth = np.stack([project_world_to_undistorted(marker_world_corners(specs[m]), ms, ALT)
                              for m in range(1, 5)])
            err = np.linalg.norm(out["corners"][t] - truth, axis=-1)  # (ids 1-4, 4 corners)
            others = err[[0, 2, 3]] if name == "jax" else err
            assert others.mean() <= 0.5 and others.max() <= 1.5, (name, t, err)
            assert err[1].max() <= 3.5, (name, t, err)
            worst_m2[name] = max(worst_m2.get(name, 0.0), float(err[1].max()))
            host = np.asarray(specs[4].center_xy)
            true_d = np.array([np.linalg.norm(np.asarray(specs[v].center_xy) - host) for v in (1, 2, 3)])
            assert np.abs(out["dist_aruco"][t] - true_d).max() <= 0.2, (name, t, out["dist_aruco"][t], true_d)
    assert worst_m2["port"] < worst_m2["jax"], worst_m2


def test_single_pass_matches_jax(cam, sequence):
    """ArucoPipeline(two_pass=False) on the CPU (full-resolution gray, then
    ArucoDetector) against the JAX pipeline with use_pallas_preproc=False,
    two_pass=False, end to end, at test_slice_matches_jax's tolerances and for
    the same reason (marker 2 reads a gray a few levels apart on ~4e-5 of the
    pixels; measured 2.82 px and 3.8 cm on it, at most 1.2e-3 px and 1e-5 m
    on the others)."""
    ms, dist = cam
    jcfg = JConfig(use_pallas_preproc=False, two_pass=False)
    jpipe = JPipeline(ms, dist, (W, H), jcfg)
    firsts = jnp.zeros(5, bool).at[0].set(True)
    _, want = jpipe.scan(jinit(jcfg), jpipe.front(jnp.asarray(sequence)), firsts, jnp.zeros((5, 17), jnp.int32))
    want = {k: np.asarray(v) for k, v in want.items()}
    cfg = ArucoPipelineConfig(two_pass=False)
    pipe = ArucoPipeline(ms, dist, (W, H), cfg, device="cpu")
    assert not hasattr(pipe, "map_pooled")
    _, got = pipe.process(torch.from_numpy(sequence), init_carry(cfg, "cpu"), first=True)
    got = {k: v.numpy() for k, v in got.items()}
    for key in ("detected", "measured", "leds"):
        assert np.array_equal(got[key], want[key]), key
    assert (got["leds"] == LEDS).all() and got["measured"].all()
    corner_err = np.abs(got["corners"] - want["corners"]).max(axis=(2, 3))  # (T, 4): ids 1-4
    assert corner_err[:, [0, 2, 3]].max() <= 0.05 and corner_err[:, 1].max() <= 3.0, corner_err
    for key in ("dist_aruco", "dist_aruco_bbox"):
        err = np.abs(got[key] - want[key])  # (T, 3): vehicles 1-3
        assert err[:, [0, 2]].max() <= 0.01 and err[:, 1].max() <= 0.05, (key, err)
    np.testing.assert_allclose(got["altitude"], want["altitude"], atol=1e-3)


def test_slice_on_reference_gray(cam, sequence, jax_run):
    """The port's stages after the gray -- proposals, tile selection, the
    candidate stage with K1's plain version, pose and the scan -- run on the
    JAX front's own pooled and full-resolution gray, against the JAX run.

    * Proposals: the same valid set per scale, scores within 5e-4.
    * detected, measured and LEDs equal in every frame.
    * Corners of all four markers in every frame within 0.05 px of the
      reference's: directly, or once the port restarts its refinement from
      the reference's own coarse corners, which the port's match within
      1e-4 px (the refinement is not continuous in its start,
      test_torch_detector.py::test_reference_refinement_moves_with_its_start).
    * Distance columns of all three vehicles within 1 cm of the reference's
      pose and scan run on the port's detections, and within 1 cm of the
      reference's own run wherever the vehicle's and the host's corners
      matched directly.
    """
    ms, dist = cam
    jpipe, jfront, want = jax_run
    st = jpipe.detector.params.proposal_stride

    @jax.jit
    def reference_pool_and_proposals(frames):
        pooled_src = jtwopass.pool_source_u8(frames, st, jpipe._pooled_hw)
        _, pooled_gray = jpipe.pre_pooled(jnp.transpose(pooled_src, (0, 2, 3, 1)))
        pool = pooled_gray[:, : H // st, : W // st].astype(jnp.float32)
        return pool, jax.vmap(lambda a: jproposals(a, H, W, jpipe.detector.params))(pool)

    jpool, jprops = reference_pool_and_proposals(jnp.asarray(sequence))
    jpool, jprops = np.asarray(jpool), [np.asarray(x) for x in jprops]
    gray = np.asarray(jfront["gray"])

    pipe = ArucoPipeline(ms, dist, (W, H), ArucoPipelineConfig(), device="cpu")
    p = pipe.params
    props = cuda_proposals.proposals_from_pool(torch.from_numpy(jpool), H, W, p)
    k = p.per_scale_k
    for t in range(len(sequence)):
        for a in range(0, jprops[0].shape[1], k):
            def cand(c, s, v, ok):
                return {(float(cc[0]), float(cc[1]), float(ss)): float(vv)
                        for cc, ss, vv, o in zip(c[t, a:a + k], s[t, a:a + k], v[t, a:a + k], ok[t, a:a + k]) if o}

            ours, theirs = cand(*(np.asarray(x) for x in props)), cand(*jprops)
            assert set(ours) == set(theirs), (t, a // k)
            assert all(abs(ours[key] - theirs[key]) <= 5e-4 for key in ours)
    centers, sizes, scores, valid = props
    _, covered = patch_select.select_tiles_batched(
        centers, valid, h=H, w=W, th=pipe._sel_th, tw=pipe._sel_tw, groups=pipe._groups,
        t_sel=pipe.cfg.sel_tile_budget, per_scale_k=k)
    g = torch.from_numpy(gray.copy())
    corners, ids = tdet.candidates(g, centers, sizes, scores, valid, p, covered)
    front = pipe._front_from_detections(g, corners, ids)
    firsts = [True] + [False] * (len(sequence) - 1)
    _, got = pipe.scan(init_carry(pipe.cfg, "cpu"), front, firsts)
    got = {key: v.numpy() for key, v in got.items()}
    for key in ("detected", "measured", "leds"):
        assert np.array_equal(got[key], want[key]), key
    assert got["measured"].all()

    direct = np.zeros((len(sequence), 4), bool)
    for t in range(len(sequence)):
        for m in range(4):
            slot = int(np.flatnonzero(ids[t].numpy() == m + 1)[0])
            err = torch_parity.corner_errors(gray[t], centers[t, slot].numpy(), float(sizes[t, slot]), slot,
                                             got["corners"][t, m], want["corners"][t, m])
            assert err["replay"] <= 1e-3 and err["coarse"] <= 1e-4, (t, m, err)
            assert min(err["direct"], err["restarted"]) <= 0.05, (t, m, err)
            direct[t, m] = err["direct"] <= 0.05

    jfront_port = jax.jit(jpipe._front_from_detections)(jnp.asarray(gray), jnp.asarray(corners.numpy()),
                                                        jnp.asarray(ids.numpy()))
    _, same = jpipe.scan(jinit(jpipe.cfg), jfront_port, jnp.asarray(firsts), jnp.zeros((len(sequence), 17), jnp.int32))
    for key in ("dist_aruco", "dist_aruco_bbox"):
        assert np.abs(got[key] - np.asarray(same[key])).max() <= 0.01, key
        both = direct[:, :3] & direct[:, 3:]
        assert np.abs(got[key] - want[key])[both].max() <= 0.01, key
    assert direct.sum() >= 3 * len(sequence)


def test_reference_moves_marker_2_under_one_gray_level(jax_run, port_run):
    """Evidence for the corner tolerance above: the JAX detector itself,
    fed the port's gray instead of its own (they differ on ~3e-5 of the
    pixels, by a few levels, see test_torch_preproc), moves marker 2's
    corners by more than a pixel while the other markers stay within
    0.05 px."""
    from apse_uav_tpu.aruco.detector import ArucoDetector
    from apse_uav_tpu.aruco.pipeline import _slot_by_id

    detector = ArucoDetector()

    @jax.jit
    def slots(gray):  # one trace and compile for both grays
        corners, ids = detector.detect(gray)
        return jax.vmap(_slot_by_id)(ids, corners)[1]

    own = np.asarray(slots(jnp.asarray(jax_run[1]["gray"])))
    fed = np.asarray(slots(jnp.asarray(port_run[2])))
    err = np.abs(own - fed).max(axis=(2, 3))  # (T, 4)
    assert err[:, 1].max() > 1.0, err
    assert err[:, [0, 2, 3]].max() <= 0.05, err


def _port_front_from_jax(front: dict) -> dict:
    return {k: torch.as_tensor(np.asarray(v)) for k, v in front.items()}


def test_resume_from_jax_carry(jax_run, port_run):
    """Frames 0-2 scanned in JAX; its carry crosses to the port through
    convert.carry_to_torch, and the port scans frames 3-4 from it on the JAX
    front's detections.  Outputs and the final carry match the JAX scan of
    the same frames to float32 rounding."""
    jpipe, front, _ = jax_run
    ppipe = port_run[0]
    firsts = jnp.asarray([True, False, False])
    carry3, _ = jpipe.scan(jinit(jpipe.cfg), {k: v[:3] for k, v in front.items()}, firsts,
                           jnp.zeros((3, 17), jnp.int32))
    carry5, want = jpipe.scan(carry3, {k: v[3:] for k, v in front.items()}, jnp.zeros(2, bool),
                              jnp.zeros((2, 17), jnp.int32))
    carry3_np = {k: np.asarray(v) for k, v in carry3.items()}
    tail = _port_front_from_jax({k: v[3:] for k, v in front.items()})
    carry, got = ppipe.scan(convert.carry_to_torch(carry3_np, "cpu"), tail, [False, False])
    for key in ("detected", "measured", "leds"):
        assert np.array_equal(got[key].numpy(), np.asarray(want[key])), key
    for key in ("dist_aruco", "dist_aruco_bbox", "altitude", "marker_length", "fov_w", "fov_h"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-5, atol=1e-5)
    back = convert.carry_to_numpy(carry)
    assert set(back) == set(carry5)
    for key, val in carry5.items():
        assert back[key].dtype == np.asarray(val).dtype, key
        np.testing.assert_allclose(back[key], np.asarray(val), rtol=1e-5, atol=1e-5)


def test_altitude_fallback_on_host_gate_failure(cam, jax_run):
    """test_aruco_pipeline's altitude-fallback front: a host that jumps past
    DIFF_MAX still triggers the fallback, altitude follows vehicle 1, and it
    holds when nothing is detected -- the same values as the JAX scan."""
    ms, dist = cam
    jpipe = jax_run[0]
    t = 3
    present = np.zeros((t, 4), bool)
    cx = np.zeros((t, 4), np.float32)
    cy = np.zeros((t, 4), np.float32)
    utv = np.zeros((t, 4, 3), np.float32)
    present[0, 3] = True
    cx[0, 3] = cy[0, 3] = 100.0
    utv[0, 3, 2] = 20.0
    present[1, 3] = True
    cx[1, 3] = cy[1, 3] = 600.0
    utv[1, 3, 2] = 20.0
    present[1, 0] = True
    cx[1, 0] = cy[1, 0] = 300.0
    utv[1, 0, 2] = 30.0
    rv = np.zeros((t, 4, 3), np.float32)
    rv[..., 0] = 1e-3
    front = {
        "present": present, "corners": np.zeros((t, 4, 4, 2), np.float32), "rvec": rv, "utvec": utv,
        "rvec2": rv, "utvec2": utv, "perr": np.ones((t, 4), np.float32), "perr2": np.ones((t, 4), np.float32),
        "pswap": np.zeros((t, 4), bool), "cx": cx, "cy": cy, "msp": np.full((t, 4), 50.0, np.float32),
        "gray": np.zeros((t, H, W), np.uint8),
    }
    firsts = [True, False, False]
    pipe = ArucoPipeline(ms, dist, (W, H), ArucoPipelineConfig(), device="cpu")
    _, out = pipe.scan(init_carry(pipe.cfg, "cpu"), _port_front_from_jax(front), firsts)
    alt = out["altitude"].numpy()
    ml = out["marker_length"].numpy()
    l0 = jgeo.MARKER_LENGTH_ORG
    assert abs(alt[0] - 20.0 * l0 / jgeo.MARKER_DIV) < 1e-3
    l1 = float(jgeo.marker_length_correction(20.0 * l0))
    alt1 = 30.0 * l1 / jgeo.MARKER_DIV
    assert abs(alt[1] - alt1) < 1e-3
    l2 = float(jgeo.marker_length_correction(30.0 * l1))
    assert abs(ml[1] - l2) < 1e-6
    assert alt[2] == alt[1] and ml[2] == ml[1]  # nothing detected: stale hold
    _, want = jpipe.scan(jinit(jpipe.cfg), {k: jnp.asarray(v) for k, v in front.items()}, jnp.asarray(firsts),
                         jnp.zeros((t, 17), jnp.int32))
    np.testing.assert_allclose(alt, np.asarray(want["altitude"]), rtol=1e-6)
    np.testing.assert_allclose(ml, np.asarray(want["marker_length"]), rtol=1e-6)
    assert np.array_equal(out["detected"].numpy(), np.asarray(want["detected"]))


_PRESENCE = [[bool(p >> v & 1) for v in range(3)] + [False] for p in range(8)] + [[False, False, False, True]]


@pytest.mark.parametrize("present", _PRESENCE,
                         ids=["veh" + "".join("1" if b else "0" for b in p[:3]) for p in _PRESENCE[:8]] + ["host_only"])
def test_fallback_altitude_gather_matches_the_index(present):
    """The scan's fallback altitude, a gather, picks the element that the
    index by a device scalar picked: the z of the last present vehicle
    among 1-3, else the host's (slot 3), for every presence of vehicles
    1-3 and for the host alone."""
    from apse_uav_torch.aruco.pipeline import _fallback_altitude

    tvec = torch.arange(12, dtype=torch.float32).reshape(4, 3) * 1.5 + 0.25
    present = torch.tensor(present)
    any_veh = present[:3].any()
    fb_idx = torch.where(any_veh, 2 - torch.argmax(torch.flip(present[:3], (0,)).to(torch.int32)), torch.tensor(3))
    want = tvec[fb_idx, 2]
    got, got_any = _fallback_altitude(tvec, present, torch.tensor([3]))
    assert got.shape == want.shape == () and torch.equal(got, want) and bool(got_any) == bool(any_veh)
    last = max((v for v in range(3) if present[v]), default=3)
    assert got == tvec[last, 2]


@pytest.mark.parametrize("save_images", [False, True], ids=["csv", "images"])
def test_cli_smoke(cam, sequence, port_run, tmp_path, save_images):
    """The port's CLI on the CPU writes the reference's 16-column CSV with
    the pipeline's detections and, with --save_images, one annotated PNG per
    frame (the JAX CLI's annotation)."""
    from apse_uav_torch.cli.aruco_detect import main

    ms, dist = cam
    img_dir = tmp_path / "frames"
    img_dir.mkdir()
    for t, f in enumerate(sequence):
        cv2.imwrite(str(img_dir / ("image_%04d.png" % (t + 1))), np.ascontiguousarray(f.transpose(1, 2, 0)))
    cam_path = tmp_path / "cam.json"
    cam_path.write_text(json.dumps({"mtx": ms.tolist(), "dist": dist.reshape(-1, 1).tolist()}))
    out_csv = tmp_path / "out.csv"
    out_img = tmp_path / "annotated"
    rc = main([
        "--path_camera_params", str(cam_path), "--use_images", "--path_input_images", str(img_dir),
        "--save_results", "--path_output_results", str(out_csv), "--width", str(W), "--height", str(H),
        "--batch", "3", "--device", "cpu",
        *(["--save_images", "--path_output_images", str(out_img)] if save_images else []),
    ])
    assert rc == 0
    if save_images:
        for t, f in enumerate(sequence):
            img = cv2.imread(str(out_img / ("image_%04d.png" % (t + 1))))
            assert img.shape == (H, W, 3)
            drawn = (img != f.transpose(1, 2, 0)).any(axis=-1)
            assert drawn.mean() > 1e-3  # quads, labels and distance lines
            green = (img[..., 0] == 0) & (img[..., 1] == 255) & (img[..., 2] == 0)
            assert green.sum() > 100  # the detected quads' outlines
    else:
        assert not out_img.exists()
    lines = out_csv.read_text().strip().split("\n")
    assert lines[0].startswith("frame_ID ,ID_4_detected ,markerLength")
    assert len(lines) == 1 + len(sequence)
    rows = [ln.split(",") for ln in lines[1:]]
    assert all(len(r) == 16 for r in rows)
    det = port_run[1]["detected"]
    for t, r in enumerate(rows):
        assert r[0] == str(t + 1) and [r[1], r[7], r[10], r[13]] == [str(v) for v in det[t][[3, 0, 1, 2]]]
        assert int(r[3]) == LEDS
