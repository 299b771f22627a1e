"""PyTorch port, the tracker against the JAX package on the CPU: re-ID
embeddings (the patch-and-matmul ROIAlign), the detection cap, 6-frame
association sequences under every metric and the exact solver,
``paste_mask_lowres``; and the ``track_uav`` CLI on the CPU.

Inputs are made with numpy from fixed seeds and handed to both packages.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apse_uav_tpu.dcnn import structures as jstructures, tracker as jtracker
from apse_uav_tpu.dcnn.config import TrackerConfig as JTrackerConfig
from apse_uav_tpu.dcnn.models.association import AssociationHead as JAssociationHead
from apse_uav_tpu.dcnn.weights import flatten
from apse_uav_torch import convert
from apse_uav_torch.dcnn import structures as tstructures, tracker as ttracker
from apse_uav_torch.dcnn.models.association import AssociationHead

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
IMAGE_HW = (128, 160)
C, E = 8, 16


@pytest.fixture(scope="module")
def heads():
    """One random JAX AssociationHead (4x4 ROIs of C channels) and the port's copy."""
    jhead = JAssociationHead(embedding_dim=E)
    params = jhead.init(jax.random.PRNGKey(0), jnp.zeros((1, C, 4, 4)))["params"]
    thead = AssociationHead(C * 16, E)
    sd = convert.association_state_dict(flatten(jax.tree_util.tree_map(np.asarray, params)))
    thead.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return params, thead.eval()


def _dets(rng, nb, d, n_valid=None, tie_scores=False):
    xy = rng.uniform(-20, 150, (nb, d, 2))
    wh = rng.uniform(2, 120, (nb, d, 2))  # some wider than a 48-texel patch at stride 4
    scores = rng.uniform(0.5, 1, (nb, d))
    if tie_scores:
        scores = np.round(scores * 4) / 4
    valid = rng.uniform(size=(nb, d)) < 0.8 if n_valid is None else np.arange(d)[None, :] < n_valid
    return {"boxes": np.concatenate([xy, xy + wh], -1).astype(np.float32), "scores": scores.astype(np.float32),
            "classes": rng.integers(0, 3, (nb, d)).astype(np.int32),
            "masks": rng.uniform(0, 1, (nb, d, 28, 28)).astype(np.float32), "valid": valid}


@pytest.mark.parametrize("patch", [48, 12])
def test_detection_embeddings_match_jax(heads, patch):
    """Mask-cropped patch ROIAlign + head on a batch of 2 frames: within 1e-5
    of the max-abs (the reference's formulation on each frame; patch 12
    clamps the large boxes' samples to the patch as the reference does)."""
    params, thead = heads
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(2, IMAGE_HW[0] // 4, IMAGE_HW[1] // 4, C)).astype(np.float32)
    det = _dets(rng, 2, 6)
    with torch.no_grad():
        got = ttracker.detection_embeddings(thead, torch.from_numpy(feats), {k: torch.from_numpy(v) for k, v in
                                                                             det.items()}, IMAGE_HW, 4,
                                            patch=patch).numpy()
    for b in range(2):
        want = np.asarray(jtracker.detection_embeddings(params, jnp.asarray(feats[b]),
                                                        {k: jnp.asarray(v[b]) for k, v in det.items()}, IMAGE_HW,
                                                        4, embedding_dim=E, patch=patch))
        np.testing.assert_allclose(got[b], want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_prepare_frame_caps_in_top_k_order(heads):
    """More detections than ``max_detections``, with score ties and invalid
    ones: the same detections, in the same order, and their embeddings."""
    params, thead = heads
    rng = np.random.default_rng(1)
    feats = rng.normal(size=(2, IMAGE_HW[0] // 4, IMAGE_HW[1] // 4, C)).astype(np.float32)
    det = _dets(rng, 2, 9, tie_scores=True)
    jcfg = JTrackerConfig(max_tracks=8, max_detections=5, embedding_dim=E, roi_size=4)
    tcfg = convert.tracker_config(dataclasses.asdict(jcfg))
    with torch.no_grad():
        tdet, temb = ttracker.prepare_frame({k: torch.from_numpy(v) for k, v in det.items()},
                                            torch.from_numpy(feats), thead, tcfg, IMAGE_HW)
    for b in range(2):
        jdet, jemb = jtracker.prepare_frame({k: jnp.asarray(v[b]) for k, v in det.items()}, jnp.asarray(feats[b]),
                                            params, jcfg, IMAGE_HW)
        for k in jdet:
            np.testing.assert_array_equal(tdet[k][b].numpy(), np.asarray(jdet[k]), err_msg=k)
        np.testing.assert_allclose(temb[b].numpy(), np.asarray(jemb), rtol=0, atol=1e-6)


def _sequence(rng, frames=6, d=5):
    """Detections and unit embeddings over a sequence: objects 0-4 in frames
    0-1, then objects 5-9 (small embedding drift, shuffled order), one
    invalid slot a frame after the first."""
    base = rng.normal(size=(10, E))
    seq = []
    for t in range(frames):
        ids = rng.permutation(d) + (0 if t < 2 else d)
        emb = base[ids] + rng.normal(scale=0.05, size=(d, E))
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
        det = {k: v[0] for k, v in _dets(rng, 1, d, n_valid=d).items()}
        det["valid"][t % d] = t == 0
        seq.append((det, emb.astype(np.float32)))
    return seq


def test_tracker_sequence_matches_jax():
    """6 frames of ``tracker_step_assoc`` on the same detections and
    embeddings: identical ids, ``valid`` and ``active`` every frame, float
    fields within 1e-6.  The 6 slots run out when new objects arrive in
    frame 2; the old tracks are deleted after frame 4, and the new objects
    take their slots with new ids in frame 5."""
    jcfg = JTrackerConfig(max_tracks=6, max_detections=5, embedding_dim=E, roi_size=4, delete_after_undetected=1)
    tcfg = convert.tracker_config(dataclasses.asdict(jcfg))
    jstate = jstructures.init_track_state(6, E)
    tstate = tstructures.init_track_state(6, E, device="cpu")
    step = jax.jit(lambda s, det, emb: jtracker.tracker_step_assoc(s, det, emb, jcfg, IMAGE_HW))
    new_ids = 0
    for det, emb in _sequence(np.random.default_rng(2)):
        jstate, jrecent = step(jstate, {k: jnp.asarray(v) for k, v in det.items()}, jnp.asarray(emb))
        tstate, trecent = ttracker.tracker_step_assoc(tstate, {k: torch.from_numpy(v) for k, v in det.items()},
                                                      torch.from_numpy(emb), tcfg, IMAGE_HW)
        for k in ("valid", "ids", "classes"):
            np.testing.assert_array_equal(trecent[k].numpy(), np.asarray(jrecent[k]), err_msg=k)
        for k in ("boxes", "scores", "masks", "embeddings"):
            np.testing.assert_allclose(trecent[k].numpy(), np.asarray(jrecent[k]), rtol=0, atol=1e-6, err_msg=k)
        for k in ("active", "ids", "frames_since_detected", "next_id"):
            np.testing.assert_array_equal(tstate[k].numpy(), np.asarray(jstate[k]), err_msg=k)
        new_ids = int(tstate["next_id"]) - 1
    assert new_ids > 6  # ids beyond the capacity: deleted tracks' slots were reused, ids never


def test_unported_metrics_raise():
    """Every metric of the reference is ported; an unknown one raises
    ValueError, as in the reference."""
    cfg = convert.tracker_config(dataclasses.asdict(JTrackerConfig(association_metric="nearest")))
    state = tstructures.init_track_state(4, 8, device="cpu")
    with pytest.raises(ValueError, match="nearest"):
        ttracker.tracker_step_assoc(state, {}, torch.zeros(1, 8), cfg, IMAGE_HW)


def _moving_sequence(rng, frames=6, d=5):
    """Objects that persist with small box, mask and embedding drift (and two
    that sit close together), in shuffled order; objects 5-9 replace 0-4 from
    frame 2 on; one invalid slot a frame after the first."""
    base_emb = rng.normal(size=(10, E))
    xy = rng.uniform(0, 110, (10, 2))
    xy[1] = xy[0] + 4.0  # two objects whose centres are close
    wh = rng.uniform(12, 40, (10, 2))
    masks = rng.uniform(0, 1, (10, 28, 28))
    seq = []
    for t in range(frames):
        ids = rng.permutation(d) + (0 if t < 2 else d)
        emb = base_emb[ids] + rng.normal(scale=0.05, size=(d, E))
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
        p = xy[ids] + rng.normal(scale=2.0, size=(d, 2))
        det = {"boxes": np.concatenate([p, p + wh[ids]], -1).astype(np.float32),
               "scores": rng.uniform(0.5, 1, d).astype(np.float32),
               "classes": rng.integers(0, 3, d).astype(np.int32),
               "masks": np.clip(masks[ids] + rng.normal(scale=0.1, size=(d, 28, 28)), 0, 1).astype(np.float32),
               "valid": np.ones(d, bool)}
        det["valid"][t % d] = t == 0
        seq.append((det, emb.astype(np.float32)))
    return seq


@pytest.mark.parametrize("metric", ["embeddings", "embeddings_exact", "bbox_center_dist", "mask_iou"])
def test_association_metrics_match_jax(metric):
    """6 frames of association under each metric (and ``exact=True``, the
    Jonker-Volgenant solve of the padded problem) on the same detections and
    embeddings: identical ids, ``valid``, classes and track state every frame,
    float fields within 1e-6.  Thresholds are set so that each metric both
    matches and refuses pairs."""
    jcfg = JTrackerConfig(max_tracks=6, max_detections=5, embedding_dim=E, roi_size=4, delete_after_undetected=1,
                          association_metric=metric.replace("_exact", ""), center_dist_threshold=60.0,
                          mask_iou_threshold=0.5)
    tcfg = convert.tracker_config(dataclasses.asdict(jcfg))
    jstate = jstructures.init_track_state(6, E)
    tstate = tstructures.init_track_state(6, E, device="cpu")
    if metric == "embeddings_exact":
        def jstep(s, det, emb):
            s = jtracker.associate_embeddings(s, det, emb, jcfg.embedding_dist_threshold, exact=True)
            s = jstructures.delete_undetected(s, jcfg.delete_after_undetected)
            return jstructures.finish_association(s), jstructures.recent_objects(s)

        def tstep(s, det, emb):
            s = ttracker.associate_embeddings(s, det, emb, tcfg.embedding_dist_threshold, exact=True)
            s = tstructures.delete_undetected(s, tcfg.delete_after_undetected)
            return tstructures.finish_association(s), tstructures.recent_objects(s)
    else:
        def jstep(s, det, emb):
            return jtracker.tracker_step_assoc(s, det, emb, jcfg, IMAGE_HW)

        def tstep(s, det, emb):
            return ttracker.tracker_step_assoc(s, det, emb, tcfg, IMAGE_HW)
    jstep = jax.jit(jstep)
    matched = 0
    for det, emb in _moving_sequence(np.random.default_rng(5)):
        jstate, jrecent = jstep(jstate, {k: jnp.asarray(v) for k, v in det.items()}, jnp.asarray(emb))
        before = int(tstate["next_id"])
        tstate, trecent = tstep(tstate, {k: torch.from_numpy(v) for k, v in det.items()}, torch.from_numpy(emb))
        matched += int(det["valid"].sum()) - (int(tstate["next_id"]) - before)
        for k in ("valid", "ids", "classes"):
            np.testing.assert_array_equal(trecent[k].numpy(), np.asarray(jrecent[k]), err_msg=k)
        for k in ("boxes", "scores", "masks", "embeddings"):
            np.testing.assert_allclose(trecent[k].numpy(), np.asarray(jrecent[k]), rtol=0, atol=1e-6, err_msg=k)
        for k in ("active", "ids", "frames_since_detected", "next_id"):
            np.testing.assert_array_equal(tstate[k].numpy(), np.asarray(jstate[k]), err_msg=k)
    assert matched > 0


def test_paste_mask_lowres_matches_jax():
    """Masks pasted on a 64x64 grid (boxes partly outside the image, one
    degenerate): identical to the reference, mask by mask."""
    rng = np.random.default_rng(3)
    det = _dets(rng, 1, 8)
    boxes, masks = det["boxes"][0], det["masks"][0]
    boxes[0, 2] = boxes[0, 0]
    got = ttracker.paste_mask_lowres(torch.from_numpy(masks), torch.from_numpy(boxes), (64, 64), IMAGE_HW).numpy()
    for i in range(8):
        want = np.asarray(jtracker.paste_mask_lowres(jnp.asarray(masks[i]), jnp.asarray(boxes[i]), (64, 64),
                                                     IMAGE_HW))
        np.testing.assert_array_equal(got[i], want)


def test_cli_help_and_device_rule():
    """``track_uav --help`` exits 0 (no JAX, no card needed); without a card
    ``--device cuda`` raises instead of falling back."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-m", "apse_uav_torch.cli.track_uav", "--help"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "--device" in res.stdout and "--preprocess" in res.stdout, res.stderr
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the no-fallback rule is exercised on the CPU-only host")
    from apse_uav_torch.cli.track_uav import build_parser, track

    args = build_parser().parse_args(["--images", "unused", "--weights", "unused.pth"])
    with pytest.raises(RuntimeError, match="cuda"):
        track(args, [(0, np.zeros((8, 8, 3), np.uint8))])


def test_cli_bf16_and_assoc_weights_on_cpu(tmp_path):
    """``track_uav --bf16`` and ``--assoc_weights`` (a head saved in the
    port's checkpoint format, and a path with none, which keeps the default
    head) run on the CPU: one CSV row per frame, ids from 1."""
    from apse_uav_torch.cli.track_uav import build_parser, track
    from apse_uav_torch.dcnn.models.association import init_weights
    from apse_uav_torch.train.checkpoint import save_state
    from apse_uav_torch.utils.synthetic import detectron2_checkpoint

    path = str(tmp_path / "w.pth")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in detectron2_checkpoint(3, 50, 4).items()}}, path)
    save_state(str(tmp_path), "head", {"params": init_weights(25600, 128, seed=2)})
    frames = np.random.default_rng(4).integers(0, 255, (2, 48, 64, 3), np.uint8)
    for flags in (["--bf16"], ["--assoc_weights", str(tmp_path / "head")],
                  ["--assoc_weights", str(tmp_path / "none"), "--bf16"]):
        args = build_parser().parse_args(["--images", "x", "--weights", path, "--depth", "50", "--device", "cpu",
                                          "--log_file", str(tmp_path / "dcnn.csv"), "--batch", "2", "--confidence",
                                          "0.0", *flags])
        res = track(args, [(0, frames[0]), (1, frames[1])])
        assert res["frames"] == 2 and res["rows"] == 2 and res["max_obj_id"] >= 1, flags


def test_cli_loop_on_cpu_writes_csv(tmp_path):
    """The CLI's own loop on 2 tiny frames on the CPU (R50, a seeded
    detectron2 checkpoint through ``--weights``, ``--preprocess``): one CSV
    row per frame, ids from 1, the images written."""
    from apse_uav_torch.cli.track_uav import build_parser, track
    from apse_uav_torch.utils.synthetic import detectron2_checkpoint

    path = str(tmp_path / "w.pth")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in detectron2_checkpoint(3, 50, 4).items()}}, path)
    log = tmp_path / "dcnn.csv"
    args = build_parser().parse_args(["--images", "unused", "--weights", path, "--depth", "50", "--device", "cpu",
                                      "--log_file", str(log), "--batch", "1", "--confidence", "0.0",
                                      "--write_images", str(tmp_path / "img"),
                                      "--preprocess", os.path.join(REPO, "data", "cam_params.json")])
    frames = np.random.default_rng(4).integers(0, 255, (2, 48, 64, 3), np.uint8)
    seen = []
    res = track(args, [(10, frames[0]), (11, frames[1])], on_frame=lambda i, r: seen.append((i, r["ids"][r["valid"]])))
    assert res["frames"] == 2 and res["rows"] == 2 and res["max_obj_id"] >= 1
    lines = log.read_text().splitlines()
    assert lines[0] == "Ford id: 4" and lines[1].startswith("frame,id_1 cent_x")
    assert [ln.split(",")[0] for ln in lines[2:]] == ["10", "11"]
    assert [i for i, _ in seen] == [10, 11] and all((ids >= 1).all() for _, ids in seen)
    assert sorted(os.listdir(tmp_path / "img")) == ["image_0010.png", "image_0011.png"]
