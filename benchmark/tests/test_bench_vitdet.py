"""The ViTDet cell (``vitdet-b-b4``, ``drivers/tracker_vitdet.py``) at a
size the CPU holds: the measured package against the plain ViTDet
reference comes out correct; each planted fault comes out not correct; a
traced run reports the attention counter and leaves the device-trace
readings out (no kernels on the CPU); a program without ViTDet fails before
any frame.  The control (TF32 on) means something only on the card.  The
cell's scene is gray (R = G = B), so it cannot see the channel order: the
port's CPU tests (``tests/test_torch_vitdet_tracker.py``) hold that.

The cut: 320x192 frames, the traffic cut of ``bench_small``, a ViT of one
period of the layer pattern (window, window, global) with 3 heads of the
published 64 channels, on 256x256 squares (16 x 16 tokens, 14 x 14 windows
padded to 28), 100 boxes before the RPN's NMS, 32 after, 16 detection
slots; the pyramid and heads at their published widths."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from bench_small import small_cell
from benchkit import spec, weights_vitdet, yardstick_vitdet
from benchkit.context import RunContext

CELL = "vitdet-b-b4"


def small_vitdet_cell():
    cell, cfg, tr = small_cell(CELL)
    s = 320 / cfg["frame_wh"][0]
    mtx = np.array(cell.config["camera"]["mtx"])
    mtx[:2] *= s
    cfg["camera"]["mtx"], cfg["frame_wh"] = mtx.tolist(), [320, 192]
    m = cfg["model"]
    m["vit"].update(embed_dim=192, num_heads=3, depth=3, window_block_indexes=[0, 1], img_size=256)
    m["input"].update(min_size_test=256, max_size_test=256, square_size=256)
    m["rpn"]["pre_nms_topk_test"], m["rpn"]["post_nms_topk_test"] = 100, 32
    m["roi"]["detections_per_image"] = 16
    return cell, cfg, tr


def run_vitdet(program: str = "port", break_program=None, trace: bool = False, device=None) -> dict:
    cell, cfg, tr = small_vitdet_cell()
    ctx = RunContext(cfg, tr, 2 ** 33 + 9, 2.0, trace, device or torch.device("cpu"), time.perf_counter(), program,
                     break_program)
    return cell.driver.run(ctx)


def _values(out) -> dict:
    return {k: v["value"] for k, v in out["checks"].as_dict().items()}


def rel_pos_scaled(tracker):
    """The global block's height table of relative positions scaled by 1 %."""
    tracker.predictor.model.backbone.net.blocks[2].attn.rel_pos_h.mul_(1.01)


def window_scale_moved(tracker):
    """A windowed block's attention scores scaled by 1 % more than d^-0.5."""
    tracker.predictor.model.backbone.net.blocks[0].attn.scale *= 1.01


def pad_before_normalising(tracker):
    """The square pad filled with raw zeros (R-FPN's order), so it reads
    -mean / std once normalised where detectron2's reads 0."""
    tracker.predictor._square_fill.zero_()


def state_unchanged(tracker):
    """The association leaves the track state as it found it."""
    associate = tracker.associate

    def same_state(det, emb):
        state = tracker.state
        recents = associate(det, emb)
        tracker.state = state
        return recents

    tracker.associate = same_state


def test_vitdet_port_matches_reference():
    out = run_vitdet()
    assert out["checks"].correct(), _values(out)
    assert all(v == 0 for v in _values(out).values()), _values(out)
    assert out["notes"]["valid_detections_compared"] > 0 and out["notes"]["tracks_compared"] > 0


@pytest.mark.parametrize("fault", [rel_pos_scaled, window_scale_moved, pad_before_normalising, state_unchanged])
def test_vitdet_faults_fail(fault):
    out = run_vitdet(break_program=fault)
    assert not out["checks"].correct(), (fault.__name__, _values(out))


def test_vitdet_traced_run_reads_the_attention_counter():
    import run

    out = run_vitdet(trace=True)
    cell = spec.find_cell(CELL)
    line = run.result_line(cell, out, {"platform": "cpu"}, True)
    metrics = line["metrics"]
    assert line["correct"]
    assert {"track.upload_ms", "track.backbone_ms", "track.heads_ms", "track.assoc_ms", "track.mfu",
            "vitdet.attn_gflop_per_frame"} <= set(metrics)
    for name in ("vitdet.attn_ms", "vitdet.global_attn_ms", "vitdet.attn_roofline"):
        assert name not in metrics  # device time: none on the CPU
    _, cfg, _ = small_vitdet_cell()
    want = sum(f for f, _, _ in yardstick_vitdet.attention_work(cfg["model"]["vit"], 1)) / 1e9
    assert metrics["vitdet.attn_gflop_per_frame"]["value"] == pytest.approx(want, rel=1e-12)


def test_the_cell_and_its_metrics_are_declared():
    """The cell runs the ViTDet configuration on video16_b4, reports the
    tracker's end-to-end metrics and per-layer metrics, and the four
    vitdet.* metrics read only it."""
    cell = spec.find_cell(CELL)
    assert cell.config["family"] == "tracker_vitdet" and cell.workload["traffic"] == "video16_b4"
    assert cell.chips == 1
    assert {m["name"] for m in cell.end_to_end} == {"setup_s", "track_fps", "track_p95_ms"}
    names = {m["name"] for m in cell.per_layer}
    assert {"track.upload_ms", "track.backbone_ms", "track.heads_ms", "track.assoc_ms", "track.idle_share",
            "track.mfu", "vitdet.attn_ms", "vitdet.global_attn_ms", "vitdet.attn_roofline",
            "vitdet.attn_gflop_per_frame"} == names
    bench = spec.benchmark_json()
    for m in bench["per_layer"]:
        if m["name"].startswith("vitdet."):
            assert m["workloads"] == [CELL] and m["moves"] == "track_fps"


def test_weights_cover_the_model_and_calibrate():
    """The seeded leaves are the measured model's state dict, key for key and
    shape for shape, and the calibration leaves every frame its candidates."""
    from apse_uav_torch.dcnn import config as pconfig
    from apse_uav_torch.dcnn.models.c4 import build_model
    from benchkit.refmodel_vitdet import RefTrackerViTDet, model_config_vitdet

    cell = spec.find_cell(CELL)
    m, t = cell.config["model"], cell.config["tracker"]
    with torch.device("meta"):
        model = build_model(model_config_vitdet(m, pconfig))
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {name: shape for name, shape, _, _ in weights_vitdet.plan(m, 256 * 100, 128)}
    assert {k: v for k, v in got.items() if not k.startswith("assoc.")} == want

    _, cfg, tr = small_vitdet_cell()
    m = cfg["model"]
    cpu = torch.device("cpu")
    ckpt, assoc = weights_vitdet.seeded_weights(5, m, 256 * 100, 128, cpu)
    again, _ = weights_vitdet.seeded_weights(5, m, 256 * 100, 128, cpu)
    assert all(torch.equal(ckpt[k], again[k]) for k in ckpt)
    ref = RefTrackerViTDet(m, cfg["tracker"], ckpt, assoc, (192, 320), cfg["camera"], cpu)
    frames = list(torch.randint(0, 256, (4, 192, 320, 3), generator=torch.Generator().manual_seed(3),
                                dtype=torch.uint8).numpy())
    out = weights_vitdet.calibrate_background(ckpt, ref, frames, 10, 2)
    assert min(out["candidates_per_frame"]) >= 10


def test_a_program_without_vitdet_fails_before_any_frame(monkeypatch):
    """The parent of the ViTDet cell has no ViTConfig: the driver raises at
    once, before the scene is rendered."""
    from apse_uav_torch.dcnn import config as pconfig
    from benchkit import scene

    def no_render(*args, **kwargs):
        raise AssertionError("a frame was rendered")

    monkeypatch.delattr(pconfig, "ViTConfig")
    monkeypatch.setattr(scene, "render_video", no_render)
    with pytest.raises(RuntimeError, match="no ViTConfig"):
        run_vitdet()


@pytest.mark.cuda
def test_vitdet_control_fails_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("the tracker's control is TF32, which only the card has")
    out = run_vitdet(program="control", device=torch.device("cuda", 0))
    assert not out["checks"].correct(), _values(out)
