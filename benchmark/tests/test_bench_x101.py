"""The X101 cell (``x101fpn-b4``, ``drivers/tracker_x101.py``) at a size the
CPU holds: the measured package against the plain X-FPN reference comes out
correct; each planted fault comes out not correct; a traced run reports
the grouped convolutions' counter and leaves the device-trace ones out (no
kernels on the CPU); a program without the group fields fails before any
frame.  The control (TF32 on) means something only on the card.

The cut: 320x192 frames, the traffic cut of ``bench_small``, X-26-FPN (one
bottleneck a stage, the published 32 groups of 8 and widths) on 64x128
inputs, 200 boxes before the RPN's NMS, 32 after, 16 detection slots."""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import pytest
import torch

from bench_small import small_cell
from benchkit import yardstick_x101
from benchkit.context import RunContext

CELL = "x101fpn-b4"


def small_x101_cell():
    cell, cfg, tr = small_cell(CELL)
    s = 320 / cfg["frame_wh"][0]
    mtx = np.array(cfg["camera"]["mtx"])
    mtx[:2] *= s
    cfg["camera"]["mtx"], cfg["frame_wh"] = mtx.tolist(), [320, 192]
    m = cfg["model"]
    m["depth"] = 26
    m["input"]["min_size_test"], m["input"]["max_size_test"] = 64, 128
    m["rpn"]["pre_nms_topk_test"], m["rpn"]["post_nms_topk_test"] = 200, 32
    m["roi"]["detections_per_image"] = 16
    return cell, cfg, tr


def run_x101(program: str = "port", break_program=None, trace: bool = False, device=None) -> dict:
    cell, cfg, tr = small_x101_cell()
    ctx = RunContext(cfg, tr, 2 ** 33 + 7, 2.0, trace, device or torch.device("cpu"), time.perf_counter(), program,
                     break_program)
    return cell.driver.run(ctx)


def _values(out) -> dict:
    return {k: v["value"] for k, v in out["checks"].as_dict().items()}


def gconv_bn_scaled(tracker):
    """res4's grouped conv2's frozen BN scale moved by 1 %."""
    tracker.predictor.model.backbone.bottom_up.res4[0].conv2.norm.weight.mul_(1.01)


def groups_rolled(tracker):
    """res3's grouped conv2 weights rolled by one group: each group convolves
    its neighbour's kernels."""
    conv2 = tracker.predictor.model.backbone.bottom_up.res3[0].conv2
    conv2.weight.copy_(conv2.weight.roll(conv2.out_channels // conv2.groups, dims=0))


def state_unchanged(tracker):
    """The association leaves the track state as it found it."""
    associate = tracker.associate

    def same_state(det, emb):
        state = tracker.state
        recents = associate(det, emb)
        tracker.state = state
        return recents

    tracker.associate = same_state


def test_x101_port_matches_reference():
    out = run_x101()
    assert out["checks"].correct(), _values(out)
    assert all(v == 0 for v in _values(out).values()), _values(out)
    assert out["notes"]["valid_detections_compared"] > 0 and out["notes"]["tracks_compared"] > 0


@pytest.mark.parametrize("fault", [gconv_bn_scaled, groups_rolled, state_unchanged])
def test_x101_faults_fail(fault):
    out = run_x101(break_program=fault)
    assert not out["checks"].correct(), (fault.__name__, _values(out))


def test_x101_traced_run_reads_the_gconv_counter():
    import run
    from benchkit import spec

    out = run_x101(trace=True)
    cell = spec.find_cell(CELL)
    line = run.result_line(cell, out, {"platform": "cpu"}, True)
    metrics = line["metrics"]
    assert line["correct"]
    assert {"track.upload_ms", "track.backbone_ms", "track.heads_ms", "track.assoc_ms", "track.mfu",
            "x101.gconv_gflop_per_frame"} <= set(metrics)
    assert "x101.gconv_ms" not in metrics and "x101.gconv_roofline" not in metrics  # device time: none on the CPU
    _, cfg, _ = small_x101_cell()
    want = sum(f for f, _ in yardstick_x101.gconv_work(cfg, (64, 128), 1)) / 1e9
    assert metrics["x101.gconv_gflop_per_frame"]["value"] == pytest.approx(want, rel=1e-12)


def test_a_program_without_groups_fails_before_any_frame(monkeypatch):
    """The parent of the X101 cell has no num_groups: the driver raises at
    once, before the scene is rendered."""
    from apse_uav_torch.dcnn import config as pconfig
    from benchkit import scene

    @dataclasses.dataclass(frozen=True)
    class PlainModelConfig:
        depth: int = 50

    def no_render(*args, **kwargs):
        raise AssertionError("a frame was rendered")

    monkeypatch.setattr(pconfig, "ModelConfig", PlainModelConfig)
    monkeypatch.setattr(scene, "render_video", no_render)
    with pytest.raises(RuntimeError, match="no num_groups"):
        run_x101()


@pytest.mark.cuda
def test_x101_control_fails_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("the tracker's control is TF32, which only the card has")
    out = run_x101(program="control", device=torch.device("cuda", 0))
    assert not out["checks"].correct(), _values(out)
