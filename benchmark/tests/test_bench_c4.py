"""The C4 cell (``c4-r101-b4``, ``drivers/tracker_c4.py``) at a size the CPU
holds: the measured package against the plain C4 reference comes out
correct; each planted fault comes out not correct; a traced run reports the
res5 counter's metric and leaves the device-trace ones out (no kernels on
the CPU).  The control (TF32 on) means something only on the card.

The cut: 320x192 frames, the traffic cut of ``bench_small``, R-26-C4 (one
bottleneck a stage, res5's widths as published) on 64x128 inputs, 200
boxes before the RPN's NMS, 32 after, 16 detection slots."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from bench_small import small_cell
from benchkit.context import RunContext

CELL = "c4-r101-b4"


def small_c4_cell():
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


def run_c4(program: str = "port", break_program=None, trace: bool = False, device=None) -> dict:
    cell, cfg, tr = small_c4_cell()
    ctx = RunContext(cfg, tr, 2 ** 33 + 7, 2.0, trace, device or torch.device("cpu"), time.perf_counter(), program,
                     break_program)
    return cell.driver.run(ctx)


def _values(out) -> dict:
    return {k: v["value"] for k, v in out["checks"].as_dict().items()}


def res5_last_bn_scaled(tracker):
    """res5's last frozen BN scale moved by 1 %."""
    tracker.predictor.model.roi_heads.res5[-1].conv3.norm.weight.mul_(1.01)


def embeddings_from_res3(tracker):
    """The re-ID embeddings read res3 (its first 256 channels) in place of res2."""
    embed = tracker.embed
    tracker.embed = lambda dets, feats: embed(dets, {**feats, "res2": feats["res3"][..., :256]})


def state_unchanged(tracker):
    """The association leaves the track state as it found it."""
    associate = tracker.associate

    def same_state(det, emb):
        state = tracker.state
        recents = associate(det, emb)
        tracker.state = state
        return recents

    tracker.associate = same_state


def test_c4_port_matches_reference():
    out = run_c4()
    assert out["checks"].correct(), _values(out)
    assert all(v == 0 for v in _values(out).values()), _values(out)
    assert out["notes"]["valid_detections_compared"] > 0 and out["notes"]["tracks_compared"] > 0


@pytest.mark.parametrize("fault", [res5_last_bn_scaled, embeddings_from_res3, state_unchanged])
def test_c4_faults_fail(fault):
    out = run_c4(break_program=fault)
    assert not out["checks"].correct(), (fault.__name__, _values(out))


def test_c4_traced_run_reads_the_res5_counter():
    import run
    from benchkit import spec

    out = run_c4(trace=True)
    cell = spec.find_cell(CELL)
    line = run.result_line(cell, out, {"platform": "cpu"}, True)
    metrics = line["metrics"]
    assert line["correct"]
    assert {"track.upload_ms", "track.backbone_ms", "track.heads_ms", "track.assoc_ms", "track.mfu",
            "c4.res5_rois_per_frame"} <= set(metrics)
    assert "c4.res5_ms" not in metrics and "c4.res5_mfu" not in metrics  # device time: none on the CPU
    assert metrics["c4.res5_rois_per_frame"]["value"] == 32 + 16


@pytest.mark.cuda
def test_c4_control_fails_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("the tracker's control is TF32, which only the card has")
    out = run_c4(program="control", device=torch.device("cuda", 0))
    assert not out["checks"].correct(), _values(out)
