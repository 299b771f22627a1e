"""PyTorch port, the recorder of ``utils/profiling.py`` on the CPU: spans off
(one shared no-op, nothing kept) and on (parents, batch numbers, self
times), their place on ``torch.profiler``'s clock, and the spans and sync
counters that a small tracker batch and a small ArUco call emit, in order.

The tracker is the CPU tests' small one (R50-FPN, 64 short side) on 100x160
frames; the ArUco call one 960x544 frame of the port's renderer.  The card
holds the sync counters to ``set_sync_debug_mode`` in ``test_torch_cuda.py``.
"""

import dataclasses
import os
import statistics
import time

import numpy as np
import pytest
import torch

from apse_uav_torch.core import camera
from apse_uav_torch.utils import profiling

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


@pytest.fixture
def recording():
    """Spans on and counters at zero for the test; spans off after it."""
    profiling.reset_spans()
    profiling.reset_counters()
    profiling.enable_spans(True)
    yield
    profiling.enable_spans(False)
    profiling.reset_spans()


def _tree(recorded) -> list:
    """Each span as (depth, name), in the order the spans opened."""
    depth = []
    for s in recorded:
        depth.append(0 if s.parent < 0 else depth[s.parent] + 1)
    return [(d, s.name) for d, s in zip(depth, recorded)]


def test_spans_off_record_nothing():
    """Off (the default), ``span`` is one shared no-op context and keeps nothing."""
    profiling.reset_spans()
    assert profiling.span("a") is profiling.span("b", batch=3)
    with profiling.span("a"):
        with profiling.sync("site"):
            pass
    assert profiling.spans() == []
    assert profiling.counters.pop("sync.site") >= 1  # counters are always kept


def test_spans_parents_batches_and_self_time(recording):
    """On: each span knows its parent and takes its parent's batch unless
    given one; self time is the duration less the children's, so a tree's
    self times add up to its root; ``summary`` sums by name and counts the
    time under ``sync.*`` spans."""
    with profiling.span("root", batch=7):
        time.sleep(0.002)
        with profiling.span("child"):
            with profiling.sync("wait", 3):
                time.sleep(0.003)
        with profiling.span("child", batch=8):
            time.sleep(0.001)
    with profiling.span("alone"):
        pass
    got = profiling.spans()
    assert [(s.name, s.parent, s.batch) for s in got] == [
        ("root", -1, 7), ("child", 0, 7), ("sync.wait", 1, 7), ("child", 0, 8), ("alone", -1, None)]
    assert all(s.end_ns >= s.start_ns > 0 for s in got)
    own = profiling.self_ns(got)
    assert sum(own[:4]) == got[0].end_ns - got[0].start_ns
    assert own[0] >= 2e6 and own[1] < own[2] and own[2] >= 3e6
    totals = profiling.summary(got)
    assert totals["child"]["n"] == 2 and totals["child"]["ns"] == sum(s.end_ns - s.start_ns for s in got[1:4:2])
    assert totals["root"]["sync_ns"] == totals["child"]["sync_ns"] == got[2].end_ns - got[2].start_ns
    assert totals["sync.wait"]["sync_ns"] == 0
    assert profiling.counters == {"sync.wait": 3}
    with pytest.raises(RuntimeError, match="open"):
        with profiling.span("open"):
            profiling.reset_spans()


def test_spans_on_the_profilers_clock(recording):
    """Under ``torch.profiler`` every span is also a ``record_function``
    event, and its in-memory start and end lie on the profiler's clock
    (``trace_start_ns`` plus the event's microseconds): the event opens just
    before the span's start and closes just after its end, so in the median
    the span lies inside its event to 50 us, however long a loaded host
    takes between the two stamps."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(20):
            with profiling.span(f"test.span{i}"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    origin = prof.profiler.kineto_results.trace_start_ns()
    events = {e.name: e for e in prof.events() if e.name.startswith("test.")}
    got = profiling.spans()
    assert {s.name for s in got} == set(events)
    outside = [max(origin + events[s.name].time_range.start * 1e3 - s.start_ns,
                   s.end_ns - origin - events[s.name].time_range.end * 1e3, 0.0) for s in got]
    assert statistics.median(outside) < 50e3, outside


def _small_tracker():
    """The small tracker of the CPU tests and a ``Preprocessor`` for its frames."""
    from apse_uav_torch.dcnn.config import TrackerConfig, mask_rcnn_r50_fpn
    from apse_uav_torch.dcnn.engines import RcnnTracker
    from apse_uav_torch.dcnn.models.association import init_weights
    from apse_uav_torch.preproc.remap import Preprocessor
    from apse_uav_torch.utils.synthetic import detectron2_checkpoint

    cfg = mask_rcnn_r50_fpn(2)
    cfg = dataclasses.replace(
        cfg, rpn=dataclasses.replace(cfg.rpn, pre_nms_topk_test=32, post_nms_topk_test=16),
        roi=dataclasses.replace(cfg.roi, detections_per_image=4, score_thresh_test=0.0),
        input=dataclasses.replace(cfg.input, min_size_test=64, max_size_test=128))
    tcfg = TrackerConfig(max_tracks=8, max_detections=3, embedding_dim=8, roi_size=4)
    tracker = RcnnTracker(cfg, tcfg, detectron2_checkpoint(0, 50, 2), init_weights(256 * 16, 8), (100, 160),
                          device="cpu")
    mtx, dist = camera.load_camera_params(os.path.join(REPO, "data", "cam_params.json"))
    mtx = mtx * np.array([[160 / 3840, 1, 160 / 3840], [1, 100 / 2160, 100 / 2160], [1, 1, 1]])
    return tracker, Preprocessor(mtx, dist, (160, 100), device="cpu")


def test_tracker_batch_emits_every_span(recording):
    """Two batches of two frames through ``track_uav.track_frames``: each
    batch's upload, preprocess, dispatch (resize, features, proposals and ROI
    heads with their NMS convergence tests, embed, associate a step a frame)
    and materialize, in order and nested, each span carrying its batch; the
    sync counters count each test and each copy to the host."""
    from apse_uav_torch.cli.track_uav import track_frames

    tracker, pre = _small_tracker()
    frames = np.random.default_rng(1).integers(0, 255, (4, 100, 160, 3), np.uint8)
    out = list(track_frames(tracker, pre, enumerate(frames), 2))
    assert [i for i, _, _ in out] == [0, 1, 2, 3]
    got = profiling.spans()
    tree = [(d, n) for d, n in _tree(got) if not n.startswith("sync.") or n == "sync.upload"]
    dispatch = [(0, "track.upload"), (1, "sync.upload"), (0, "track.preprocess"), (0, "track.dispatch"),
                (1, "track.resize"), (1, "track.features"), (1, "track.proposals"), (1, "track.roi_heads"),
                (1, "track.embed"), (1, "track.associate"), (2, "track.assoc_step"), (2, "track.assoc_step")]
    # One batch dispatched ahead: batch 2 is dispatched before batch 1 is materialized.
    assert tree == dispatch + dispatch + [(0, "track.materialize"), (0, "track.materialize")]
    batches = {s.name: [] for s in got}
    for s in got:
        batches[s.name].append(s.batch)
    assert batches["track.upload"] == batches["track.dispatch"] == batches["track.materialize"] == [1, 2]
    assert batches["track.features"] == [1, 2] and batches["track.assoc_step"] == [1, 1, 2, 2]
    nms = [got[s.parent].name for s in got if s.name == "sync.nms_converge"]
    assert set(nms) == {"track.proposals", "track.roi_heads"}
    assert {got[s.parent].name for s in got if s.name == "sync.materialize"} == {"track.materialize"}
    n_keys = len(out[0][2])
    assert profiling.counters["sync.upload"] == 2 and profiling.counters["sync.materialize"] == 2 * n_keys
    assert profiling.counters["sync.nms_converge"] == len(nms)
    totals = profiling.summary(got)
    inside = sum(totals[k]["ns"] for k in ("track.resize", "track.features", "track.proposals", "track.roi_heads",
                                           "track.embed", "track.associate"))
    assert inside <= totals["track.dispatch"]["ns"] and totals["track.dispatch"]["sync_ns"] > 0


@pytest.mark.parametrize("two_pass", [True, False], ids=["two_pass", "single_pass"])
def test_aruco_call_emits_every_span(recording, two_pass):
    """One ``ArucoPipeline.process`` call of two frames: the front's stages
    in order under ``aruco.front`` (K3 on the whole frame on the single-pass
    path), pose, then the scan a step a frame, all under ``aruco.process``
    with its call number, and no sync on the path; a tensor of first-frame
    flags is one, counted at its site."""
    from apse_uav_torch.aruco.pipeline import ArucoPipeline, ArucoPipelineConfig, init_carry
    from apse_uav_torch.utils.synthetic import MarkerSpec, render_scene

    w, h = 960, 544
    mtx, dist = camera.load_camera_params(os.path.join(REPO, "data", "cam_params.json"))
    mtx = mtx * np.array([[w / 3840, 1, w / 3840], [1, h / 2160, h / 2160], [1, 1, 1]])
    frame = render_scene(mtx, dist, (w, h), [MarkerSpec(4, (0.0, 0.5), 5), MarkerSpec(1, (-4.0, -2.0), 30)],
                         altitude=12.0, device="cpu").permute(2, 0, 1)
    cfg = ArucoPipelineConfig(two_pass=two_pass)
    pipe = ArucoPipeline(mtx, dist, (w, h), cfg, device="cpu")
    carry, out = pipe.process(torch.stack([frame, frame]).contiguous(), init_carry(cfg, "cpu"), first=True)
    assert out["detected"][:, [0, 3]].all()
    got = profiling.spans()
    stages = (["aruco.pool", "aruco.remap_pooled", "aruco.proposals", "aruco.select_tiles", "aruco.remap_selected"]
              if two_pass else ["aruco.remap_full", "aruco.pool", "aruco.proposals"])
    assert [(d, n) for d, n in _tree(got) if not n.startswith("sync.")] == [
        (0, "aruco.process"), (1, "aruco.front"), *((2, n) for n in stages), (2, "aruco.candidates"),
        (2, "aruco.pose"), (1, "aruco.scan"), (2, "aruco.step"), (2, "aruco.step")]
    assert {s.batch for s in got} == {pipe.calls} == {1}
    # The constants of the tile selection, the candidate stage, pose and the scan are made with the pipeline
    # and the scan's fallback altitude is a gather, so a call with a list of first-frame flags counts no sync.
    syncs = profiling.counted("sync")
    assert "dictionary_table" not in syncs and "tile_sizes" not in syncs, syncs
    assert syncs == {}, syncs
    stage_of = {s.name: got[s.parent].name for s in got if s.name.startswith("sync.")}
    assert not {"aruco.pose", "aruco.step"} & set(stage_of.values())
    profiling.reset_spans()
    profiling.reset_counters()
    front = pipe.front(torch.stack([frame, frame]).contiguous())
    pipe.scan(carry, front, torch.tensor([False, False]))
    assert profiling.counters["sync.first_frame"] == 1
    assert [n for _, n in _tree(profiling.spans()) if n.startswith("aruco.scan") or n.endswith("first_frame")] == [
        "aruco.scan", "sync.first_frame"]


def _span_report():
    import importlib.util

    spec = importlib.util.spec_from_file_location("span_report", os.path.join(REPO, "scripts", "span_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_span_report_sets_kernels_and_gaps_against_spans():
    """``scripts/span_report.py`` on made-up spans and kernels (ns): each
    launch counts for every span open at it, copies count device time but
    no launch, and each idle gap goes to the spans open across its middle
    (``root > innermost``), the rest to ``outside the spans``."""
    sr = _span_report()
    S = profiling.Span
    recorded = [S("a.root", 0, 1000, -1, 1), S("a.inner", 100, 500, 0, 1), S("a.other", 600, 900, 0, 1)]
    activity = [(150, 200, 300, "k1"), (160, 300, 350, "Memcpy HtoD"), (650, 850, 880, "k2"), (1100, 1200, 1300, "k3")]
    got = sr.by_span(recorded, activity)
    assert {k: v["launches"] for k, v in got.items()} == {"a.root": 2, "a.inner": 1, "a.other": 1}
    assert got["a.inner"]["device_ms"] == pytest.approx(150e-6)
    idle = sr.idle_gaps(recorded, activity)
    assert idle["gaps"] == 2 and idle["busy_s"] == pytest.approx(280e-9)
    assert dict(idle["by_span"]) == pytest.approx({"a.root > a.other": 500e-9, "outside the spans": 320e-9})
    assert idle["longest_named_share"] == pytest.approx(500 / 820)


def test_span_report_launches_graph_nodes_at_their_graph_launch():
    """``span_report.device_activity`` on a made-up trace (us): an eager
    kernel is launched at its ``cudaLaunchKernel``, every node of a replayed
    graph at its ``cudaGraphLaunch`` (one correlation id for all of them),
    and a kernel with no runtime call at its own start; so a graph's nodes
    count for the span that replayed it, not for the one open when the card
    ran them."""
    from types import SimpleNamespace as NS

    sr = _span_report()
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def ev(name, i, start, end, device=cpu):
        return NS(name=name, id=i, device_type=device, time_range=NS(start=start, end=end), is_user_annotation=False)

    events = [ev("cudaLaunchKernel", 1, 1.0, 2.0), ev("cudaGraphLaunch", 2, 3.0, 4.0),
              ev("k_eager", 1, 5.0, 6.0, cuda), ev("node_a", 2, 7.0, 8.0, cuda), ev("node_b", 2, 9.0, 10.0, cuda),
              ev("k_lost", 3, 11.0, 12.0, cuda)]
    prof = NS(profiler=NS(kineto_results=NS(trace_start_ns=lambda: 1000)), events=lambda: events)
    activity, how = sr.device_activity(prof)
    assert how == {"runtime": 3, "none": 1}
    assert activity == [(2000, 6000, 7000, "k_eager"), (4000, 8000, 9000, "node_a"),
                        (4000, 10000, 11000, "node_b"), (12000, 12000, 13000, "k_lost")]
    recorded = [profiling.Span("a.graph", 3500, 4500, -1, 1)]
    assert sr.by_span(recorded, activity)["a.graph"]["launches"] == 2


def test_span_report_reads_the_tracing_metrics(recording):
    """The per-layer numbers ``span_report`` derives from a spans-only
    stretch: per-frame host, self and wait times, syncs a frame, and each
    root span's share that its children leave uncovered."""
    sr = _span_report()
    with profiling.span("track.upload", 1):
        with profiling.sync("upload"):
            time.sleep(0.001)
    with profiling.span("track.dispatch", 1):
        with profiling.span("track.features"):
            time.sleep(0.002)
        with profiling.sync("nms_converge", 2):
            time.sleep(0.001)
    got = sr.report(profiling.spans(), profiling.counted("sync"), 2)
    m = got["metrics"]
    assert set(m) == {"track.upload_host_ms", "track.issue_host_ms", "track.sync_wait_ms", "track.syncs_per_frame"}
    assert m["track.syncs_per_frame"] == 1.5 and m["track.upload_host_ms"] >= 0.5
    assert m["track.issue_host_ms"] >= 1.0 and m["track.sync_wait_ms"] >= 1.0
    assert got["root_self_share"]["track.dispatch"] < 0.5


def test_aruco_detect_profile_writes_spans_beside_ops(tmp_path):
    """``aruco_detect --profile DIR`` on the CPU: one Chrome trace that holds
    the program's spans beside the ops they issued, spans off afterwards,
    and the copies of the outputs to the host counted."""
    import json

    import cv2

    from apse_uav_torch.cli.aruco_detect import main
    from apse_uav_torch.utils.synthetic import MarkerSpec, render_scene

    w, h = 960, 544
    mtx, dist = camera.load_camera_params(os.path.join(REPO, "data", "cam_params.json"))
    mtx = mtx * np.array([[w / 3840, 1, w / 3840], [1, h / 2160, h / 2160], [1, 1, 1]])
    frame = render_scene(mtx, dist, (w, h), [MarkerSpec(4, (0.0, 0.5), 5)], altitude=12.0, device="cpu")
    (tmp_path / "frames").mkdir()
    cv2.imwrite(str(tmp_path / "frames" / "image_0001.png"), frame.numpy())
    (tmp_path / "cam.json").write_text(json.dumps({"mtx": mtx.tolist(), "dist": dist.reshape(-1, 1).tolist()}))
    profiling.reset_counters()
    assert main(["--path_camera_params", str(tmp_path / "cam.json"), "--use_images", "--path_input_images",
                 str(tmp_path / "frames"), "--width", str(w), "--height", str(h), "--device", "cpu",
                 "--profile", str(tmp_path / "trace")]) == 0
    names = {e.get("name") for e in json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]}
    assert {"aruco.process", "aruco.front", "aruco.candidates", "aruco.pose", "aruco.step",
            "sync.to_host", "sync.upload"} <= names and "aten::add" in names
    assert profiling.span("after") is profiling.span("profile")  # spans off again
    assert profiling.counters["sync.upload"] == 1 and profiling.counters["sync.to_host"] > 10
    profiling.reset_spans()
