"""Driver of the ViTDet tracker cells: ``track_uav --arch vitdet``'s
``track_frames`` over the measured ``RcnnTracker`` on Mask R-CNN ViTDet-B
and its ``Preprocessor``, as ``build_tracker`` makes them for
``--preprocess``.

The window, the latency, the sample and the comparison are those of the
R-FPN cells (``drivers/tracker.py``, whose limits and comparisons this
driver imports); the seeded weights, their calibration, the plain reference
and the FLOP count are ViTDet's (``benchkit/weights_vitdet.py``,
``refmodel_vitdet.py``, ``yardstick_vitdet.py``).  The traced run also reads
the program's attention spans (``track.attn_global``, ``track.attn_window``)
and its ``vitdet.attn_flops`` counter over the profiled stretch.

A program whose config module has no ``ViTConfig`` (no ViTDet) fails at
once, before any frame is rendered.
"""

from __future__ import annotations

import os
import time

import numpy as np

from benchkit import clock, scene, spantrace, spec, weights_vitdet, yardstick_vitdet
from benchkit.context import Checks, check_sample
from benchkit.refmodel import tracker_config
from benchkit.refmodel_vitdet import RefTrackerViTDet, model_config_vitdet

_fpn = spec.load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tracker.py"), "bench_driver_tracker")
LIMITS, PROFILED_FRAMES, frame_source = _fpn.LIMITS, _fpn.PROFILED_FRAMES, _fpn.frame_source
compare_detections, compare_snapshot, compare_state = _fpn.compare_detections, _fpn.compare_snapshot, _fpn.compare_state
ATTN_SPANS = ("track.attn_global", "track.attn_window")


def require_vitdet(pconfig) -> None:
    if not hasattr(pconfig, "ViTConfig"):
        raise RuntimeError("the measured program's config module has no ViTConfig: it runs no ViTDet")


def run(ctx) -> dict:
    import torch

    from apse_uav_torch.cli.track_uav import track_frames
    from apse_uav_torch.dcnn import config as pconfig, engines
    from apse_uav_torch.preproc.remap import Preprocessor

    require_vitdet(pconfig)
    torch.backends.cuda.matmul.allow_tf32 = False  # as track_uav's cli_device sets it
    torch.backends.cudnn.allow_tf32 = False
    cfg, traffic, dev = ctx.config, ctx.traffic, ctx.device
    b = traffic["batch"]
    w, h = cfg["frame_wh"]
    m, t = cfg["model"], cfg["tracker"]
    rng = np.random.default_rng(ctx.seed)
    base = scene.render_video(cfg["camera"], (w, h), traffic, rng, dev)
    variants = [[f + np.uint8(s) for f in base] for s in traffic["shifts"]]
    frame = frame_source(variants, traffic)
    phases = {"imports_and_frames_s": time.perf_counter() - ctx.t_start}
    ckpt, assoc = weights_vitdet.seeded_weights(ctx.seed, m, m["fpn_channels"] * t["roi_size"] ** 2,
                                                t["embedding_dim"], dev)
    ref = RefTrackerViTDet(m, t, ckpt, assoc, (h, w), cfg["camera"], dev)
    cal = cfg["calibration"]
    calibration = weights_vitdet.calibrate_background(ckpt, ref, [f for v in variants for f in v],
                                                      cal["per_frame"], cal["batch"])
    ref.offload()
    phases["weights_and_calibration_s"] = time.perf_counter() - ctx.t_start - phases["imports_and_frames_s"]
    if ctx.program == "port":
        tracker = engines.RcnnTracker(model_config_vitdet(m, pconfig), tracker_config(t, pconfig), ckpt,
                                      {k: v.cpu() for k, v in assoc.items()}, (h, w), device=dev)
        pre = Preprocessor(cfg["camera"]["mtx"], cfg["camera"]["dist"], (w, h), device=dev)
    else:
        tracker = RefTrackerViTDet(m, t, ckpt, assoc, (h, w), cfg["camera"], dev, tf32=True)
        pre = tracker.pre
    del ckpt
    if ctx.break_program is not None:
        ctx.break_program(tracker)

    t_w = time.perf_counter()
    phases["program_build_s"] = t_w - ctx.t_start - sum(phases.values())
    # Warm-up: three batches.  The snapshots of the first two reach the host one
    # dispatch apart, which times a steady batch for the sample's range.
    warm = []
    for idx, _, _ in track_frames(tracker, pre, ((i, frame(i)) for i in range(3 * b)), b):
        if idx % b == b - 1:
            warm.append(time.perf_counter())
    batch_s = warm[1] - warm[0]
    clock.sync(dev)
    tracker.reset()

    sample = check_sample(rng, max(2, int(0.8 * ctx.seconds / batch_s)), traffic["check_batches"])
    kept = {"pre": {}, "state": {}, "dets": {}, "after": {}}
    last = {"pre": {}, "state": {}, "dets": {}, "after": {}}  # the newest batch's, whether sampled or not
    count = {"pre": 0, "dispatch": 0}
    dispatch = tracker.process_frames_async

    def pre_kept(x, with_gray=True):
        k = count["pre"]
        count["pre"] += 1
        out = pre(x, with_gray)
        last["pre"] = {k: out[0]}
        if k in sample:
            kept["pre"][k] = out[0]
        return out

    def dispatch_kept(frames):
        k = count["dispatch"]
        count["dispatch"] += 1
        before = tracker.state
        handle = dispatch(frames)
        last.update(state={k: before}, dets={k: handle[0]}, after={k: tracker.state})
        if k in sample:
            kept["state"][k], kept["dets"][k], kept["after"][k] = before, handle[0], tracker.state
        return handle

    tracker.process_frames_async = dispatch_kept
    handed, latency, snaps = {}, [], {}
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    deadline = t0 + ctx.seconds

    def feed():
        i = 0
        while i % b or i == 0 or time.perf_counter() < deadline:
            if i % b == b - 1:
                handed[i // b] = time.perf_counter()
            yield i, frame(i)
            i += 1

    last_snaps = {}
    for idx, _, snap in track_frames(tracker, pre_kept, feed(), b):
        latency.append(time.perf_counter() - handed[idx // b])
        if idx % b == 0:
            last_snaps = {}
        last_snaps[idx] = snap
        if idx // b in sample:
            snaps[idx] = snap
    window_s = time.perf_counter() - t0
    tracker.process_frames_async = dispatch
    n = len(latency)
    final = n // b - 1
    for key, slot in last.items():
        kept[key].update(slot)
    snaps.update(last_snaps)
    if not all(final in kept[key] for key in kept) or len(last_snaps) != b:
        raise RuntimeError(f"the window's last batch {final} was not kept whole")
    sample = sorted({*sample, final})
    result = {"attempted": n, "failed": 0,
              "metrics": {"setup_s": setup_s, "track_fps": n / window_s, "track_p95_ms": clock.p95(latency) * 1e3}}
    if ctx.trace:
        result["record"] = traced(ctx, tracker, pre, frame, n, window_s)
    result["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    phases["warm_s"] = setup_s - sum(phases.values())
    result["notes"] = {"setup": phases, "setup_s": setup_s, "calibration": calibration, "warm_batch_s": batch_s,
                       "sample": sample}
    del tracker, pre, dispatch, dispatch_kept, pre_kept, last  # the program's state, freed before the reference runs
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_cmp = time.perf_counter()
    ref.reload()
    checks = Checks(LIMITS)
    done = [k for k in sample if (k + 1) * b <= n]
    for k in done:
        x = torch.from_numpy(np.stack([frame(i) for i in range(k * b, (k + 1) * b)])).to(dev)
        rpre, _ = ref.pre(x, with_gray=False)
        checks.note("pre_levels", (rpre.to(torch.int32) - kept["pre"][k].to(torch.int32)).abs().max())
        rdets, feats = ref.detect(rpre)
        compare_detections(kept["dets"][k], rdets, checks)
        state, recents = ref.associate(kept["state"][k], *ref.embed(rdets, feats))
        recents = {key: v.cpu().numpy() for key, v in recents.items()}
        for j in range(b):
            compare_snapshot(snaps[k * b + j], {key: v[j] for key, v in recents.items()}, checks)
        compare_state(kept["after"][k], state, checks)
    result["checks"] = checks
    result["compared"] = len(done) * b
    result["notes"]["valid_detections_compared"] = sum(int(kept["dets"][k]["valid"].sum()) for k in done)
    result["notes"]["tracks_compared"] = sum(int(snaps[i]["valid"].sum()) for i in snaps)
    result["notes"]["compare_s"] = time.perf_counter() - t_cmp
    return result


def traced(ctx, tracker, pre, frame, first: int, window_s_e2e: float) -> dict:
    """The per-layer readings: one profiled stretch of the window's loop with
    the program's spans on (the device time launched inside its attention
    spans, its ``vitdet.attn_flops`` counter), then each stage of one batch
    timed alone between synchronizes, and the model FLOPs of the window."""
    import torch
    from torch.profiler import record_function

    from apse_uav_torch.cli.track_uav import track_frames
    from apse_uav_torch.dcnn.engines import full_fp32
    from apse_uav_torch.utils import profiling

    dev, traffic, cfg = ctx.device, ctx.traffic, ctx.config
    b = traffic["batch"]
    n_prof = max(1, PROFILED_FRAMES // b) * b
    valid = []
    dispatch, materialize = tracker.process_frames_async, tracker.materialize

    def dispatch_traced(frames):
        with record_function("bench.dispatch"):
            handle = dispatch(frames)
        valid.append(handle[0]["valid"])
        return handle

    def materialize_traced(handle):
        with record_function("bench.materialize"):
            return materialize(handle)

    def pre_traced(x, with_gray=True):
        with record_function("bench.preprocess"):
            return pre(x, with_gray)

    def stretch():
        for _ in track_frames(tracker, pre_traced, ((i, frame(i)) for i in range(first, first + n_prof)), b):
            pass

    tracker.process_frames_async, tracker.materialize = dispatch_traced, materialize_traced
    flops_before = profiling.counters.get("vitdet.attn_flops", 0)
    profiling.enable_spans(True)
    try:
        rec = spantrace.profile(stretch, dev, ATTN_SPANS)
    finally:
        profiling.enable_spans(False)
        profiling.reset_spans()
        tracker.process_frames_async, tracker.materialize = dispatch, materialize
    attn_flops = profiling.counters.get("vitdet.attn_flops", 0) - flops_before
    kept = torch.cat(valid).sum(dim=1).cpu().numpy()
    capped = np.minimum(kept, cfg["tracker"]["max_detections"])
    pred, model = tracker.predictor, tracker.predictor.model
    flops = np.mean([yardstick_vitdet.tracker_flops(cfg, pred.pad_hw, d, c) for d, c in zip(kept, capped)])
    global_s, window_s = (rec["span_device_s"][name] for name in ATTN_SPANS)

    frames_np = np.stack([frame(i) for i in range(b)])
    x = torch.from_numpy(frames_np).to(dev)
    rgb, _ = pre(x, with_gray=False)
    resized = pred.resize(rgb)
    hw = pred.clip_hw

    def quiet(fn):
        def run_():
            with torch.no_grad(), full_fp32():
                return fn()
        return run_

    feats = quiet(lambda: model.features(resized))()
    boxes, _, pvalid = quiet(lambda: model.proposals(feats, hw))()
    dets = pred.postprocess(quiet(lambda: model.detect(feats, boxes, pvalid, hw))())
    det_cap, emb = tracker.embed(dets, feats)
    state0 = tracker.state

    def associate():
        tracker.state = state0
        return tracker.associate(det_cap, emb)

    def upload_pre_resize():
        y, _ = pre(torch.from_numpy(frames_np).to(dev), with_gray=False)
        return pred.resize(y)

    def heads():
        bx, _, v = model.proposals(feats, hw)
        return pred.postprocess(model.detect(feats, bx, v, hw))

    stage = {"upload_ms": clock.wall_ms(upload_pre_resize, dev),
             "backbone_ms": clock.wall_ms(quiet(lambda: model.features(resized)), dev),
             "heads_ms": clock.wall_ms(quiet(heads), dev),
             "assoc_ms": clock.wall_ms(lambda: (tracker.embed(dets, feats), associate()), dev)}
    tracker.state = state0
    return {"frames": n_prof, "window_s": rec["window_s"], "busy_s": rec["busy_s"], "launches": rec["launches"],
            "flops_per_frame": float(flops), "e2e_frames": first, "e2e_window_s": window_s_e2e,
            **{k: v / b for k, v in stage.items()},
            "attn_global_s": global_s, "attn_window_s": window_s,
            "attn_bound_s": yardstick_vitdet.attention_bound_s(cfg, b, n_prof // b), "attn_flops": attn_flops,
            "breakdown": {"device_ops": rec["device_ops"], "idle_gaps": rec["idle_gaps"]}}
