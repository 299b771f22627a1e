"""Driver of the tracker cells: ``track_uav``'s ``track_frames`` over the
measured ``RcnnTracker`` and ``Preprocessor``, as ``build_tracker`` makes them
for ``--preprocess``.

``track_frames`` pulls the replayed 4K BGR frames from a generator (a
closed loop: it takes the next batch when it wants it), uploads each batch,
undistorts it, dispatches it one batch ahead of the host's work and copies
each batch's snapshots to the host.  A frame's latency runs from the moment
its batch's last frame is handed over to the moment its snapshot is on the
host.

The comparison: after the window, a sample of the batches runs again
through the plain reference: the first (from the fresh track state), the
last of the window (kept in a slot that every dispatch overwrites), and
the rest drawn from the seed before the window over the batches a steady
window holds.  It compares (``benchkit.refmodel``) the preprocessed
frames, the detections (valid, classes, scores, boxes, masks), and, from
the measured program's own track state before the batch, the
association's snapshots (valid, ids, classes, embeddings) and the track
state after it.
"""

from __future__ import annotations

import time

import numpy as np

from benchkit import clock, scene, trace, weights, yardstick
from benchkit.context import Checks, check_sample
from benchkit.refmodel import RefTracker, model_config, tracker_config

# Limits of the numbers compared (PERF.md gives the readings they come from).
LIMITS = {
    "pre_levels": 0.0,    # largest gap of the preprocessed frames, u8 levels: exact
    "det_flips": 0.0,     # detection slots whose valid or class differ: exact
    "score_gap": 1e-4,    # largest score gap of a detection valid on both sides
    "box_px": 1e-2,       # largest box coordinate gap, frame pixels
    "mask_gap": 1e-4,     # largest mask probability gap
    "track_flips": 0.0,   # snapshot rows whose valid, id or class differ: exact
    "emb_gap": 1e-4,      # largest embedding component gap of a row valid on both sides
}
PROFILED_FRAMES = 16


def frame_source(variants, traffic: dict):
    b, n = traffic["batch"], traffic["distinct_frames"]
    return lambda i: variants[(i // b) % len(variants)][i % n]


def run(ctx) -> dict:
    import torch

    from apse_uav_torch.cli.track_uav import track_frames
    from apse_uav_torch.dcnn import config as pconfig
    from apse_uav_torch.dcnn.engines import RcnnTracker
    from apse_uav_torch.preproc.remap import Preprocessor

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
    ckpt, assoc = weights.seeded_weights(ctx.seed, m["depth"], m["roi"]["num_classes"],
                                         m["fpn_channels"] * t["roi_size"] ** 2, t["embedding_dim"], dev)
    ref = RefTracker(m, t, ckpt, assoc, (h, w), cfg["camera"], dev)
    cal = cfg["calibration"]
    calibration = weights.calibrate_background(ckpt, ref, [f for v in variants for f in v], cal["per_frame"],
                                               cal["batch"])
    ref.offload()
    phases["weights_and_calibration_s"] = time.perf_counter() - ctx.t_start - phases["imports_and_frames_s"]
    if ctx.program == "port":
        tracker = RcnnTracker(model_config(m, pconfig), tracker_config(t, pconfig), ckpt,
                              {k: v.cpu() for k, v in assoc.items()}, (h, w), device=dev)
        pre = Preprocessor(cfg["camera"]["mtx"], cfg["camera"]["dist"], (w, h), device=dev)
    else:
        tracker = RefTracker(m, t, ckpt, assoc, (h, w), cfg["camera"], dev, tf32=True)
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


def compare_detections(port: dict, ref: dict, checks: Checks) -> None:
    p = {k: v.cpu().numpy() for k, v in port.items()}
    r = {k: v.cpu().numpy() for k, v in ref.items()}
    both = p["valid"] & r["valid"]
    checks.note("det_flips", np.sum(p["valid"] != r["valid"]) + np.sum((p["classes"] != r["classes"]) & both))
    if both.any():
        checks.note("score_gap", np.abs(p["scores"] - r["scores"])[both].max())
        checks.note("box_px", np.abs(p["boxes"] - r["boxes"])[both].max())
        checks.note("mask_gap", np.abs(p["masks"] - r["masks"])[both].max())


def compare_snapshot(port: dict, ref: dict, checks: Checks) -> None:
    both = port["valid"] & ref["valid"]
    checks.note("track_flips", np.sum(port["valid"] != ref["valid"])
                + np.sum(((port["ids"] != ref["ids"]) | (port["classes"] != ref["classes"])) & both))
    if both.any():
        checks.note("emb_gap", np.abs(port["embeddings"] - ref["embeddings"])[both].max())
        checks.note("box_px", np.abs(port["boxes"] - ref["boxes"])[both].max())


# The float fields of the track state and the number each gap counts under.
STATE_GAPS = {"boxes": "box_px", "scores": "score_gap", "masks": "mask_gap", "embeddings": "emb_gap"}


def compare_state(port: dict, ref: dict, checks: Checks) -> None:
    """The track state after the batch: every integer and flag field exact
    (counted under track_flips), every float field within its gap."""
    flips = 0
    for key, a in port.items():
        a, r = a.cpu().numpy(), ref[key].cpu().numpy()
        if key in STATE_GAPS:
            checks.note(STATE_GAPS[key], np.abs(a - r).max() if a.size else 0.0)
        else:
            flips += int(np.sum(a != r))
    checks.note("track_flips", flips)


def traced(ctx, tracker, pre, frame, first: int, window_s_e2e: float) -> dict:
    """The per-layer readings: one profiled stretch of the window's loop, then
    each stage of one batch timed alone between synchronizes (the pattern of
    the measured package's smoke run), and the model FLOPs of the window."""
    import torch
    from torch.profiler import record_function

    from apse_uav_torch.cli.track_uav import track_frames
    from apse_uav_torch.dcnn.engines import full_fp32

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

    tracker.process_frames_async, tracker.materialize = dispatch_traced, materialize_traced
    try:
        rec = trace.profile(lambda: [None for _ in track_frames(tracker, pre_traced,
                                                                ((i, frame(i)) for i in range(first, first + n_prof)),
                                                                b)], dev)
    finally:
        tracker.process_frames_async, tracker.materialize = dispatch, materialize
    kept = torch.cat(valid).sum(dim=1).cpu().numpy()
    capped = np.minimum(kept, cfg["tracker"]["max_detections"])
    pred, model = tracker.predictor, tracker.predictor.model
    flops = np.mean([yardstick.tracker_flops(cfg, pred.pad_hw, d, c)
                     for d, c in zip(kept, capped)])

    frames_np = np.stack([frame(i) for i in range(b)])
    x = torch.from_numpy(frames_np).to(dev)
    rgb, _ = pre(x, with_gray=False)
    resized = pred.resize(rgb)
    hw = pred.pad_hw

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
            "breakdown": {"device_ops": rec["device_ops"], "idle_gaps": rec["idle_gaps"]}}
