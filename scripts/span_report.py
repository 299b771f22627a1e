#!/usr/bin/env python3
"""Where a benchmark cell's time goes, read from the port's own spans and counters.

    python3 scripts/span_report.py --workload track-r101fpn-b4 --seed 123456789 [--frames 16]

Builds the cell's program as ``benchmark/run.py`` does (its configuration,
traffic, frames and seeded weights, from ``benchmark/``), warms it up on
the cell's shapes, then runs the window's own loop over ``--frames`` frames
twice:

1. spans on, ``torch.profiler`` on: each kernel's launch (its host call,
   matched by correlation id; for a node of a CUDA graph, the graph's
   launch) is set against the spans open at it, and each idle gap of the
   card against the spans open across its middle;
2. spans on, the profiler off: each span's host time, self time and wait in
   ``sync.*`` spans, the ``sync.*`` counters, and the batches that went up
   through the tracker's pinned ring (``track.upload_pinned``).

Prints one JSON line: the numbers a frame by span name, the kernels a
frame of the whole profiled stretch (``launches_per_frame``, copies aside,
as the benchmark's ``aruco.launches_per_frame`` counts them), the per-layer
numbers PERF.md names for the benchmark (``metrics``; for X101 also
``x101.gconv_ms``, the device ms a frame launched inside ``track.gconv``;
for ViTDet ``vitdet.attn_ms`` and ``vitdet.global_attn_ms``, the device ms a
frame launched inside ``track.attn_global`` and ``track.attn_window``, and
``vitdet.attn_gflop_per_frame`` from the ``vitdet.attn_flops`` counter),
the idle gaps by span, the share of the 500 longest gaps' seconds that a
span covers, and the share of each root span's host time that its children
leave uncovered.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(REPO, "benchmark"), REPO]

# Runtime calls that queue work on the card (their correlation id is the kernel's; every node of a
# replayed CUDA graph carries its graph launch's).
_QUEUING = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx", "cudaMemcpyAsync",
            "cudaMemsetAsync", "cudaGraphLaunch", "cuGraphLaunch")


def device_activity(prof) -> tuple[list, dict]:
    """(launch_ns, start_ns, end_ns, name) of every kernel and copy of a
    finished profiler run, on the spans' clock (Unix ns), sorted by start;
    and how many launches were found through the runtime call that queued
    them, and how many not (the kernel's start then stands in)."""
    import torch

    origin = prof.profiler.kineto_results.trace_start_ns()
    cuda = torch.autograd.DeviceType.CUDA
    runtime, kernels = {}, []
    for e in prof.events():
        if e.device_type == cuda:
            kernels.append(e)
        elif e.name.startswith(_QUEUING):
            runtime[e.id] = e.time_range.start
    out, how = [], {"runtime": 0, "none": 0}
    for k in kernels:
        start, end = k.time_range.start, k.time_range.end
        if end <= start or getattr(k, "is_user_annotation", False):
            continue
        found = k.id in runtime
        how["runtime" if found else "none"] += 1
        launch = runtime[k.id] if found else start
        out.append((origin + int(launch * 1e3), origin + int(start * 1e3), origin + int(end * 1e3), k.name))
    out.sort(key=lambda a: a[1])
    return out, how


def open_at(recorded, t_ns: int) -> list[int]:
    """Indices of the spans open at ``t_ns``, outermost first."""
    return [i for i, s in enumerate(recorded) if s.start_ns <= t_ns < s.end_ns]


def by_span(recorded, activity) -> dict:
    """By span name: the kernels launched while a span of that name was open
    (copies aside) and their device ms."""
    out = {}
    launches = sorted((a[0], a[2] - a[1], a[3]) for a in activity)
    times = [a[0] for a in launches]
    for s in recorded:
        lo, hi = bisect.bisect_left(times, s.start_ns), bisect.bisect_left(times, s.end_ns)
        row = out.setdefault(s.name, {"launches": 0, "device_ms": 0.0})
        for _, dur, name in launches[lo:hi]:
            if not name.startswith(("Memcpy", "Memset")):
                row["launches"] += 1
            row["device_ms"] += dur * 1e-6
    return out


def idle_gaps(recorded, activity, longest: int = 500) -> dict:
    """The card's idle gaps between the first and last kernel, each named by
    the spans open across its middle (``root > innermost``, or ``outside the
    spans``): seconds by name over all gaps and over the ``longest``, and
    the share of the longest gaps' seconds that a span names."""
    gaps, cur_end = [], None
    for _, s, e, _ in activity:
        if cur_end is not None and s > cur_end:
            gaps.append((cur_end, s))
        cur_end = e if cur_end is None else max(cur_end, e)
    span_ns = cur_end - activity[0][1] if activity else 0

    def name(g):
        inside = open_at(recorded, (g[0] + g[1]) // 2)
        if not inside:
            return "outside the spans"
        root, inner = recorded[inside[0]].name, recorded[inside[-1]].name
        return root if root == inner else f"{root} > {inner}"

    gaps.sort(key=lambda g: g[0] - g[1])
    every, top = {}, {}
    for k, g in enumerate(gaps):
        label = name(g)
        every[label] = every.get(label, 0.0) + (g[1] - g[0]) * 1e-9
        if k < longest:
            top[label] = top.get(label, 0.0) + (g[1] - g[0]) * 1e-9
    total = sum(top.values())
    named = total - top.get("outside the spans", 0.0)
    idle_s = sum(every.values())
    return {"gaps": len(gaps), "idle_s": idle_s, "busy_s": span_ns * 1e-9 - idle_s,
            "longest": len(gaps[:longest]), "longest_s": total, "longest_named_share": named / total if total else None,
            "by_span": _top(every), "longest_by_span": _top(top)}


def _top(d: dict, n: int = 12) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def report(recorded, syncs: dict, frames: int) -> dict:
    """The spans-only stretch a frame: host, self and sync-wait ms by span
    name, syncs by site, the per-layer numbers PERF.md names and each root
    span's uncovered share."""
    from apse_uav_torch.utils import profiling

    totals = profiling.summary(recorded)
    per = {k: {"n": v["n"] / frames, "host_ms": v["ns"] * 1e-6 / frames, "self_ms": v["self_ns"] * 1e-6 / frames,
               "sync_ms": v["sync_ns"] * 1e-6 / frames} for k, v in totals.items()}

    def ms(name, key="host_ms"):
        return per[name][key] if name in per else None

    metrics = {}
    if "aruco.process" in per:
        metrics = {"aruco.candidates_host_ms": ms("aruco.candidates", "self_ms"),
                   "aruco.pose_host_ms": ms("aruco.pose", "self_ms"), "aruco.scan_host_ms": ms("aruco.scan")}
    if "track.dispatch" in per:
        metrics = {"track.upload_host_ms": ms("track.upload"),
                   "track.issue_host_ms": ms("track.dispatch") - ms("track.dispatch", "sync_ms"),
                   "track.sync_wait_ms": sum(v["host_ms"] for k, v in per.items() if k.startswith("sync.")),
                   "track.syncs_per_frame": sum(syncs.values()) / frames}
    roots = {recorded[i].name for i in range(len(recorded)) if recorded[i].parent < 0}
    uncovered = {r: totals[r]["self_ns"] / totals[r]["ns"] for r in roots if totals[r]["ns"]}
    return {"per_frame": per, "syncs_per_frame": {k: v / frames for k, v in syncs.items()}, "metrics": metrics,
            "root_self_share": uncovered}


def aruco_program(cell, ctx):
    """The cell's pipeline, warmed up, and a function that runs the window's
    loop over calls ``[i, i + n)``."""
    from apse_uav_torch.aruco import detector as pdet, pipeline as ppipe

    drv, cfg, dev = cell.driver, ctx.config, ctx.device
    variants = drv.host_frames(ctx, np.random.default_rng(ctx.seed))
    pcfg = drv._pipeline_config(ppipe, cfg)
    pipe = ppipe.ArucoPipeline(cfg["camera"]["mtx"], cfg["camera"]["dist"], tuple(cfg["frame_wh"]), pcfg,
                               drv._detector_params(pdet, cfg), device=dev)
    state = {"carry": ppipe.init_carry(pcfg, dev)}
    for i in range(2):
        state["carry"], _ = drv.run_call(pipe, state["carry"], drv.call_frames(variants, ctx.traffic, i), i == 0, dev)

    def loop(i, n):
        for k in range(i, i + n):
            state["carry"], _ = drv.run_call(pipe, state["carry"], drv.call_frames(variants, ctx.traffic, k), False,
                                             dev)

    return loop, ctx.traffic["batch"]


def tracker_program(cell, ctx):
    """The cell's tracker and ``Preprocessor`` on the benchmark's seeded,
    calibrated weights (R-FPN's, or X101's for the ``tracker_x101``
    family, ViTDet's for ``tracker_vitdet``), warmed up, and a function that
    runs ``track_frames`` over batches ``[i, i + n)``."""
    from apse_uav_torch.cli.track_uav import track_frames
    from apse_uav_torch.dcnn import config as pconfig
    from apse_uav_torch.dcnn.engines import RcnnTracker
    from apse_uav_torch.preproc.remap import Preprocessor
    from benchkit import scene, weights, weights_vitdet, weights_x101
    from benchkit.refmodel import RefTracker, model_config, tracker_config
    from benchkit.refmodel_vitdet import RefTrackerViTDet, model_config_vitdet
    from benchkit.refmodel_x101 import RefTrackerX101, model_config_x101

    cfg, traffic, dev = ctx.config, ctx.traffic, ctx.device
    b, (w, h), m, t = traffic["batch"], cfg["frame_wh"], cfg["model"], cfg["tracker"]
    base = scene.render_video(cfg["camera"], (w, h), traffic, np.random.default_rng(ctx.seed), dev)
    variants = [[f + np.uint8(s) for f in base] for s in traffic["shifts"]]
    frame = cell.driver.frame_source(variants, traffic)
    family = cfg["family"]
    embed_in = m["fpn_channels"] * t["roi_size"] ** 2
    if family == "tracker_x101":
        ckpt, assoc = weights_x101.seeded_weights(ctx.seed, m, embed_in, t["embedding_dim"], dev)
        ref, calib = RefTrackerX101(m, t, ckpt, assoc, (h, w), cfg["camera"], dev), weights_x101
        mcfg = model_config_x101
    elif family == "tracker_vitdet":
        ckpt, assoc = weights_vitdet.seeded_weights(ctx.seed, m, embed_in, t["embedding_dim"], dev)
        ref, calib = RefTrackerViTDet(m, t, ckpt, assoc, (h, w), cfg["camera"], dev), weights_vitdet
        mcfg = model_config_vitdet
    else:
        ckpt, assoc = weights.seeded_weights(ctx.seed, m["depth"], m["roi"]["num_classes"], embed_in,
                                             t["embedding_dim"], dev)
        ref, calib, mcfg = RefTracker(m, t, ckpt, assoc, (h, w), cfg["camera"], dev), weights, model_config
    calib.calibrate_background(ckpt, ref, [f for v in variants for f in v], cfg["calibration"]["per_frame"],
                               cfg["calibration"]["batch"])
    del ref
    tracker = RcnnTracker(mcfg(m, pconfig), tracker_config(t, pconfig), ckpt, {k: v.cpu() for k, v in assoc.items()},
                          (h, w), device=dev)
    pre = Preprocessor(cfg["camera"]["mtx"], cfg["camera"]["dist"], (w, h), device=dev)

    def loop(i, n):
        for _ in track_frames(tracker, pre, ((k, frame(k)) for k in range(i * b, (i + n) * b)), b):
            pass

    loop(0, 3)
    return loop, b


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--frames", type=int, default=16)
    args = p.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from apse_uav_torch.utils import profiling
    from benchkit import chip, spec
    from benchkit.context import RunContext

    cell = spec.find_cell(args.workload)
    chip.require(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    ctx = RunContext(cell.config, cell.traffic, args.seed, 0.0, True, dev, time.perf_counter())
    build = aruco_program if cell.config["family"] == "aruco" else tracker_program
    loop, b = build(cell, ctx)
    n = max(1, args.frames // b)
    torch.cuda.synchronize()

    profiling.reset_spans()
    profiling.enable_spans(True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        loop(10, n)
        torch.cuda.synchronize()
    profiling.enable_spans(False)
    traced = profiling.spans()
    activity, how = device_activity(prof)
    launches = {k: {"launches": v["launches"] / (n * b), "device_ms": v["device_ms"] / (n * b)}
                for k, v in by_span(traced, activity).items()}
    kernels = sum(1 for a in activity if not a[3].startswith(("Memcpy", "Memset"))) / (n * b)
    idle = idle_gaps(traced, activity)
    if "aruco.candidates" in launches:
        idle["aruco.candidates_launches_per_frame"] = launches["aruco.candidates"]["launches"]
    del prof

    profiling.reset_spans()
    before = profiling.counted("sync")
    pinned = profiling.counters.get("track.upload_pinned", 0)
    attn_flops = profiling.counters.get("vitdet.attn_flops", 0)
    profiling.enable_spans(True)
    t0 = time.perf_counter()
    loop(20, n)
    torch.cuda.synchronize()
    stretch_s = time.perf_counter() - t0
    profiling.enable_spans(False)
    syncs = {k: v - before.get(k, 0) for k, v in profiling.counted("sync").items() if v - before.get(k, 0)}
    out = {"workload": cell.name, "seed": args.seed, "frames": n * b, "card": chip.power_limit(),
           "spans_stretch_s": stretch_s, **report(profiling.spans(), syncs, n * b),
           "pinned_uploads_per_batch": (profiling.counters.get("track.upload_pinned", 0) - pinned) / n,
           "launches_per_frame": kernels, "launches_per_frame_by_span": launches, "launch_routes": how,
           "idle": idle}
    if "track.gconv" in launches:  # X101's grouped 3x3s alone, as the benchmark's x101.gconv_ms reads them
        out["metrics"]["x101.gconv_ms"] = launches["track.gconv"]["device_ms"]
    if "track.attn_global" in launches:  # ViTDet's attention cores, as the benchmark's vitdet.* read them
        attn = {k: launches.get(k, {"device_ms": 0.0})["device_ms"] for k in ("track.attn_global", "track.attn_window")}
        out["metrics"].update({"vitdet.attn_ms": sum(attn.values()), "vitdet.global_attn_ms": attn["track.attn_global"],
                               "vitdet.attn_gflop_per_frame": (profiling.counters.get("vitdet.attn_flops", 0)
                                                               - attn_flops) / (n * b) / 1e9})
    profiling.reset_spans()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
