"""Driver of the ArUco cells: ``ArucoPipeline.process`` as ``aruco_detect`` calls it.

Each call of the window feeds a batch as a video reader would: the batch's
u8 BGR frames stacked into one pageable host buffer that is reused from call
to call, one pageable upload, the planar layout ``process`` takes made on the
card; then ``process`` with the carry of the call before, and every output
but the gray copied to the host.  (``aruco_detect`` transposes to planar on
the host into fresh memory each call; that copy is the CLI's, not the
pipeline's, and this harness cannot follow a change to it.)  The traffic replays its distinct
frames in order, each call's frames brightened by the next of its shifts;
the loop is closed (the next call starts when the last one's outputs are
on the host).

The comparison: after the window, a sample of the calls drawn from the
seed (the first and the last among them) runs again through the plain
reference (``refplain``) from the measured program's own carry before the
call, and the per-frame flags (detected, measured, LEDs), corners,
distances and the carry after the call are compared.
"""

from __future__ import annotations

import time

import numpy as np

from benchkit import clock, scene, trace, yardstick
from benchkit.context import Checks, check_sample

# Limits of the numbers compared (PERF.md gives the readings they come from).
LIMITS = {
    "flag_mismatch": 0.0,   # detected / measured / LEDs / int carry that differ: exact
    "corner_px": 0.05,      # largest corner gap of a vehicle detected on both sides, pixels
    "dist_m": 0.01,         # largest gap of dist_aruco and dist_aruco_bbox, metres
    "state_rel": 1e-4,      # largest gap of the float carry after the call, over max(1, |reference|)
}
# Calls profiled in a traced run (each process call of 8 4K frames makes ~12.6k launches).
PROFILED_FRAMES = 16


def _pipeline_config(mod, cfg: dict):
    p = dict(cfg["pipeline"])
    p["led_bias_px"] = tuple(p["led_bias_px"])
    return mod.ArucoPipelineConfig(**p)


def _detector_params(mod, cfg: dict):
    return mod.DetectorParams(**{k: tuple(v) if isinstance(v, list) else v for k, v in cfg["detector"].items()})


def host_frames(ctx, rng) -> list[list[np.ndarray]]:
    """variants[s][f]: distinct frame f brightened by shift s, (H, W, 3) u8 on the host."""
    base = scene.render_video(ctx.config["camera"], tuple(ctx.config["frame_wh"]), ctx.traffic, rng, ctx.device)
    return [[f + np.uint8(s) for f in base] for s in ctx.traffic["shifts"]]


def call_frames(variants, traffic: dict, i: int) -> list[np.ndarray]:
    """The frames of call ``i``: the next ``batch`` distinct frames in order, the call's shift."""
    b, n = traffic["batch"], traffic["distinct_frames"]
    v = variants[i % len(variants)]
    return [v[(i * b + j) % n] for j in range(b)]


_HOST: dict[tuple, np.ndarray] = {}


def upload(frames, device):
    """The call's batch: stacked into the reused host buffer of its shape, one
    pageable copy, planar on the card."""
    import torch

    shape = (len(frames), *frames[0].shape)
    if shape not in _HOST:
        _HOST[shape] = np.empty(shape, np.uint8)
    buf = np.stack(frames, out=_HOST[shape])
    return torch.from_numpy(buf).to(device).permute(0, 3, 1, 2).contiguous()


def run_call(pipe, carry, frames, first: bool, device):
    carry, out = pipe.process(upload(frames, device), carry, first=first)
    return carry, {k: v.cpu().numpy() for k, v in out.items() if k != "gray"}


def build_reference(ctx, bf16_maps: bool = False):
    """The plain reference pipeline; with ``bf16_maps`` its undistortion maps
    rounded to bfloat16 (the control, one step below float32)."""
    import torch

    from refplain.aruco import detector as rdet, pipeline as rpipe

    cfg = ctx.config
    pipe = rpipe.ArucoPipeline(cfg["camera"]["mtx"], cfg["camera"]["dist"], tuple(cfg["frame_wh"]),
                               _pipeline_config(rpipe, cfg), _detector_params(rdet, cfg), device=ctx.device)
    if bf16_maps:
        for name in ("map_full", "map_pooled"):
            if hasattr(pipe, name):
                setattr(pipe, name, getattr(pipe, name).to(torch.bfloat16).to(torch.float32))
    return pipe, rpipe


def compare(port_out: dict, ref_out: dict, port_carry: dict, ref_carry: dict, checks: Checks) -> None:
    flags = sum(int(np.sum(port_out[k] != ref_out[k])) for k in ("detected", "measured", "leds"))
    both = port_out["detected"].astype(bool) & ref_out["detected"].astype(bool)
    corner = np.abs(port_out["corners"] - ref_out["corners"]).max(axis=(-1, -2))
    checks.note("corner_px", corner[both].max() if both.any() else 0.0)
    checks.note("dist_m", max(float(np.abs(port_out[k] - ref_out[k]).max()) for k in ("dist_aruco", "dist_aruco_bbox")))
    rel = 0.0
    for k, a in port_carry.items():
        a, b = a.cpu().numpy(), ref_carry[k].cpu().numpy()
        if a.dtype.kind in "iub":
            flags += int(np.sum(a != b))
        else:
            rel = max(rel, float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max())))
    checks.note("flag_mismatch", flags)
    checks.note("state_rel", rel)


def run(ctx) -> dict:
    import torch

    from apse_uav_torch.aruco import detector as pdet, pipeline as ppipe

    torch.backends.cuda.matmul.allow_tf32 = False  # as aruco_detect sets it
    torch.backends.cudnn.allow_tf32 = False
    cfg, traffic, dev = ctx.config, ctx.traffic, ctx.device
    rng = np.random.default_rng(ctx.seed)
    variants = host_frames(ctx, rng)
    t_frames = time.perf_counter()
    if ctx.program == "port":
        pcfg = _pipeline_config(ppipe, cfg)
        pipe = ppipe.ArucoPipeline(cfg["camera"]["mtx"], cfg["camera"]["dist"], tuple(cfg["frame_wh"]), pcfg,
                                   _detector_params(pdet, cfg), device=dev)
        init_carry = ppipe.init_carry
    else:
        pipe, rpipe = build_reference(ctx, bf16_maps=True)
        pcfg, init_carry = pipe.cfg, rpipe.init_carry
    if ctx.break_program is not None:
        ctx.break_program(pipe)
    b = traffic["batch"]
    carry = init_carry(pcfg, dev)
    for i in range(2):  # warm-up: the cell's shapes, the first call and a later one
        carry, _ = run_call(pipe, carry, call_frames(variants, traffic, i), i == 0, dev)
    clock.sync(dev)
    t_warm = time.perf_counter()

    carries, outs = [init_carry(pcfg, dev)], []
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    phases = {"imports_and_frames_s": t_frames - ctx.t_start, "build_and_warm_s": t_warm - t_frames}
    deadline = t0 + ctx.seconds
    i = 0
    spent = {"upload_s": 0.0, "process_s": 0.0, "to_host_s": 0.0}
    while i == 0 or time.perf_counter() < deadline:
        ta = time.perf_counter()
        batch = upload(call_frames(variants, traffic, i), dev)
        tb = time.perf_counter()
        carry, out = pipe.process(batch, carries[-1], first=i == 0)
        tc = time.perf_counter()
        outs.append({k: v.cpu().numpy() for k, v in out.items() if k != "gray"})
        td = time.perf_counter()
        spent["upload_s"] += tb - ta
        spent["process_s"] += tc - tb
        spent["to_host_s"] += td - tc
        carries.append(carry)
        i += 1
    window_s = time.perf_counter() - t0
    n_calls = len(outs)
    result = {"attempted": n_calls * b, "failed": 0,
              "metrics": {"setup_s": setup_s, "aruco_fps": n_calls * b / window_s}}

    if ctx.trace:
        result["record"] = traced(ctx, pipe, carries[-1], variants, n_calls)
    result["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    del pipe
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_cmp = time.perf_counter()
    checks = Checks(LIMITS)
    ref, _ = build_reference(ctx)
    sample = check_sample(rng, n_calls, traffic["check_batches"])
    for i in sample:
        rcarry, rout = ref.process(upload(call_frames(variants, traffic, i), dev), carries[i], first=i == 0)
        rout = {key: v.cpu().numpy() for key, v in rout.items() if key != "gray"}
        compare(outs[i], rout, carries[i + 1], rcarry, checks)
    result["checks"] = checks
    result["compared"] = len(sample) * b
    result["notes"] = {"setup": phases, "setup_s": setup_s, "window": spent, "sample": sample,
                       "detected_compared": int(sum(outs[i]["detected"].sum() for i in sample)),
                       "compare_s": time.perf_counter() - t_cmp}
    return result


def traced(ctx, pipe, carry, variants, first_call: int) -> dict:
    """The per-layer readings: one profiled stretch of the window's loop
    (K1-K5's arguments recorded for their bytes and operations), then the
    front and the scan each timed alone on one call's frames."""
    import importlib

    import torch
    from torch.profiler import record_function

    dev, traffic = ctx.device, ctx.traffic
    b = traffic["batch"]
    n_prof = max(1, PROFILED_FRAMES // b)
    calls, restore = [], []
    for key, (mod_name, fn_name, _, _) in yardstick.ARUCO_KERNELS.items():
        mod = importlib.import_module(mod_name)
        orig = getattr(mod, fn_name)

        def rec(*a, _orig=orig, _key=key, **kw):
            calls.append((_key, a, kw))
            return _orig(*a, **kw)

        setattr(mod, fn_name, rec)
        restore.append((mod, fn_name, orig))
    state = {"carry": carry}

    def stretch():
        for i in range(first_call, first_call + n_prof):
            frames = call_frames(variants, traffic, i)
            with record_function("bench.upload"):
                batch = upload(frames, dev)
            with record_function("bench.process"):
                state["carry"], out = pipe.process(batch, state["carry"], first=False)
            with record_function("bench.to_host"):
                {k: v.cpu().numpy() for k, v in out.items() if k != "gray"}

    try:
        rec_ = trace.profile(stretch, dev)
    finally:
        for mod, fn_name, orig in restore:
            setattr(mod, fn_name, orig)
    bound = sum(yardstick.bound_s(*yardstick.ARUCO_KERNELS[key][2](*a, **kw)) for key, a, kw in calls)
    names = tuple(n for v in yardstick.ARUCO_KERNELS.values() for n in v[3])
    kernel_s = sum(d for name, _, d in rec_["kernels"] if any(n in name for n in names)) * 1e-6
    batch = upload(call_frames(variants, traffic, first_call), dev)
    front = pipe.front(batch)
    firsts = [False] * b
    front_ms = clock.wall_ms(lambda: pipe.front(batch), dev)
    scan_ms = clock.wall_ms(lambda: pipe.scan(carry, front, firsts), dev)
    return {"frames": n_prof * b, "window_s": rec_["window_s"], "busy_s": rec_["busy_s"],
            "launches": rec_["launches"], "kernel_bound_s": bound, "kernel_s": kernel_s,
            "front_ms": front_ms / b, "scan_ms": scan_ms / b,
            "breakdown": {"device_ops": rec_["device_ops"], "idle_gaps": rec_["idle_gaps"]}}
