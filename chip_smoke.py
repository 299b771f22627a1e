#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100 / sm_90a).

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failed check exits non-zero; no phase is skipped):

1. build        -- compile every kernel (``apse_uav_torch/csrc``) with nvcc, one
                   process per source, all started together.
2. slice        -- render B 4K scenes (4 markers, host LEDs 0b1010, 40 m) with the
                   port's renderer on the card and run the two-pass
                   ``ArucoPipeline.process`` on ``cuda`` with every launch count
                   set to 0 just before; every kernel of the path (K1-K5) must
                   have launched, ids 1-4 must be measured in every frame, the
                   LEDs must decode, distances must be finite.  Times process,
                   front and scan, profiles one process call (device time by
                   kernel, idle share) and writes the results CSV into the
                   git-ignored output directory ``OUT_DIR``.
3. single_pass  -- the same frames through ``ArucoPipeline(two_pass=False)``
                   (K3 on the full frame, K2, K1), counts set to 0 just before,
                   with the same checks, times and profile; then its CPU run
                   on 2 frames against the card's.
4. preprocessor -- ``Preprocessor`` on the same frames in HWC (K3's RGB mode),
                   counts set to 0 just before; RGB and gray bit-identical to
                   the plain version.
5. kernels      -- each kernel against its plain PyTorch version on the card at
                   its path's shapes (K1 bit-identical labels; K2 same candidate
                   set per scale, scores within 5e-4; K3 bit-identical on the
                   pooled plan and on the full frame; K4 bit-identical to the
                   plain version and to K3's full frame on the selected tiles;
                   K5 bit-identical, pad included; K3's RGB mode bit-identical),
                   timed with CUDA events beside the plain version and one
                   PyTorch library call where one computes (part of) the same
                   function.
6. gpu-cpu      -- the first 2 frames through the two-pass port on the CPU
                   (plain versions) against the card's run.

Prints the card's name and power limit and a ``kernels`` JSON line before
the last line; the last line is the ``{"ok": true, "device": ...}`` object.
Exits non-zero without a result when no CUDA device is available or when the
``apse_uav_torch`` package is not beside this script.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out")  # listed in .gitignore
BATCH = 8
W, H = 3840, 2160
LEDS = 0b1010
# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s and the non-tensor
# 32-bit rate, used for the bound of every kernel here.
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12
# The TPU function each kernel replaces: file:line of its pl.pallas_call,
# relative to the JAX reference package (PERF.md names the full paths).
REPLACES = {
    "labeling": "aruco/pallas_labeling.py:116",
    "proposals": "aruco/pallas_proposals.py:327",
    "remap_full": "preproc/pallas_remap.py:1259",
    "remap_selected": "preproc/pallas_remap.py:1335",
    "pool": "preproc/pallas_pool.py:56",
    "remap_full_rgb": "preproc/pallas_remap.py:1259",
}


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


class SmokeFailure(Exception):
    """A failed check.  Nothing catches it: the script stops with a non-zero
    exit code and prints no result line."""


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def wall_ms(fn, iters: int = 3) -> float:
    """Host-clock time of fn() per call, ending in a device synchronize."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / PEAK_OPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def profile_process(pipe, frames, carry, call_ms: float) -> dict:
    """Device time over one ``process`` call (torch.profiler, CUPTI): the sum
    of its kernels' times, their number, the device's idle share of the
    unprofiled call time ``call_ms``, and the largest entries by PyTorch op
    and by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # The trace missed the first kernel of the window (the single-pass
        # front's 3 ms K3 launch) until one tiny op ran ahead of it.
        torch.ones(1, device=frames.device).add_(1)
        torch.cuda.synchronize()
        pipe.process(frames, carry, first=True)
        torch.cuda.synchronize()

    def dev_ms(e):
        return (getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)) / 1e3

    kernels, ops = [], []
    for e in prof.key_averages():
        if dev_ms(e) > 0:
            on_card = e.device_type == torch.autograd.DeviceType.CUDA
            (kernels if on_card else ops).append((e.key, dev_ms(e), e.count))
    busy_ms = sum(r[1] for r in kernels)

    def top(rows):
        return [[k[:60], round(ms, 3), n] for k, ms, n in sorted(rows, key=lambda r: -r[1])[:12]]

    return {"call_ms": round(call_ms, 3), "device_busy_ms": round(busy_ms, 3),
            "device_idle_share": round(1.0 - busy_ms / call_ms, 4), "kernel_launches": sum(r[2] for r in kernels),
            "top_ops": top(ops), "top_kernels": top(kernels)}


def run_path(pipe, frames, cfg, dev, names) -> tuple[dict, dict]:
    """One ``process`` call of ``pipe`` with every launch count set to 0 just
    before; fails unless every kernel in ``names`` launched, ids 1-4 were
    measured in every frame, the LEDs decoded and the distances are finite.
    Returns (outputs as numpy, launch counts)."""
    import torch

    from apse_uav_torch import _build
    from apse_uav_torch.aruco.pipeline import init_carry

    _build.reset_counts()
    _, out = pipe.process(frames, init_carry(cfg, dev), first=True)
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    missing = [n for n in names if counts.get(n, 0) == 0]
    if missing:
        raise SmokeFailure(f"kernels not launched on the path: {missing} (counts {counts})")
    out_np = {k: v.cpu().numpy() for k, v in out.items()}
    if not out_np["measured"].all():
        raise SmokeFailure(f"ids 1-4 not measured in every frame: {out_np['measured'].tolist()}")
    if not (out_np["leds"] == LEDS).all():
        raise SmokeFailure(f"LEDs decode to {out_np['leds'].tolist()}, rendered {LEDS}")
    for key in ("dist_aruco", "dist_aruco_bbox", "altitude", "marker_length"):
        if not np.isfinite(out_np[key]).all():
            raise SmokeFailure(f"{key} not finite")
    return out_np, counts


def path_times(pipe, frames, cfg, dev) -> dict:
    """Host-clock ms of process, front and scan on the batch."""
    from apse_uav_torch.aruco.pipeline import init_carry

    front = pipe.front(frames)
    firsts = [True] + [False] * (frames.shape[0] - 1)
    return {"process_ms": wall_ms(lambda: pipe.process(frames, init_carry(cfg, dev), first=True)),
            "front_ms": wall_ms(lambda: pipe.front(frames)),
            "scan_ms": wall_ms(lambda: pipe.scan(init_carry(cfg, dev), front, firsts))}


def gpu_vs_cpu(pipe, cpipe, cfg, two, dev) -> dict:
    """The port on the CPU (plain versions) against the card on the frames
    ``two``: same detections and LEDs, corners within 0.05 px, distance
    columns within 1 cm (the slice tolerances of the port against JAX)."""
    import torch

    from apse_uav_torch.aruco.pipeline import init_carry

    t0 = time.perf_counter()
    _, gout = pipe.process(two, init_carry(cfg, dev), first=True)
    _, cout = cpipe.process(two.cpu(), init_carry(cfg, "cpu"), first=True)
    g = {k: v.cpu() for k, v in gout.items()}
    corner_err = float((g["corners"] - cout["corners"]).abs().where(cout["measured"][..., None, None], 0.0).max())
    dist_err = max(float((g[k] - cout[k]).abs().max()) for k in ("dist_aruco", "dist_aruco_bbox"))
    res = {"seconds": round(time.perf_counter() - t0, 3), "corner_err_px": corner_err, "dist_err_m": dist_err,
           "leds_gpu": g["leds"].tolist(), "leds_cpu": cout["leds"].tolist()}
    for key in ("detected", "measured", "leds"):
        if not torch.equal(g[key], cout[key]):
            raise SmokeFailure(f"GPU vs CPU: {key} differ: {g[key].tolist()} vs {cout[key].tolist()}")
    if corner_err > 0.05 or dist_err > 0.01:
        raise SmokeFailure(f"GPU vs CPU: corners {corner_err} px (limit 0.05), distances {dist_err} m (limit 0.01)")
    return res


def scene_specs(i: int):
    from apse_uav_torch.utils.synthetic import MarkerSpec

    return [
        MarkerSpec(4, (0.5, -2.0), yaw_deg=14.0 + 7 * i, leds=LEDS),
        MarkerSpec(1, (7.5, 3.0), yaw_deg=40.0 + 5 * i),
        MarkerSpec(2, (-9.0, 2.0), yaw_deg=70.0 - 9 * i),
        MarkerSpec(3, (4.0, -6.5), yaw_deg=5.0 + 11 * i),
    ]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "apse_uav_torch")):
        print("chip_smoke: the apse_uav_torch package is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    card = smi[0].strip() if smi else "unknown"
    dev = torch.device("cuda", 0)

    from apse_uav_torch import _build
    from apse_uav_torch.aruco import cuda_labeling, cuda_proposals, detector as det, patch_select
    from apse_uav_torch.aruco.pipeline import ArucoPipeline, ArucoPipelineConfig, init_carry
    from apse_uav_torch.core import camera
    from apse_uav_torch.preproc import cuda_pool, cuda_remap, remap, twopass
    from apse_uav_torch.utils import csv_io
    from apse_uav_torch.utils.synthetic import render_scene

    # -- 1. build -------------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build()
    ptxas = {name: [ln.strip() for ln in text.splitlines() if "registers" in ln or "bytes smem" in ln]
             for name, text in logs.items()}
    log({"phase": "build", "seconds": round(time.perf_counter() - t0, 3), "ptxas": ptxas})

    # -- 2. the two-pass slice at full width --------------------------------------
    mtx, dist = camera.load_camera_params(os.path.join(REPO, "data", "cam_params.json"))
    t0 = time.perf_counter()
    frames_hwc = torch.stack([render_scene(mtx, dist, (W, H), scene_specs(i), altitude=40.0, supersample=1, device=dev)
                              for i in range(BATCH)])
    frames = frames_hwc.permute(0, 3, 1, 2).contiguous()
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    cfg = ArucoPipelineConfig()
    pipe = ArucoPipeline(mtx, dist, (W, H), cfg, device=dev)
    t0 = time.perf_counter()
    out_np, counts = run_path(pipe, frames, cfg, dev, (cuda_labeling.NAME, cuda_proposals.NAME, cuda_remap.K3,
                                                        cuda_remap.K4, cuda_pool.NAME))
    first_s = time.perf_counter() - t0
    layers = path_times(pipe, frames, cfg, dev)
    profile = profile_process(pipe, frames, init_carry(cfg, dev), layers["process_ms"])
    os.makedirs(OUT_DIR, exist_ok=True)
    with csv_io.ResultsWriter(os.path.join(OUT_DIR, "chip_smoke_results.csv"), False) as writer:
        for i in range(BATCH):
            writer.write_frame(i + 1, {k: v[i] for k, v in out_np.items()})
    log({"phase": "slice", "frames": BATCH, "size": [W, H], "render_s": round(render_s, 3),
         "first_process_s": round(first_s, 3), "frames_per_s": round(BATCH * 1e3 / layers["process_ms"], 3),
         **layers, "launches": counts, "detected": out_np["detected"].tolist(), "leds": out_np["leds"].tolist(),
         "dist_aruco": out_np["dist_aruco"].round(4).tolist(), "card": card})
    log({"phase": "profile", **profile})

    # -- 3. the single-pass front at full width ----------------------------------
    scfg = ArucoPipelineConfig(two_pass=False)
    spipe = ArucoPipeline(mtx, dist, (W, H), scfg, device=dev)
    sout, scounts = run_path(spipe, frames, scfg, dev, (cuda_labeling.NAME, cuda_proposals.NAME, cuda_remap.K3))
    slayers = path_times(spipe, frames, scfg, dev)
    sprofile = profile_process(spipe, frames, init_carry(scfg, dev), slayers["process_ms"])
    log({"phase": "single_pass", "frames": BATCH, "size": [W, H],
         "frames_per_s": round(BATCH * 1e3 / slayers["process_ms"], 3), **slayers, "launches": scounts,
         "detected": sout["detected"].tolist(), "leds": sout["leds"].tolist(),
         "dist_aruco": sout["dist_aruco"].round(4).tolist(), "card": card})
    log({"phase": "single_pass_profile", **sprofile})
    scpipe = ArucoPipeline(mtx, dist, (W, H), scfg, device="cpu")
    log({"phase": "single_pass_gpu_cpu", **gpu_vs_cpu(spipe, scpipe, scfg, frames[:2], dev)})

    # -- 4. Preprocessor (K3's RGB mode) on the HWC frames ------------------------
    pre = remap.Preprocessor(mtx, dist, (W, H), device=dev)
    _build.reset_counts()
    rgb, gray_rgb = pre(frames_hwc)
    torch.cuda.synchronize()
    pcounts = dict(_build.launches)
    if pcounts.get(cuda_remap.K3_RGB, 0) == 0:
        raise SmokeFailure(f"{cuda_remap.K3_RGB} not launched by Preprocessor (counts {pcounts})")
    rgb_plain, gray_plain = remap.remap_rgb_gray_u8(frames_hwc, pre.map_xy, hwc=True)
    rgb_err = int((rgb.to(torch.int32) - rgb_plain.to(torch.int32)).abs().max())
    gray_rgb_err = int((gray_rgb.to(torch.int32) - gray_plain.to(torch.int32)).abs().max())
    if rgb_err or gray_rgb_err:
        raise SmokeFailure(f"K3 RGB mode vs plain: RGB differs by up to {rgb_err}, gray by up to {gray_rgb_err}")
    one_rgb, one_gray = pre(frames_hwc[0], with_gray=False)
    if one_gray is not None or not torch.equal(one_rgb, rgb[0]):
        raise SmokeFailure("Preprocessor on one frame without gray differs from the batch call")
    log({"phase": "preprocessor", "frames": BATCH, "size": [W, H], "launches": pcounts,
         "ms": round(wall_ms(lambda: pre(frames_hwc)), 3), "rgb_max_abs_err": rgb_err,
         "gray_max_abs_err": gray_rgb_err, "card": card})
    del rgb_plain, gray_plain

    # -- 5. every kernel against its plain version -----------------------------
    p = pipe.params
    st = p.proposal_stride
    kernels = []

    # K5 over the whole padded output, and K3 on the pooled plan.
    pooled_src = cuda_pool.pool_source(frames, st, pipe._pooled_hw)
    pooled_plain = twopass.pool_source_u8(frames, st, pipe._pooled_hw)
    k5_err = int((pooled_src.to(torch.int32) - pooled_plain.to(torch.int32)).abs().max())
    if k5_err:
        raise SmokeFailure(f"K5 vs plain: pooled bytes differ by up to {k5_err} levels (pad included)")
    k3 = cuda_remap.remap_gray(pooled_src, pipe.map_pooled, *pipe._pooled_tiles)
    k3_plain = remap.remap_gray_u8(pooled_src, pipe.map_pooled)
    # Bit-identical: kernel and plain round alike (-fmad=false, rintf, IEEE
    # division).
    d3 = (k3.to(torch.int32) - k3_plain.to(torch.int32)).abs()
    if int(d3.max()):
        raise SmokeFailure(f"K3 vs plain: {int((d3 > 0).sum())} pixels differ, by up to {int(d3.max())} levels")
    # K2 on the (B, 540, 960) pool.
    pool = k3[:, : H // st, : W // st].to(torch.float32)
    props = cuda_proposals.proposals_from_pool(pool, H, W, p)
    props_plain = det._proposals_from_pool(pool, H, W, p)
    k2_err = 0.0
    for b in range(BATCH):
        for a in range(0, props[0].shape[1], p.per_scale_k):
            sl = slice(a, a + p.per_scale_k)

            def cand(pr):
                c, s, v, ok = (t[b, sl].cpu() for t in pr)
                return {(float(cc[0]), float(cc[1]), float(ss)): float(vv) for cc, ss, vv, o in zip(c, s, v, ok) if o}

            got, want = cand(props), cand(props_plain)
            if set(got) != set(want):
                raise SmokeFailure(f"K2 vs plain: frame {b} scale {a // p.per_scale_k}: {got} != {want}")
            k2_err = max([k2_err] + [abs(got[key] - want[key]) for key in got])
    if k2_err > 5e-4:
        raise SmokeFailure(f"K2 vs plain: score error {k2_err}")
    # K1 on the (60 B, 64, 64) windows of the real frames plus random masks.
    centers, sizes, scores, valid = props
    full_gray = cuda_remap.remap_gray(frames, pipe.map_full, pipe._sel_th, pipe._sel_tw)
    _, darks = det.binarized_windows(full_gray.to(torch.float32), centers, sizes, p)
    gen = torch.Generator(device=dev).manual_seed(0)
    noise = torch.rand((darks.shape[0] // 4, p.window, p.window), generator=gen, device=dev) < 0.5
    darks = torch.cat([darks, noise]).contiguous()
    lab = cuda_labeling.labels(darks)
    lab_plain = det._label_sweeps(darks)
    k1_err = int((lab != lab_plain).sum())
    if k1_err:
        raise SmokeFailure(f"K1 vs plain: {k1_err} labels differ")
    # K4 on the full-res plan with -1 padding and duplicated tile ids.
    sel, _ = patch_select.select_tiles_batched(
        centers, valid, h=H, w=W, th=pipe._sel_th, tw=pipe._sel_tw, groups=pipe._groups,
        t_sel=cfg.sel_tile_budget, per_scale_k=p.per_scale_k)
    sel = torch.cat([sel, sel[:, :8], torch.full((BATCH, 8), -1, dtype=torch.int32, device=dev)], dim=1).contiguous()
    k4 = cuda_remap.remap_gray_selected(frames, pipe.map_full, sel, pipe._sel_th, pipe._sel_tw)
    full_plain = remap.remap_gray_u8(frames, pipe.map_full)
    d_full = (full_gray.to(torch.int32) - full_plain.to(torch.int32)).abs()
    if int(d_full.max()):
        raise SmokeFailure(f"K3 vs plain, full frame: {int((d_full > 0).sum())} pixels differ, by up to {int(d_full.max())}")
    nty, ntx = H // pipe._sel_th, W // pipe._sel_tw
    picked = torch.zeros((BATCH, nty * ntx), dtype=torch.bool, device=dev)
    fr, slot = (sel >= 0).nonzero(as_tuple=True)
    picked[fr, sel[fr, slot].long()] = True
    n_sel_tiles = int(picked.sum())
    on_sel = picked.reshape(BATCH, nty, 1, ntx, 1).expand(-1, -1, pipe._sel_th, -1, pipe._sel_tw).reshape(BATCH, H, W)
    k4_err = int(torch.where(on_sel, (k4.to(torch.int32) - full_plain.to(torch.int32)).abs(), 0).max())
    if k4_err:
        raise SmokeFailure(f"K4 vs plain on the selected tiles: differs by up to {k4_err} levels")
    if not torch.equal(k4[on_sel], full_gray[on_sel]):
        raise SmokeFailure("K4 vs K3 full frame: selected tiles differ")
    if not torch.equal(gray_rgb, full_gray):
        raise SmokeFailure("K3's RGB mode: gray differs from K3's gray-only launch on the full frame")
    del full_plain, d_full

    # Timings at the paths' shapes.
    import torch.nn.functional as F

    def grid_sample_call(src, map_xy):
        h_in, w_in = src.shape[-2:]
        grid = torch.stack([map_xy[..., 0] * (2.0 / (w_in - 1)) - 1.0, map_xy[..., 1] * (2.0 / (h_in - 1)) - 1.0], -1)
        grid = grid[None].expand(src.shape[0], -1, -1, -1)
        srcf = src.to(torch.float32)
        return lambda: F.grid_sample(srcf, grid, mode="bilinear", padding_mode="zeros", align_corners=True)

    n3 = pooled_src.shape[0] * pipe.map_pooled.shape[0] * pipe.map_pooled.shape[1]
    tile_px = pipe._sel_th * pipe._sel_tw
    h4, w4 = H // st, W // st
    plans = det.scale_plans(H, W, p)
    k2_ops = BATCH * h4 * w4 * (2 + sum(20 + 2 * (2 * e.r_d + 1) + 4 for e in plans))
    n_blocks = -(-h4 // max(1, 8192 // w4))
    n_rgb = BATCH * H * W
    frames_f32 = frames.to(torch.float32)
    rows = [
        ("labeling", "apse_uav_torch/csrc/labeling.cu", REPLACES["labeling"],
         cuda_labeling.NAME, k1_err,
         lambda: cuda_labeling.labels(darks), lambda: det._label_sweeps(darks), None,
         bound(darks.numel() * 5, darks.shape[0] * 500e3)),
        ("proposals", "apse_uav_torch/csrc/proposals.cu", REPLACES["proposals"],
         cuda_proposals.NAME, k2_err,
         lambda: cuda_proposals.proposals_from_pool(pool, H, W, p), lambda: det._proposals_from_pool(pool, H, W, p),
         None, bound(pool.numel() * 4 + BATCH * len(plans) * n_blocks * p.per_scale_k * 8, k2_ops)),
        ("remap_full", "apse_uav_torch/csrc/remap.cu",
         REPLACES["remap_full"], cuda_remap.K3, int(d3.max()),
         lambda: cuda_remap.remap_gray(pooled_src, pipe.map_pooled, *pipe._pooled_tiles),
         lambda: remap.remap_gray_u8(pooled_src, pipe.map_pooled), grid_sample_call(pooled_src, pipe.map_pooled),
         bound(pooled_src.numel() + n3, n3 * 300)),
        ("remap_selected", "apse_uav_torch/csrc/remap.cu",
         REPLACES["remap_selected"], cuda_remap.K4, k4_err,
         lambda: cuda_remap.remap_gray_selected(frames, pipe.map_full, sel, pipe._sel_th, pipe._sel_tw),
         lambda: remap.remap_gray_u8(frames, pipe.map_full), grid_sample_call(frames, pipe.map_full),
         bound(n_sel_tiles * tile_px * 4, n_sel_tiles * tile_px * 300)),
        # Library yardstick: F.avg_pool2d on the f32 frame (no u8 rounding, no pad).
        ("pool", "apse_uav_torch/csrc/pool.cu", REPLACES["pool"], cuda_pool.NAME, k5_err,
         lambda: cuda_pool.pool_source(frames, st, pipe._pooled_hw),
         lambda: twopass.pool_source_u8(frames, st, pipe._pooled_hw), lambda: F.avg_pool2d(frames_f32, st),
         bound(frames.numel() + pooled_src.numel(), pooled_src.numel() * 16)),
        # Bytes: source + map + RGB + gray; operations: ~300 a pixel, as K3.
        ("remap_full_rgb", "apse_uav_torch/csrc/remap.cu", REPLACES["remap_full_rgb"], cuda_remap.K3_RGB, rgb_err,
         lambda: pre(frames_hwc), lambda: remap.remap_rgb_gray_u8(frames_hwc, pre.map_xy, hwc=True),
         grid_sample_call(frames, pre.map_xy),
         bound(frames_hwc.numel() + pre.map_xy.numel() * 4 + n_rgb * 3 + n_rgb, n_rgb * 300)),
    ]
    for name, source, repl, key, err, kern, plain, lib, (b_ms, b_by) in rows:
        ms = cuda_ms(kern)
        plain_ms = cuda_ms(plain, iters=3, warmup=1)
        lib_ms = cuda_ms(lib) if lib is not None else None
        # Launches in the run of the kernel's own path: Preprocessor for K3's RGB
        # mode, the two-pass main path for the others (the single_pass phase
        # prints that path's counts).
        launches = pcounts.get(key, 0) if key == cuda_remap.K3_RGB else counts.get(key, 0)
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": repl,
                        "launches": launches, "max_abs_err": float(err), "ms": round(ms, 4),
                        "plain_ms": round(plain_ms, 4), "bound_ms": round(b_ms, 5), "bound_by": b_by,
                        "library_ms": None if lib_ms is None else round(lib_ms, 4)})
    # K3 at the single-pass front's shape (the full frame), beside the row's pooled plan.
    k3_full_ms = cuda_ms(lambda: cuda_remap.remap_gray(frames, pipe.map_full, pipe._sel_th, pipe._sel_tw))
    log({"phase": "kernels", "k3_pooled_pixels": d3.numel(), "k3_fullres_pixels": full_gray.numel(),
         "k3_fullres_ms": round(k3_full_ms, 4),
         "k4_selected_pixels": int(on_sel.sum()), "k4_selected_tiles": n_sel_tiles, "k2_max_score_err": k2_err,
         "k5_pooled_bytes": pooled_src.numel(), "k3_rgb_pixels": n_rgb,
         "library_calls": {"remap_full": "F.grid_sample f32, no LAB chain", "remap_selected": "F.grid_sample f32",
                           "pool": "F.avg_pool2d f32, no u8 rounding, no pad",
                           "remap_full_rgb": "F.grid_sample f32, no LAB chain"},
         "card": card})

    # -- 6. GPU against CPU, two-pass ---------------------------------------------
    cpipe = ArucoPipeline(mtx, dist, (W, H), cfg, device="cpu")
    log({"phase": "gpu-cpu", **gpu_vs_cpu(pipe, cpipe, cfg, frames[:2], dev)})

    print(card)
    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
