#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100 / sm_90a).

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failed check exits non-zero; no phase is skipped):

1. build   -- compile every kernel of the main path (``apse_uav_torch/csrc``)
              with nvcc, one process per source, all started together.
2. slice   -- render B 4K scenes (4 markers, host LEDs 0b1010, 40 m) with the
              port's renderer on the card and run ``ArucoPipeline.process``
              on ``cuda`` with every launch count set to 0 just before; every
              kernel must have launched, ids 1-4 must be measured in every
              frame, the LEDs must decode, distances must be finite.  Times
              process, front and scan, profiles one process call (device
              time by kernel, idle share) and writes the results CSV into
              the git-ignored output directory ``OUT_DIR``.
3. kernels -- each kernel against its plain PyTorch version on the card at
              the main path's shapes (K1 bit-identical labels; K2 same
              candidate set per scale, scores within 5e-4; K3 bit-identical
              on the pooled plan and on the full frame; K4 bit-identical to
              the plain version and to K3's full frame on the selected
              tiles), timed with CUDA
              events beside the plain version and one PyTorch library call
              where one computes the same function.
4. gpu-cpu -- the first 2 frames through the port on the CPU (plain
              versions) against the card's run.

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
}


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


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
        return [[k[:60], round(ms, 3), n] for k, ms, n in sorted(rows, key=lambda r: -r[1])[:8]]

    return {"call_ms": round(call_ms, 3), "device_busy_ms": round(busy_ms, 3),
            "device_idle_share": round(1.0 - busy_ms / call_ms, 4), "kernel_launches": sum(r[2] for r in kernels),
            "top_ops": top(ops), "top_kernels": top(kernels)}


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
    from apse_uav_torch.preproc import cuda_remap, remap, twopass
    from apse_uav_torch.utils import csv_io
    from apse_uav_torch.utils.synthetic import render_scene

    # -- 1. build -------------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build()
    ptxas = {name: [ln.strip() for ln in text.splitlines() if "registers" in ln or "bytes smem" in ln]
             for name, text in logs.items()}
    log({"phase": "build", "seconds": round(time.perf_counter() - t0, 3), "ptxas": ptxas})

    # -- 2. the slice at full width ---------------------------------------------
    mtx, dist = camera.load_camera_params(os.path.join(REPO, "data", "cam_params.json"))
    t0 = time.perf_counter()
    frames = torch.stack([
        render_scene(mtx, dist, (W, H), scene_specs(i), altitude=40.0, supersample=1, device=dev).permute(2, 0, 1)
        for i in range(BATCH)
    ]).contiguous()
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    cfg = ArucoPipelineConfig()
    pipe = ArucoPipeline(mtx, dist, (W, H), cfg, device=dev)
    _build.reset_counts()
    t0 = time.perf_counter()
    _, out = pipe.process(frames, init_carry(cfg, dev), first=True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = dict(_build.launches)
    names = (cuda_labeling.NAME, cuda_proposals.NAME, cuda_remap.K3, cuda_remap.K4)
    missing = [n for n in names if counts.get(n, 0) == 0]
    if missing:
        return fail(f"kernels not launched on the main path: {missing} (counts {counts})")
    process_ms = wall_ms(lambda: pipe.process(frames, init_carry(cfg, dev), first=True))
    fps = BATCH * 1e3 / process_ms
    front = pipe.front(frames)
    firsts = [True] + [False] * (BATCH - 1)
    layers = {"process_ms": process_ms, "front_ms": wall_ms(lambda: pipe.front(frames)),
              "scan_ms": wall_ms(lambda: pipe.scan(init_carry(cfg, dev), front, firsts))}
    out_np = {k: v.cpu().numpy() for k, v in out.items()}
    profile = profile_process(pipe, frames, init_carry(cfg, dev), process_ms)
    os.makedirs(OUT_DIR, exist_ok=True)
    csv_path = os.path.join(OUT_DIR, "chip_smoke_results.csv")
    with csv_io.ResultsWriter(csv_path, False) as writer:
        for i in range(BATCH):
            writer.write_frame(i + 1, {k: v[i] for k, v in out_np.items()})
    log({"phase": "slice", "frames": BATCH, "size": [W, H], "render_s": round(render_s, 3),
         "first_process_s": round(first_s, 3), "frames_per_s": round(fps, 3), **layers, "launches": counts,
         "detected": out_np["detected"].tolist(), "leds": out_np["leds"].tolist(),
         "dist_aruco": out_np["dist_aruco"].round(4).tolist(), "card": card})
    log({"phase": "profile", **profile})
    if not out_np["measured"].all():
        return fail(f"ids 1-4 not measured in every frame: {out_np['measured'].tolist()}")
    if not (out_np["leds"] == LEDS).all():
        return fail(f"LEDs decode to {out_np['leds'].tolist()}, rendered {LEDS}")
    for key in ("dist_aruco", "dist_aruco_bbox", "altitude", "marker_length"):
        if not torch.isfinite(out[key]).all():
            return fail(f"{key} not finite")

    # -- 3. every kernel against its plain version -----------------------------
    p = pipe.params
    st = p.proposal_stride
    kernels = []

    # K3 on the pooled plan.
    pooled_src = twopass.pool_source_u8(frames, st, pipe._pooled_hw)
    k3 = cuda_remap.remap_gray(pooled_src, pipe.map_pooled, *pipe._pooled_tiles)
    k3_plain = remap.remap_gray_u8(pooled_src, pipe.map_pooled)
    # Bit-identical: kernel and plain round alike (-fmad=false, rintf, IEEE
    # division).
    d3 = (k3.to(torch.int32) - k3_plain.to(torch.int32)).abs()
    if int(d3.max()):
        return fail(f"K3 vs plain: {int((d3 > 0).sum())} pixels differ, by up to {int(d3.max())} levels")
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
                return fail(f"K2 vs plain: frame {b} scale {a // p.per_scale_k}: {got} != {want}")
            k2_err = max([k2_err] + [abs(got[key] - want[key]) for key in got])
    if k2_err > 5e-4:
        return fail(f"K2 vs plain: score error {k2_err}")
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
        return fail(f"K1 vs plain: {k1_err} labels differ")
    # K4 on the full-res plan with -1 padding and duplicated tile ids.
    sel, _ = patch_select.select_tiles_batched(
        centers, valid, h=H, w=W, th=pipe._sel_th, tw=pipe._sel_tw, groups=pipe._groups,
        t_sel=cfg.sel_tile_budget, per_scale_k=p.per_scale_k)
    sel = torch.cat([sel, sel[:, :8], torch.full((BATCH, 8), -1, dtype=torch.int32, device=dev)], dim=1).contiguous()
    k4 = cuda_remap.remap_gray_selected(frames, pipe.map_full, sel, pipe._sel_th, pipe._sel_tw)
    full_plain = remap.remap_gray_u8(frames, pipe.map_full)
    d_full = (full_gray.to(torch.int32) - full_plain.to(torch.int32)).abs()
    if int(d_full.max()):
        return fail(f"K3 vs plain, full frame: {int((d_full > 0).sum())} pixels differ, by up to {int(d_full.max())}")
    nty, ntx = H // pipe._sel_th, W // pipe._sel_tw
    picked = torch.zeros((BATCH, nty * ntx), dtype=torch.bool, device=dev)
    fr, slot = (sel >= 0).nonzero(as_tuple=True)
    picked[fr, sel[fr, slot].long()] = True
    n_sel_tiles = int(picked.sum())
    on_sel = picked.reshape(BATCH, nty, 1, ntx, 1).expand(-1, -1, pipe._sel_th, -1, pipe._sel_tw).reshape(BATCH, H, W)
    k4_err = int(torch.where(on_sel, (k4.to(torch.int32) - full_plain.to(torch.int32)).abs(), 0).max())
    if k4_err:
        return fail(f"K4 vs plain on the selected tiles: differs by up to {k4_err} levels")
    if not torch.equal(k4[on_sel], full_gray[on_sel]):
        return fail("K4 vs K3 full frame: selected tiles differ")

    # Timings at the main path's shapes.
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
    ]
    for name, source, repl, key, err, kern, plain, lib, (b_ms, b_by) in rows:
        ms = cuda_ms(kern)
        plain_ms = cuda_ms(plain, iters=3, warmup=1)
        lib_ms = cuda_ms(lib) if lib is not None else None
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": repl,
                        "launches": counts.get(key, 0), "max_abs_err": float(err), "ms": round(ms, 4),
                        "plain_ms": round(plain_ms, 4), "bound_ms": round(b_ms, 5), "bound_by": b_by,
                        "library_ms": None if lib_ms is None else round(lib_ms, 4)})
    log({"phase": "kernels", "k3_pooled_pixels": d3.numel(), "k3_fullres_pixels": d_full.numel(),
         "k4_selected_pixels": int(on_sel.sum()), "k4_selected_tiles": n_sel_tiles, "k2_max_score_err": k2_err,
         "card": card})

    # -- 4. GPU against CPU ------------------------------------------------------
    t0 = time.perf_counter()
    two = frames[:2]
    _, gout = pipe.process(two, init_carry(cfg, dev), first=True)
    cpipe = ArucoPipeline(mtx, dist, (W, H), cfg, device="cpu")
    _, cout = cpipe.process(two.cpu(), init_carry(cfg, "cpu"), first=True)
    g = {k: v.cpu() for k, v in gout.items()}
    corner_err = float((g["corners"] - cout["corners"]).abs().where(cout["measured"][..., None, None], 0.0).max())
    dist_err = max(float((g[k] - cout[k]).abs().max()) for k in ("dist_aruco", "dist_aruco_bbox"))
    log({"phase": "gpu-cpu", "seconds": round(time.perf_counter() - t0, 3), "corner_err_px": corner_err,
         "dist_err_m": dist_err, "leds_gpu": g["leds"].tolist(), "leds_cpu": cout["leds"].tolist()})
    for key in ("detected", "measured", "leds"):
        if not torch.equal(g[key], cout[key]):
            return fail(f"GPU vs CPU: {key} differ: {g[key].tolist()} vs {cout[key].tolist()}")
    if corner_err > 0.05 or dist_err > 0.01:
        return fail(f"GPU vs CPU: corners {corner_err} px (limit 0.05), distances {dist_err} m (limit 0.01)")

    print(card)
    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
