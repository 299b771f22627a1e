#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100 / sm_90a).

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failed check exits non-zero; no phase is skipped):

1. build        -- compile every kernel (``apse_uav_torch/csrc``) with nvcc, one
                   process per source, all started together.
2. slice        -- render B 4K scenes (4 markers, host LEDs 0b1010, 40 m) with the
                   port's renderer on the card, set every launch count to 0,
                   build the two-pass ``ArucoPipeline`` on ``cuda`` (its colour
                   table) and run ``process``; every kernel of the path (the
                   colour table, K1-K5) must have launched, ids 1-4 must be
                   measured in every frame, the LEDs must decode, distances
                   must be finite.  Times process, front and scan, profiles
                   one process call (device time by kernel, idle share) and
                   writes the results CSV into the git-ignored output
                   directory ``OUT_DIR``.
3. single_pass  -- the same frames through ``ArucoPipeline(two_pass=False)``
                   (its colour table, K3 on the full frame, K2, K1), counts set
                   to 0 just before it is built, with the same checks, times
                   and profile; then its CPU run on 2 frames against the card's.
4. preprocessor -- ``Preprocessor`` built and run on the same frames in HWC
                   (its packed colour table, K3's RGB mode), counts set to 0
                   just before; RGB and gray bit-identical to the plain version.
5. kernels      -- each kernel against its plain PyTorch version on the card at
                   its path's shapes (the colour tables bit-identical; K1
                   bit-identical labels, also on masks its fixed schedule does
                   not converge on; K2 same candidate set per scale, scores
                   within 5e-4; K3 bit-identical on the pooled plan and on the
                   full frame; K4 bit-identical to the plain version and to K3's
                   full frame on the selected tiles; K5 bit-identical, pad
                   included; K3's RGB mode bit-identical), again on a batch of
                   uniform random frames (every remap kernel and K5
                   bit-identical); the colour tables' build time; one call of
                   each redesigned wrapper (K1, K2, K3, K4, K3-RGB) under
                   ``torch.cuda.set_sync_debug_mode("error")``; each kernel timed
                   with CUDA events (the wrapper call) and torch.profiler (its
                   kernels' device time alone) beside the plain version and one
                   PyTorch library call where one computes (part of) the same
                   function.  Then the tracker's gated auction kernels: the
                   warp kernel at the tracker's 32x32 on 200 seeded problems
                   (every kind of ``utils.synthetic.auction_problem``) and 7
                   crafted ones (``auction_crafted``: ties everywhere, budget
                   exhaustion, one column, every cost at the threshold, no
                   valid row or column), the block kernel on 52 problems above
                   32x32 (33x32, 32x33, 40x70, one at 1024x1024), each at the
                   budgets 128, 1, 2, 3 and 5, col_of_row and the sweep count
                   identical to the plain version's CPU run and each solve on
                   the kernel its shape takes (counted); one call under
                   sync-as-error; timed on a seeded problem with CUDA events
                   and the profiler beside the plain version on the card.
                   Then X101's grouped 3x3 kernel (``csrc/gconv.cu``) at its
                   7 distinct shapes at batch 4: within GCONV_BOUND_C x K x
                   2**-24 x conv2d(|x|, |w|) of ``F.conv2d`` (TF32 off), two
                   runs bit-identical, one launch a call; kernel, wrapper,
                   cuDNN and bound ms by shape and over the 33 a frame; then
                   one X101 ``TrackPredictor`` forward on 4 of the frames
                   (768x1344 padded, seeded weights) counts 33 launches, one
                   a ``track.gconv`` span: the ``kernels`` row's launches.
6. gpu-cpu      -- the first 2 frames through the two-pass port on the CPU
                   (plain versions) against the card's run.
7. tracker      -- the DCNN tracking path: the same 8 frames (HWC, numpy) through
                   ``track_uav``'s own loop (``cli.track_uav.track``) in batches of
                   4 with ``--preprocess data/cam_params.json`` (K3's RGB mode),
                   Mask R-CNN R101-FPN at full width (``uav_tracker_config()``) from
                   a seeded detectron2 checkpoint (its background bias set from
                   the frames, ``calibrate_background``, and its classes
                   relabelled so that most detections are cars and pedestrians,
                   ``favour_classes``) saved as ``.pth`` under
                   ``OUT_DIR`` and loaded through ``--weights`` (removed after),
                   the CSV written under ``OUT_DIR``; counts set to 0 just
                   before.  K3-RGB must launch, every frame must hold a
                   detection above the confidence and a track, ids >= 1 and
                   never reused, 8 CSV rows.  Then ms per batch of each stage,
                   frames/s, one batch profiled (device busy, idle share,
                   launches), its host syncs (``set_sync_debug_mode("warn")``)
                   and peak memory; the NMS fixed points' ms, calls and
                   convergence tests a batch (each call alone, between two
                   synchronizes); the association stage's ms, syncs, kernel
                   launches and auction sweeps per frame, and the CLI run's
                   sweeps per frame and frames at the 128-sweep budget (the
                   auction's warp kernel must launch once a frame, its block
                   kernel never); and the first frame on the CPU (plain
                   versions) against the card: p2-p6 within 1e-4 of each map's
                   max-abs, the same valid ids and classes, boxes within 0.5 px,
                   the same CSV row.
8. tracker_eval -- ``tracker_test``'s loop (``track_sequence``) over the same
                   frames, ``--preprocess``, phase 7's calibrated weights saved
                   as the port's checkpoint (``--checkpoint``) and its default
                   re-ID head through ``--assoc_weights``, counts set to 0 before
                   each of two runs: float32 and ``--bf16``; both write MOTS txt
                   (RLE) under ``OUT_DIR``.  The float32 run must equal phase 7's
                   snapshots bit for bit and score MOTSA = MOTSP = 1, IDS = 0
                   against itself (objects with mask pixels); the bf16 run must
                   hold a track in every frame with ids >= 1 never reused,
                   p2-p6 within ``BF16_MAP_LIMIT`` of the float32 maps' max-abs
                   and none equal to them; each run's p2-p6, RPN logits and mask
                   probabilities in its compute dtype, and a bf16 convolution
                   kernel in its profiled batch only in the bf16 run.
                   Prints the bf16 run scored against the float32 run (with the
                   number of objects scored) and both
                   runs' stage ms, frames/s, device busy, idle share, launches
                   and peak memory, and phase 7's association and sweep figures
                   (the auction's warp kernel must launch once a frame and its
                   block kernel never, in both runs).
9. association  -- phase 8's float32 detections and embeddings through
                   ``embeddings`` (the auction kernel), ``bbox_center_dist``,
                   ``mask_iou`` and ``embeddings(exact=True)`` on the card and
                   on the CPU: identical ids frame by frame; ms, syncs,
                   launches and sweeps per batch.  The auction kernel on the
                   real costs of every frame at every budget against the plain
                   version's CPU run (identical), one call under sync-as-error,
                   timed per solve on those costs (the ``kernels`` line's
                   ``auction_warp`` row; its launches are phase 7's).
                   ``linear_sum_assignment`` and
                   ``auction_assignment`` on seeded 32x32 costs, both ways: JV
                   at scipy's optimum, the auction within n x its last eps; ms
                   per solve.
10. detector    -- ``detector_test``'s ``detect`` at ``aerial_view_test``'s
                   defaults (R50-FPN, 3 classes, no mask head; a seeded
                   checkpoint, background bias calibrated) on 2 frames, card
                   against CPU: the same valid detections and classes, boxes
                   within 0.5 px.
11. train_assoc -- ``train_association_head``'s CLI at its defaults (R101-FPN
                   backbone frozen, read from phase 7's checkpoint saved as a
                   ``.pth`` through ``--weights``; ROI 8, 4 frames a batch,
                   128-d, SGD 0.01 / 0.9, margin 0.2, 2 epochs) on a seeded
                   synthetic KITTI-MOTS sequence (8 frames of 375x1242, 5
                   textured objects with fixed ids, PNG + RLE txt through
                   ``MOTSLoader``): every loss finite, the head changed; the
                   first step again on the CPU from the same ROIs: loss within
                   1e-5 relative, the head's change within 1e-5 of its
                   max-abs; a second run at ``--roi_size 10`` (the tracker's)
                   whose ``epoch_1`` ``tracker_test --assoc_weights`` loads and
                   runs on one batch.
12. train_detector -- ``finetune_detector`` at ``finetune_uav``'s defaults
                   (R101-FPN, 4 classes, no mask head, batch 4 at 768x1344,
                   RPN + ROI heads trained, lr 0.02 with its warmup, 2000 /
                   1000 proposals, 256 / 512 samples) from phase 7's
                   checkpoint through ``--weights`` on seeded synthetic scenes
                   (``utils.synthetic.detection_scenes``), 6 iterations,
                   evaluated every 3 on 4 held-out images: losses finite at
                   every step, the backbone bit-identical, every trained tensor
                   changed, 2 results.txt rows, last / bestAP / bestAR, and a
                   resume from ``last`` at iteration 6 with its optimizer
                   state; one step at batch 1 on the CPU against the card
                   on the card's backbone maps and proposals (the maps held
                   to the CPU's own within 1e-4 of their max-abs; each loss
                   within 1e-4 relative, the trained tensors' change and
                   gradients within 1e-4 of their max-abs); then the steady ms a
                   step (host clock ending in a synchronize), its split by
                   stage (CUDA events), one step profiled (device busy, idle
                   share, launches, the largest kernels), its host syncs and
                   peak memory.
13. learning    -- the reference's learning regression on the card (R50-FPN,
                   2 classes, 96x96 scenes, batch 2, lr 0.005, the flax init
                   under seed 0, 150 iterations, evaluated every 25): the run
                   must reach AP50 >= 0.7; prints each evaluation's AP50 and
                   the seconds.
14. c4          -- R101-C4 at ``mask_rcnn_r101_c4(4)``'s widths and input sizes
                   (800 / 1333: the 4K frames resize to 750x1333, padded to
                   768x1344; 1000 proposals, 100 detections, 14x14 masks) from a
                   seeded detectron2-named C4 ``.pkl`` under ``OUT_DIR`` through
                   the port's C4 import (its background bias calibrated to the
                   frames, as in phase 7, for the threshold 0.05),
                   ``TrackPredictor`` on 4 frames: every output finite, boxes
                   (4, 100, 4), masks 14x14, a detection in every frame; ms per batch
                   and by stage (backbone, RPN, res5 box head, res5 mask rerun),
                   busy, idle share, launches, peak memory; frame 1 on the CPU:
                   res4 within 1e-4 of its max-abs, and the detections from the
                   card's maps and proposals matched one for one (class, box
                   within 1e-3 px at 1344 wide, score within 1e-4; where the
                   order is the same, boxes within 1e-2 px and masks within 1e-4).
15. c4_train    -- one R101-C4 step at batch 2 (768x1344, default ``to_train``):
                   the RPN head and mask head train, res5 and the box predictor
                   stay frozen; card against CPU on the card's maps and
                   proposals (losses within 1e-4 relative, update and gradients
                   within 1e-4 of their max-abs); the step's ms, split and profile.
16. train_bf16  -- phase 12's step in the reference's bf16 regime
                   (``compute_dtype="bfloat16"``, ``head_compute_dtype="float32"``)
                   from phase 7's checkpoint: bf16 maps, float32 parameters; the
                   steady step ms beside phase 12's float32 one; one step at
                   batch 1 card against CPU on the card's bf16 maps and
                   proposals (limits as phase 15).
17. surgery     -- ``add_mask_head`` on two seeded R101-FPN checkpoints (the
                   result loads into the port with nothing missing and gives
                   masks on a 4K frame), ``finetune_segmentation`` (2 iterations,
                   ``--merge_into``), ``finetune_faster_rcnn_aerial --rpn_only``
                   and ``finetune_coco_dataset`` (2 iterations each) on seeded
                   COCO and UAVDT trees under ``OUT_DIR``: each exits 0 and each
                   checkpoint it writes reloads with no key missing.
18. cowc        -- ``CowcRoiFeaturesLoader`` with R101-FPN's ``roi_features``
                   (phase 7's weights) on one seeded 2048x2048 COWC image (four
                   1024 patches, 400 points): features a second; one chunk of
                   128 boxes card against CPU within 2e-2 of its max-abs (the
                   pooling rows are bfloat16, where a last-bit difference of a
                   map value moves a whole bf16 step).
19. selective   -- ``SelectivePredictor`` (p6 proposals only) at
                   ``uav_tracker_config()`` on 4 frames with phase 7's weights:
                   its two timings; frame 1 on the CPU at the zoo's score
                   threshold 0.05 (p6's few large proposals leave none above
                   0.5), detections matched one for one (boxes within 0.5 px,
                   scores within 1e-4).
20. parallel    -- ``sharded_inference_fn`` (phase 7's R101-FPN, one
                   ``TrackPredictor`` a card, 4 4K frames) and ``shard_map_batch``
                   (the two-pass ArUco front on phase 2's frames) over
                   ``data_mesh()``, every visible card (one on a one-card
                   machine, so it checks the split, not a speedup), against the
                   unsharded runs: the same detections (boxes within 1e-3 px)
                   and the same front outputs bit for bit; the sharded front's
                   launch counts must hold one launch of K5, K3, K2, K4 and K1 a
                   card at least.  Then the data-parallel step at
                   ``finetune_uav``'s defaults (R101-FPN at 768x1344, batch 4,
                   RPN and ROI heads trained, phase 7's checkpoint) on a
                   one-rank NCCL group (a spawned process) against the plain
                   step on the same batch (losses and updated tensors within
                   1e-6).
                   Phases 14-19 reach no kernel of ``csrc``: each is run with the
                   launch counts set to 0 just before and prints them (all 0);
                   phase 20 prints the sharded and unsharded front's counts.
21. operating_point -- the 4K operating point against ground truth: the ten
                   scenes of ``OP_SCENES`` (seven at 40 m with yaw 0, 15, ..., 90;
                   the yaw-30 scene at 25, 50 and 65 m; the four vehicles of
                   tests/test_aruco_operating_point.py, host LEDs 0b10110010)
                   rendered on the card by the port's ``SceneRenderer``
                   (3840x2160, supersample 2, ``data/cam_params.json``).  Each
                   scene is a first frame with a fresh carry through the
                   two-pass ``ArucoPipeline`` (the colour table, K5, K3 pooled,
                   K2, K4, K1) and the single-pass one (the colour table, K3 on
                   the full frame, K2, K1), counts set to 0 before each run and
                   the pipeline built in it; every kernel of the path must
                   launch.  Held to the renderer's geometry (``score_scene``):
                   ids 1-4 present in every scene; the corners against
                   ``project_world_to_undistorted(marker_world_corners(spec))``
                   within 0.5 px mean a scene and 1.5 px worst, the mean signed
                   error of each axis over the scenes within +-0.1 px (the JAX
                   package's own figures and test bounds); ``dist_aruco`` of
                   vehicles 1-3 against the world distance of their marker
                   centres from the host's within ``OP_DIST_M``; the LEDs
                   decode to 0b10110010 at every altitude.  Prints the errors
                   of the marker side, of the pose's range and of the altitude
                   column, the phase's seconds and each process call's ms, and
                   writes every scene's scores to ``OUT_DIR/operating_point.json``.
                   The JAX package on the same ten scenes, rendered by its own
                   ``SceneRenderer``, through its two-pass pipeline on the XLA
                   path on the CPU (``scripts/operating_point_jax.py``): worst
                   scene mean 0.42233 px and worst corner 1.06358 px (both at
                   25 m), signed bias (-0.00083, -0.00752) px, worst
                   ``dist_aruco`` error 0.61613 m (65 m, vehicle 2; the paper's
                   bound is 0.5 m), the LEDs 0b10110010 in all ten scenes.  So
                   ``OP_DIST_M`` is 0.61613 + 0.02 m, and the 65 m LEDs are
                   required too.

``python3 chip_smoke.py --all-cards`` runs only frame sharding and the
data-parallel step, over every visible card (four on a four-card machine):
R101-FPN at the zoo's score threshold 0.05 on 8 seeded random 4K frames, one replica a card against card 0 running each card's
chunk (the same detections, boxes within 1e-3 px; frames a second of both:
the wrappers run the cards in turn, so expect no speedup), and the
data-parallel step at ``finetune_uav``'s defaults with 2 images a card, one
NCCL process a card, against the plain step on card 0 with the whole batch
(losses and updated tensors within rtol 5e-4, atol 1e-5, the bound the
reference's mesh step is held to).  It builds no kernel and runs no other
phase.

Prints the card's name and power limit and a ``kernels`` JSON line before
the last line; the last line is the ``{"ok": true, "device": ...}`` object.
Exits non-zero without a result when no CUDA device is available or when the
``apse_uav_torch`` package is not beside this script.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
# The tracker phase: frames per batch (track_uav's default) and the detection
# confidence (its default and uav_tracker_config()'s score threshold).
TRACK_BATCH = 4
TRACK_CONFIDENCE = 0.5
# bf16 against float32 maps (tracker_eval), relative to each map's max-abs:
# the reference's own bf16-to-float32 gap is 1.2e-2 (R50) to 1.6e-2 (R101) on
# the CPU (tests/test_torch_mask_rcnn.py), so 5e-2 leaves ~3x for 4K maps.
BF16_MAP_LIMIT = 5e-2
# What torch.cuda.set_sync_debug_mode("warn") says at each host sync.
SYNC_WARNING = "called a synchronizing CUDA operation"
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
    "colour_table": "preproc/pallas_remap.py:1259",
    # No Pallas kernel: the lax.while_loop of gated_auction_match (its loop at :298).
    "auction": "dcnn/hungarian.py:202",
    # No TPU kernel: the JAX package has no ResNeXt (cuDNN's grouped convolution before).
    "gconv": None,
}
# Device kernels of each wrapper, as the profiler names them (substrings).
KERNEL_NAMES = {
    "labeling": ("labels_kernel",),
    "proposals": ("integral_rows", "integral_cols", "flags_kernel", "tiles_kernel", "select_kernel"),
    "remap_full": ("remap_kernel",),
    "remap_selected": ("remap_kernel",),
    "pool": ("pool4_kernel",),
    "remap_full_rgb": ("remap_kernel",),
    "colour_table": ("table_kernel",),
    "auction": ("auction_kernel", "auction_warp_kernel"),
    "gconv": ("gconv3x3_kernel",),
}
# The gated auction's sweep budget (gated_auction_match's max_sweeps default).
AUCTION_BUDGET = 128
# The grouped 3x3 kernel against F.conv2d: each side's float32 sum of K
# products lies within K * 2**-24 * sum|x||w| of the exact sum, whatever its
# order, so the two within twice that.
GCONV_BOUND_C = 2.0


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


def kernel_ms(fn, names, iters: int = 10) -> float | None:
    """Device time per call of the kernels named ``names`` (substrings of the
    profiler's kernel names) over ``iters`` calls of fn, torch.profiler
    (CUPTI); None when the trace shows none of them."""
    split = kernel_split(fn, names, iters)
    return sum(split.values()) if split else None


def kernel_split(fn, names, iters: int = 10, tries: int = 3) -> dict:
    """{name: device ms per call} of the kernels ``names`` over ``iters`` calls of fn.
    A trace that caught none of them (seen once in ten runs) is taken again, up
    to ``tries`` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.ones(1, device="cuda").add_(1)  # the trace drops the first kernel of its window
            torch.cuda.synchronize()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        split = {}
        for e in prof.key_averages():
            for n in names:
                if e.device_type == torch.autograd.DeviceType.CUDA and n in e.key:
                    us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
                    split[n] = split.get(n, 0.0) + us / 1e3 / iters
        split = {n: ms for n, ms in split.items() if ms > 0}
        if split:
            return split
    return {}


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / PEAK_OPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def profile_call(fn, call_ms: float, all_kernels: bool = False) -> dict:
    """Device time over one call of fn (torch.profiler, CUPTI): the sum of its
    kernels' times, their number, the device's idle share of the unprofiled
    call time ``call_ms``, and the largest entries by PyTorch op and by
    kernel; with ``all_kernels``, also every kernel's full name under
    "kernel_names"."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # The trace missed the first kernel of the window (the single-pass
        # front's 3 ms K3 launch) until one tiny op ran ahead of it.
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        fn()
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

    out = {"call_ms": round(call_ms, 3), "device_busy_ms": round(busy_ms, 3),
           "device_idle_share": round(1.0 - busy_ms / call_ms, 4), "kernel_launches": sum(r[2] for r in kernels),
           "top_ops": top(ops), "top_kernels": top(kernels)}
    if all_kernels:
        out["kernel_names"] = [r[0] for r in kernels]
    return out


def run_path(make_pipe, frames, cfg, dev, names):
    """Every launch count set to 0, then ``make_pipe()`` builds the pipeline
    and one ``process`` call runs it; fails unless every kernel in ``names``
    launched, ids 1-4 were measured in every frame, the LEDs decoded and the
    distances are finite.  Returns (pipeline, outputs as numpy, launch counts)."""
    import torch

    from apse_uav_torch.aruco.pipeline import init_carry
    from apse_uav_torch.utils import profiling

    profiling.reset_counters()
    pipe = make_pipe()
    _, out = pipe.process(frames, init_carry(cfg, dev), first=True)
    torch.cuda.synchronize()
    counts = profiling.counted("launch")
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
    return pipe, out_np, counts


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


def tracker_stages(tracker, pre, frames_np, dev) -> tuple[dict, dict]:
    """Host-clock ms per batch of each stage of the tracker path on the card
    (each stage alone, on the previous stage's output; the association from
    the state the batch itself left, as in a video whose vehicles stay in
    view), and the association stage's launches, syncs and auction sweeps
    (``association_stats``)."""
    import torch

    from apse_uav_torch.dcnn.engines import full_fp32

    pred, model = tracker.predictor, tracker.predictor.model
    hw = pred.pad_hw
    x = torch.from_numpy(frames_np).to(dev)
    rgb, _ = pre(x, with_gray=False)
    resized = pred.resize(rgb)

    def quiet(fn):
        def run():
            with torch.no_grad(), full_fp32():
                return fn()
        return run

    feats = quiet(lambda: model.features(resized))()
    boxes, _, valid = quiet(lambda: model.proposals(feats, hw))()
    dets = pred.postprocess(quiet(lambda: model.detect(feats, boxes, valid, hw))())
    det_cap, emb = tracker.embed(dets, feats)
    tracker.associate(det_cap, emb)
    state0 = tracker.state

    def associate():
        tracker.state = state0
        return tracker.associate(det_cap, emb)

    times = {"upload": wall_ms(lambda: torch.from_numpy(frames_np).to(dev)),
             "preprocessor": wall_ms(lambda: pre(x, with_gray=False)),
             "resize": wall_ms(lambda: pred.resize(rgb)),
             "backbone": wall_ms(quiet(lambda: model.features(resized))),
             "rpn_proposals": wall_ms(quiet(lambda: model.proposals(feats, hw))),
             "roi_heads_masks": wall_ms(quiet(lambda: model.detect(feats, boxes, valid, hw))),
             "embeddings": wall_ms(lambda: tracker.embed(dets, feats)),
             "association": wall_ms(associate)}
    assoc = association_stats(associate, times["association"])
    tracker.state = state0
    return {k: round(v, 3) for k, v in times.items()}, assoc


@contextlib.contextmanager
def auction_calls(inputs: list | None = None):
    """Records every ``cuda_auction.solve`` call in the block (the tracker's
    ``gated_auction_match`` goes through it): yields the list of the calls'
    sweep counts, left on the card until read.  With ``inputs`` a list, each
    call's (cost, row_valid, col_valid) is cloned into it too."""
    from apse_uav_torch.dcnn import cuda_auction

    solve, sweeps = cuda_auction.solve, []

    def recording(cost, row_valid, col_valid, threshold, max_sweeps=AUCTION_BUDGET):
        if inputs is not None:
            inputs.append((cost.clone(), row_valid.clone(), col_valid.clone()))
        col_of_row, n = solve(cost, row_valid, col_valid, threshold, max_sweeps)
        sweeps.append(n)
        return col_of_row, n

    cuda_auction.solve = recording
    try:
        yield sweeps
    finally:
        cuda_auction.solve = solve


def check_auction_launches(counts: dict, frames: int, where: str) -> None:
    """The tracker's 32 x 32 association in ``counts`` (launches by kernel):
    the warp kernel once a frame and the block kernel never, or SmokeFailure."""
    from apse_uav_torch.dcnn import cuda_auction

    got = {k: counts.get(k, 0) for k in cuda_auction.KERNELS}
    if got != {cuda_auction.WARP: frames, cuda_auction.BLOCK: 0}:
        raise SmokeFailure(f"{where}: auction launches {got} for {frames} frames (the warp kernel once a frame)")


def auction_sweeps(counts: list) -> dict:
    """Sweeps per frame of the auction calls' sweep counts ``counts`` (from
    ``auction_calls``) and how many frames reached the budget."""
    import torch

    sweeps = torch.cat(counts).cpu().tolist() if counts else []
    return {"auction_sweeps_per_frame": sweeps, "frames_at_sweep_budget": sum(v >= AUCTION_BUDGET for v in sweeps)}


def association_stats(associate, ms: float) -> dict:
    """One call of ``associate`` (a batch's association) on the card: its host
    syncs, its device kernels (profiled: launches, busy ms) and its auction
    launches (by kernel) and sweeps per frame."""
    from apse_uav_torch.dcnn import cuda_auction
    from apse_uav_torch.utils import profiling

    syncs = count_syncs(associate)
    prof = profile_call(associate, ms)
    before = {k: profiling.counted("launch").get(k, 0) for k in cuda_auction.KERNELS}
    with auction_calls() as counts:
        associate()
    sweeps = auction_sweeps(counts)
    return {"ms": round(ms, 3), "syncs": syncs, "kernel_launches": prof["kernel_launches"],
            "device_busy_ms": prof["device_busy_ms"],
            "auction_launches": {k: profiling.counted("launch").get(k, 0) - n for k, n in before.items()}, **sweeps}


def count_syncs(fn) -> int:
    """Device-to-host synchronisations during fn, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum(SYNC_WARNING in str(w.message) for w in caught)


def nms_timing(fn) -> dict:
    """The NMS fixed points in one call of ``fn`` (the RPN's per-level NMS and
    ``box_inference``'s class NMS, each an ``ops.nms.nms_mask``): every call
    timed alone on the host clock between two synchronizes, its shape and its
    convergence tests (host syncs)."""
    import torch

    from apse_uav_torch.dcnn.models import rpn
    from apse_uav_torch.dcnn.ops import nms
    from apse_uav_torch.utils import profiling

    inner, calls = nms.nms_mask, []

    def timed(boxes, *args, **kwargs):
        torch.cuda.synchronize()
        c0, t0 = profiling.counters.get("sync.nms_converge", 0), time.perf_counter()
        out = inner(boxes, *args, **kwargs)
        torch.cuda.synchronize()
        calls.append(((time.perf_counter() - t0) * 1e3, profiling.counters.get("sync.nms_converge", 0) - c0,
                      list(boxes.shape)))
        return out

    nms.nms_mask = rpn.nms_mask = timed
    try:
        fn()
    finally:
        nms.nms_mask = rpn.nms_mask = inner
    return {"calls": len(calls), "ms": round(sum(c[0] for c in calls), 3),
            "convergence_checks": sum(c[1] for c in calls),
            "per_call": [[round(ms, 3), checks, shape] for ms, checks, shape in calls]}


def auction_problems(n_per_kind: int = 40, n: int = 32) -> list[tuple[str, tuple]]:
    """Seeded and crafted (cost, row_valid, col_valid) problems at the tracker's
    n x n: ``n_per_kind`` of each kind of ``utils.synthetic.auction_problem``,
    then ``auction_crafted``'s: equal costs (ties everywhere), two columns
    near the threshold and two contested well below it (both run out of the
    sweep budget), one column, every cost at the threshold (every row
    exits), no valid row, no valid column."""
    from apse_uav_torch.utils.synthetic import AUCTION_KINDS, auction_crafted, auction_problem

    rng = np.random.default_rng(0)
    out = [(kind, auction_problem(kind, rng, n, n)) for kind in AUCTION_KINDS for _ in range(n_per_kind)]
    return out + auction_crafted(rng, n, n)


def auction_block_problems(n_per_kind: int = 2) -> list[tuple[str, tuple]]:
    """Problems above the warp kernel's 32 x 32, which the block kernel
    solves: ``n_per_kind`` of each kind of ``auction_problem`` and the
    crafted ones at 33 x 32, 32 x 33 and 40 x 70 (two rows a warp, three
    columns a lane), and one random problem at the kernel's 1,024 x 1,024."""
    from apse_uav_torch.utils.synthetic import AUCTION_KINDS, auction_crafted, auction_problem

    rng = np.random.default_rng(1)
    out = []
    for rows, cols in ((33, 32), (32, 33), (40, 70)):
        out += [(f"{kind} {rows}x{cols}", auction_problem(kind, rng, rows, cols)) for kind in AUCTION_KINDS
                for _ in range(n_per_kind)]
        out += [(f"{name} {rows}x{cols}", p) for name, p in auction_crafted(rng, rows, cols)]
    return out + [("random 1024x1024", auction_problem("random", rng, 1024, 1024))]


def auction_bound(rows: int, cols: int, scanned: int) -> tuple[float, str]:
    """The gated auction's bound: the costs, the two masks and the outputs
    once; 2 operations a cost entry once (negate, the spread's max), and for
    each row bidding at the start of a sweep 3 a column (subtract the price,
    the row scan's two compares) and 4 more (the exit compare, the bid's two
    adds, the compare into its column's best bid).  ``scanned`` is this
    problem's bidding rows summed over its sweeps (the plain version's third
    output): rows that hold a column or have exited do no work in a sweep."""
    return bound(rows * cols * 4 + rows + cols + rows * 8 + 4, 2 * rows * cols + scanned * (3 * cols + 4))


def auction_check(problems, dev, threshold: float = 0.6, budgets=(AUCTION_BUDGET, 1, 2, 3, 5)) -> dict:
    """The auction kernels against the plain version's CPU run on ``problems``
    ((kind, (cost, row_valid, col_valid)) with numpy or CPU tensors) at each
    sweep budget: col_of_row and the sweep count identical, and each solve
    launched on the kernel ``cuda_auction.kernel_for`` names for its shape
    (counted on the card), or SmokeFailure.  (The plain version on the card
    is no reference: its max(dim) may break an exact tie another way.)
    Returns the counts, the launches by kernel, the largest difference in a
    column index or a sweep count over all solves (``max_abs_err``) and the
    full budget's sweeps per problem."""
    import torch

    from apse_uav_torch.dcnn import cuda_auction, hungarian
    from apse_uav_torch.utils import profiling

    got, want = [], []
    before = {k: profiling.counted("launch").get(k, 0) for k in cuda_auction.KERNELS}
    want_launches = dict.fromkeys(cuda_auction.KERNELS, 0)
    for kind, arrays in problems:
        t = [torch.as_tensor(a) for a in arrays]
        want_launches[cuda_auction.kernel_for(*t[0].shape)] += len(budgets)
        for budget in budgets:
            want.append((kind, budget, hungarian.gated_auction_sweeps(*t, threshold, budget)[:2]))
            got.append(cuda_auction.solve(*(a.to(dev) for a in t), threshold, budget))
    torch.cuda.synchronize()
    launches = {k: profiling.counted("launch").get(k, 0) - n for k, n in before.items()}
    if dev.type == "cuda" and launches != want_launches:
        raise SmokeFailure(f"auction launches by kernel {launches}, expected {want_launches}")
    sweeps, exhausted, errs = [], 0, []
    for (kind, budget, (wcol, wsw)), (gcol, gsw) in zip(want, got):
        gcol, gsw, wsw = gcol.cpu(), int(gsw.cpu()[0]), int(wsw[0])
        errs.append(max(int((gcol - wcol).abs().max()), abs(gsw - wsw)))
        if errs[-1] > 0:
            raise SmokeFailure(f"auction kernel vs plain, {kind}, budget {budget}: {gcol.tolist()} "
                               f"({gsw} sweeps) vs {wcol.tolist()} ({wsw} sweeps)")
        if budget == AUCTION_BUDGET:
            sweeps.append(wsw)
        exhausted += wsw == budget
    return {"problems": len(problems), "budgets": list(budgets), "solves": len(got), "launches": launches,
            "max_abs_err": max(errs), "solves_at_budget": exhausted, "sweeps_max": max(sweeps),
            "sweeps_mean": round(float(np.mean(sweeps)), 3)}


def auction_timing(problems, threshold: float) -> dict:
    """The auction on the card, per solve over ``problems`` ((cost, row_valid,
    col_valid) on the card, solved one after another): the kernel the wrapper
    chose, the wrapper's ms (CUDA events), its kernel's device ms
    (torch.profiler), the plain version's ms on the card, the mean sweeps,
    bidding rows scanned and bound (``auction_bound`` per problem, its work
    counted by the plain version's CPU run); one solve under sync-as-error."""
    import torch

    from apse_uav_torch.dcnn import cuda_auction, hungarian

    n = len(problems)

    def kern():
        return [cuda_auction.solve(*p, threshold) for p in problems]

    kern()
    plain = [hungarian.gated_auction_sweeps(*(a.cpu() for a in p), threshold) for p in problems]
    sweeps, scanned = [int(s[0]) for _, s, _ in plain], [int(b[0]) for _, _, b in plain]
    bounds = [auction_bound(*p[0].shape, b) for p, b in zip(problems, scanned)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        cuda_auction.solve(*problems[0], threshold)
    except RuntimeError as e:
        raise SmokeFailure(f"the auction wrapper synchronises the device: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode("default")
    kms = kernel_ms(kern, KERNEL_NAMES["auction"])
    plain_ms = cuda_ms(lambda: [hungarian.gated_auction_sweeps(*p, threshold) for p in problems], 3, 1)
    b_ms = sum(b for b, _ in bounds) / n
    return {"problems": n, "shape": list(problems[0][0].shape),
            "kernel": cuda_auction.kernel_for(*problems[0][0].shape), "sweeps_mean": sum(sweeps) / n,
            "bidding_rows_scanned_mean": sum(scanned) / n,
            "ms": round(cuda_ms(kern, iters=20, warmup=3) / n, 4),
            "kernel_ms": None if kms is None else round(kms / n, 4), "plain_ms": round(plain_ms / n, 4),
            "bound_ms": b_ms, "bound_by": max(bounds)[1]}


def gconv_convs(hw=(768, 1344)) -> list[tuple]:
    """X101-32x8d's 33 grouped 3x3s on one (h, w) padded input, in order:
    (channels a group, stride, H_in, W_in), traced on the meta device."""
    import torch

    from apse_uav_torch.dcnn.models.resnet import GroupedConvNorm, ResNet

    seen = []
    with torch.device("meta"):
        trunk = ResNet(101, stride_in_1x1=False, num_groups=32, width_per_group=8)
        for m in trunk.modules():
            if isinstance(m, GroupedConvNorm):
                m.register_forward_pre_hook(
                    lambda mod, args: seen.append((mod.in_channels // mod.groups, mod.stride[0], *args[0].shape[2:])))
        trunk(torch.empty(1, 3, *hw))
    return seen


def gconv_check(frames, dev, batch: int = TRACK_BATCH, groups: int = 32) -> dict:
    """The grouped 3x3 kernel at each distinct X101 shape at ``batch``
    (seeded He-scaled inputs): every output within GCONV_BOUND_C x K x 2**-24
    x conv2d(|x|, |w|) of ``F.conv2d`` (TF32 off), two runs bit-identical,
    one launch a call; the kernel's device time, the wrapper's, cuDNN's
    ``F.conv2d`` (the plain version and the library call it replaces) and
    the bound, by shape and summed over the 33 convolutions a frame.  Then
    the main path's own count: one ``TrackPredictor`` forward of X101-32x8d
    (seeded weights) on ``batch`` of ``frames`` (4K HWC uint8 on the card,
    padded to 768x1344 as in ``x101fpn-b4``) launches the kernel once a
    ``track.gconv`` span, 33 times."""
    import torch
    import torch.nn.functional as F

    from apse_uav_torch.dcnn import cuda_gconv
    from apse_uav_torch.dcnn.config import mask_rcnn_x101_32x8d_fpn
    from apse_uav_torch.dcnn.engines import TrackPredictor
    from apse_uav_torch.utils import profiling

    convs = gconv_convs()
    cases = sorted(set(convs), key=convs.index)
    g = torch.Generator().manual_seed(26)
    rows = []
    for width, stride, h, w in cases:
        c = groups * width
        x = torch.randn(batch, c, h, w, generator=g).to(dev)
        wt = (torch.randn(c, width, 3, 3, generator=g) * (2.0 / (9 * width)) ** 0.5).to(dev)

        def kern():
            return cuda_gconv.conv(x, wt, stride, groups)

        def lib():
            return F.conv2d(x, wt, None, stride, 1, 1, groups)

        profiling.reset_counters()
        y, again = kern(), kern()
        torch.cuda.synchronize()
        launches = profiling.counted("launch").get(cuda_gconv.NAME, 0)
        ref = lib()
        mag = F.conv2d(x.abs().double(), wt.abs().double(), None, stride, 1, 1, groups)
        gap = (y.double() - ref.double()).abs()
        ratio = float((gap / (GCONV_BOUND_C * 9 * width * 2.0 ** -24 * mag)).max())
        if launches != 2 or not torch.equal(y, again) or not ratio <= 1.0:
            raise SmokeFailure(f"gconv w{width} s{stride} {h}x{w}: launches {launches}, identical "
                               f"{torch.equal(y, again)}, gap / bound {ratio}")
        b_ms, b_by = bound(4 * (x.numel() + y.numel() + wt.numel()), 2 * y.numel() * 9 * width)
        rows.append({"width": width, "stride": stride, "in_hw": [h, w], "convs": convs.count((width, stride, h, w)),
                     "max_abs_err": float(gap.max()), "gap_over_bound": round(ratio, 4),
                     "kernel_ms": kernel_ms(kern, KERNEL_NAMES["gconv"]), "ms": round(cuda_ms(kern), 4),
                     "library_ms": round(cuda_ms(lib), 4), "bound_ms": round(b_ms, 5), "bound_by": b_by})
        del x, wt, y, again, ref, mag, gap
    if any(r["kernel_ms"] is None for r in rows):
        raise SmokeFailure("gconv: the profiler caught no gconv3x3_kernel")

    torch.manual_seed(26)
    pred = TrackPredictor(mask_rcnn_x101_32x8d_fpn(4), None, tuple(frames.shape[1:3]), device=dev)
    if tuple(pred.pad_hw) != (768, 1344):
        raise SmokeFailure(f"gconv: X101 pads {tuple(frames.shape[1:3])} to {pred.pad_hw}, not 768x1344")
    profiling.reset_counters()
    profiling.reset_spans()
    profiling.enable_spans(True)
    try:
        pred(frames[:batch])
        torch.cuda.synchronize()
    finally:
        profiling.enable_spans(False)
    spans = sum(1 for s in profiling.spans() if s.name == "track.gconv")
    profiling.reset_spans()
    forward_launches = profiling.counted("launch").get(cuda_gconv.NAME, 0)
    del pred
    if not forward_launches == spans == len(convs) == 33:
        raise SmokeFailure(f"gconv: an X101 forward launched the kernel {forward_launches} times over {spans} "
                           f"track.gconv spans; {len(convs)} grouped 3x3s")
    per_frame = {k: round(sum(r[k] * r["convs"] for r in rows) / batch, 4)
                 for k in ("kernel_ms", "ms", "library_ms", "bound_ms")}
    res = {"batch": batch, "convs": len(convs), "forward_launches": forward_launches, "forward_spans": spans,
           "shapes": rows, "per_frame": per_frame,
           # From the CUDA-event times: the profiler's sum has read low at one shape.
           "roofline_pct": round(100 * per_frame["bound_ms"] / per_frame["ms"], 2),
           "bound_by": "/".join(sorted({r["bound_by"] for r in rows})),
           "max_abs_err": max(r["max_abs_err"] for r in rows)}
    log({"phase": "gconv", **res})
    return res


def calibrate_background(ckpt: dict, cfg, pre, frames_np, dev, per_frame: int = 10) -> dict:
    """Set the synthetic checkpoint's background logit bias from the frames.

    With random weights every proposal's best class clears the confidence
    only by the margin of its logits over the background's; most proposals
    lie on the same asphalt, so their margins crowd together, and where the
    threshold falls in a crowd, which detections pass (and in which order)
    follows float rounding.  For each proposal of each frame this computes
    the largest shift of the background bias that still lets its best class
    clear the config's score threshold (softmax, float64), and puts the bias
    in the middle of the widest gap between those shifts just below the
    ``per_frame``-th largest of the frame that has fewest: each frame keeps
    >= ``per_frame`` candidates before NMS and none sits near the threshold.
    ``pre`` (a Preprocessor, or None for the frames as they are) prepares
    the frames; the model is R-FPN or C4.  Returns the calibration."""
    import torch

    from apse_uav_torch.dcnn.engines import TrackPredictor, full_fp32
    from apse_uav_torch.dcnn.models.c4 import MaskRCNNC4
    from apse_uav_torch.dcnn.models.roi_heads import POOL_LEVELS, fpn_roi_align

    h, w = frames_np.shape[1:3]
    pred = TrackPredictor(cfg, ckpt, (h, w), device=dev)
    model, heads, roi = pred.model, pred.model.roi_heads, cfg.roi
    t = roi.score_thresh_test
    shifts, best_classes = [], []
    with torch.no_grad(), full_fp32():
        for b in range(0, frames_np.shape[0], TRACK_BATCH):
            x = torch.from_numpy(frames_np[b:b + TRACK_BATCH]).to(dev)
            x = x if pre is None else pre(x, with_gray=False)[0]
            feats = model.features(pred.resize(x))
            boxes, _, valid = model.proposals(feats, pred.pad_hw)
            if isinstance(model, MaskRCNNC4):
                logits, _ = model.box_outputs(model.roi_transform(feats["res4"], boxes), *boxes.shape[:2])
            else:
                pooled = fpn_roi_align({n: feats[n] for n in POOL_LEVELS}, boxes, roi.box_pooler_resolution,
                                       roi.pooler_sampling_ratio)
                logits, _ = heads.box_predictor(heads.box_head(pooled.reshape(-1, pooled[0, 0].numel())))
            lg = logits.reshape(*boxes.shape[:2], -1).double()
            fg, bg = lg[..., :-1], lg[..., -1]
            k = fg.argmax(-1, keepdim=True)
            best = fg.gather(-1, k)[..., 0]
            rest = torch.logsumexp(fg.scatter(-1, k, float("-inf")), -1)
            # The best class's probability is t where exp(bg + shift) = exp(best) / t - exp(best) - exp(rest).
            room = torch.exp(best) * (1.0 / t - 1.0) - torch.exp(rest)
            shift = torch.log(torch.clamp(room, min=1e-300)) - bg
            shifts += list(torch.where(valid & (room > 0), shift, torch.full_like(shift, float("-inf"))).cpu())
            best_classes += list(k[..., 0].cpu())
    ranked = [torch.sort(s, descending=True).values for s in shifts]
    target = min(float(s[per_frame - 1]) for s in ranked)
    near = np.sort(np.concatenate([s[(s < target) & (s > target - 1.0)].numpy() for s in ranked] + [[target]]))
    gaps = np.diff(near)
    i = int(np.argmax(gaps)) if len(gaps) else 0
    delta = float((near[i] + near[i + 1]) / 2) if len(gaps) else target - 0.5
    key = "roi_heads.box_predictor.cls_score.bias"
    bias = ckpt[key].copy()
    bias[-1] += delta
    ckpt[key] = bias
    kept = torch.cat([c[s > delta] for s, c in zip(shifts, best_classes)])
    return {"background_bias": float(bias[-1]), "margin": float(gaps[i] / 2) if len(gaps) else 0.5,
            "candidates_per_frame": [int((s > delta).sum()) for s in ranked],
            "class_counts": torch.bincount(kept, minlength=fg.shape[-1]).tolist()}


def favour_classes(ckpt: dict, class_counts: list[int], favoured: list[int]) -> list[int]:
    """Relabel the seeded checkpoint's foreground classes so that the most
    frequent among the calibrated candidates (``class_counts``) become
    ``favoured``, in order, and the rest keep their order after them.  The
    rows of the box classifier, the box regressor and the mask predictor
    move together, so every detection keeps its score, box and mask and
    only its label changes.  Returns the permutation (new class -> old)."""
    n = len(class_counts)
    by_count = sorted(range(n), key=lambda c: (-class_counts[c], c))
    perm = [0] * n
    for new, old in zip(list(favoured) + [c for c in range(n) if c not in favoured], by_count):
        perm[new] = old
    box = "roi_heads.box_predictor."
    for key in (box + "cls_score.weight", box + "cls_score.bias"):
        ckpt[key] = ckpt[key][perm + [n]]  # the background row stays last
    for key in (box + "bbox_pred.weight", box + "bbox_pred.bias"):
        v = ckpt[key]
        ckpt[key] = v.reshape(n, 4, *v.shape[1:])[perm].reshape(v.shape)
    for key in ("roi_heads.mask_head.predictor.weight", "roi_heads.mask_head.predictor.bias"):
        if key in ckpt:
            ckpt[key] = ckpt[key][perm]
    return perm


def tracker_phase(frames_np, mtx, dist, card: str, dev, depth: int = 101) -> dict:
    """The DCNN tracking path at full width: ``track_uav``'s own loop over the
    frames (``--preprocess``, a seeded detectron2 checkpoint through
    ``--weights``, batches of TRACK_BATCH, the CSV under OUT_DIR), launch
    counts set to 0 just before; then each stage timed, one batch profiled,
    its syncs counted, and the first frame run again on the CPU (plain
    versions) against the card.  Returns the snapshots of every frame, the
    calibrated checkpoint, the configs, the re-ID head, the Preprocessor, the
    tracker and its stage times, batch ms, profile and peak memory.  The
    checkpoint's classes are relabelled (``favour_classes``) so that most
    detections fall in the MOTS classes, which phase 8 exports."""
    import torch

    from apse_uav_torch.cli.track_uav import build_parser, track
    from apse_uav_torch.dcnn import cuda_auction
    from apse_uav_torch.dcnn.config import TrackerConfig, mask_rcnn_r50_fpn, uav_tracker_config
    from apse_uav_torch.dcnn.engines import RcnnTracker
    from apse_uav_torch.dcnn.models.association import init_weights
    from apse_uav_torch.evaluation.mots_export import COCO_TO_MOTS
    from apse_uav_torch.preproc import cuda_remap, remap
    from apse_uav_torch.utils import profiling
    from apse_uav_torch.utils.mask_geometry import dcnn_log_line
    from apse_uav_torch.utils.synthetic import detectron2_checkpoint

    n, (h, w) = frames_np.shape[0], frames_np.shape[1:3]
    cam_json = os.path.join(REPO, "data", "cam_params.json")
    csv_path = os.path.join(OUT_DIR, "chip_smoke_dcnn.csv")
    weights_path = os.path.join(OUT_DIR, "tracker_checkpoint.pth")
    os.makedirs(OUT_DIR, exist_ok=True)
    # The CLI's model: R101 is uav_tracker_config(); R50 (CPU rehearsals) alike.
    base = mask_rcnn_r50_fpn(4) if depth == 50 else uav_tracker_config(4)
    cfg = dataclasses.replace(base, roi=dataclasses.replace(base.roi, score_thresh_test=TRACK_CONFIDENCE))
    tcfg = TrackerConfig()
    assoc = init_weights(cfg.fpn_channels * tcfg.roi_size**2, tcfg.embedding_dim)
    pre = remap.Preprocessor(mtx, dist, (w, h), device=dev)
    t0 = time.perf_counter()
    ckpt = detectron2_checkpoint(0, depth, 4)
    calibration = calibrate_background(ckpt, cfg, pre, frames_np, dev)
    # Most detections in the MOTS classes (car, pedestrian), which the MOTS export keeps.
    calibration["class_permutation"] = favour_classes(ckpt, calibration["class_counts"], sorted(COCO_TO_MOTS,
                                                                                                reverse=True))
    torch.save({"model": {k: torch.from_numpy(v) for k, v in ckpt.items()}}, weights_path)
    ckpt_s = time.perf_counter() - t0
    snaps = {}
    args = build_parser().parse_args(["--images", "unused", "--weights", weights_path, "--depth", str(depth),
                                      "--preprocess", cam_json, "--log_file", csv_path, "--batch", str(TRACK_BATCH),
                                      "--confidence", str(TRACK_CONFIDENCE), "--device", dev.type])
    try:
        with auction_calls() as sweep_counts:
            profiling.reset_counters()
            t0 = time.perf_counter()
            res = track(args, ((i, frames_np[i]) for i in range(n)), on_frame=lambda i, r: snaps.__setitem__(i, r))
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
            counts, cli_checks = profiling.counted("launch"), profiling.counters.get("sync.nms_converge", 0)
        cli_sweeps = auction_sweeps(sweep_counts)
    finally:
        os.remove(weights_path)
    if counts.get(cuda_remap.K3_RGB, 0) == 0:
        raise SmokeFailure(f"{cuda_remap.K3_RGB} not launched on the tracker path (counts {counts})")
    check_auction_launches(counts, n, "the tracker path")
    with open(csv_path) as f:
        rows = f.read().splitlines()[2:]
    if len(rows) != n or res["rows"] != n:
        raise SmokeFailure(f"the CSV has {len(rows)} rows for {n} frames")
    seen: set = set()
    for i in range(n):
        ids = snaps[i]["ids"][snaps[i]["valid"]]
        if len(ids) == 0:
            raise SmokeFailure(f"frame {i}: no track")
        if (ids < 1).any() or len(set(ids.tolist())) != len(ids):
            raise SmokeFailure(f"frame {i}: ids {ids.tolist()}")
        new = set(ids.tolist()) - seen
        if seen and new and min(new) <= max(seen):
            raise SmokeFailure(f"frame {i}: new ids {sorted(new)} not above the earlier ones (max {max(seen)})")
        seen |= new

    # The stages on the card, the detections of every frame, a batch end to end.
    tracker = RcnnTracker(cfg, tcfg, ckpt, assoc, (h, w), device=dev)
    batch_np = frames_np[:TRACK_BATCH]
    stages, assoc_stats = tracker_stages(tracker, pre, batch_np, dev)
    n_dets = []
    for b in range(0, n, TRACK_BATCH):
        dets, _ = tracker.predictor(pre(torch.from_numpy(frames_np[b:b + TRACK_BATCH]).to(dev), with_gray=False)[0])
        n_dets += (dets["valid"] & (dets["scores"] > TRACK_CONFIDENCE)).sum(dim=1).tolist()
    if min(n_dets) < 1:
        raise SmokeFailure(f"detections above {TRACK_CONFIDENCE} per frame: {n_dets}")

    def batch():
        """One batch of the CLI's path, upload to snapshots on the host; the
        track state carries over, as from one batch of a video to the next."""
        x = torch.from_numpy(batch_np).to(dev)
        return tracker.materialize(tracker.process_frames_async(pre(x, with_gray=False)[0]))

    batch_ms = wall_ms(batch)
    torch.cuda.reset_peak_memory_stats()
    batch()
    peak = torch.cuda.max_memory_allocated()
    profiling.reset_counters()
    syncs = count_syncs(batch)
    checks = profiling.counters.get("sync.nms_converge", 0)
    x = torch.from_numpy(batch_np).to(dev)
    profiling.reset_counters()
    syncs_dispatch = count_syncs(lambda: tracker.process_frames_async(pre(x, with_gray=False)[0]))
    checks_dispatch = profiling.counters.get("sync.nms_converge", 0)
    profile = profile_call(batch, batch_ms)
    nms_batch = nms_timing(batch)
    log({"phase": "tracker", "frames": n, "size": [w, h], "batch": TRACK_BATCH, "depth": depth,
         "confidence": TRACK_CONFIDENCE, "calibration": calibration, "checkpoint_s": round(ckpt_s, 3),
         "cli_s": round(cli_s, 3), "cli_frames_per_s": round(n / cli_s, 3), "launches": counts,
         "cli_convergence_checks": cli_checks, "cli_auction": cli_sweeps, "batch_ms": round(batch_ms, 3),
         "frames_per_s": round(TRACK_BATCH * 1e3 / batch_ms, 3), "stage_ms": stages, "association": assoc_stats,
         "syncs_per_batch": syncs,
         "syncs_dispatch": syncs_dispatch, "convergence_checks_per_batch": checks,
         "convergence_checks_dispatch": checks_dispatch, "nms_fixed_points": nms_batch,
         "peak_mem_gib": round(peak / 2**30, 3),
         "detections_above_conf": n_dets, "tracks": [int(snaps[i]["valid"].sum()) for i in range(n)],
         "max_id": max(seen), "csv_rows": len(rows), "card": card})
    log({"phase": "tracker_profile", **profile})

    # The first frame again on the CPU, plain versions, against the card.
    t0 = time.perf_counter()
    cpre = remap.Preprocessor(mtx, dist, (w, h), device="cpu")
    ctracker = RcnnTracker(cfg, tcfg, ckpt, assoc, (h, w), device="cpu")
    x0 = torch.from_numpy(frames_np[:1])
    cdets, cfeats = ctracker.predictor(cpre(x0, with_gray=False)[0])
    crecent = {k: v[0] for k, v in ctracker.materialize((cdets, ctracker.associate(*ctracker.embed(cdets, cfeats))))
               .items()}
    _, gfeats = tracker.predictor(pre(x0.to(dev), with_gray=False)[0])
    map_err = {k: float((gfeats[k].cpu() - cfeats[k]).abs().max() / cfeats[k].abs().max()) for k in
               ("p2", "p3", "p4", "p5", "p6")}
    g, v = snaps[0], snaps[0]["valid"]
    same = (np.array_equal(v, crecent["valid"]) and np.array_equal(g["ids"][v], crecent["ids"][v])
            and np.array_equal(g["classes"][v], crecent["classes"][v]))
    box_err = float(np.abs(g["boxes"][v] - crecent["boxes"][v]).max()) if same else None
    crow, _ = dcnn_log_line(crecent, args.host_id, 0, (h, w))
    res = {"seconds": round(time.perf_counter() - t0, 3), "map_rel_err": map_err, "same_ids_classes": same,
           "box_err_px": box_err, "csv_row_equal": crow == rows[0], "tracks": int(crecent["valid"].sum())}
    log({"phase": "tracker_gpu_cpu", **res, "card": card})
    if max(map_err.values()) > 1e-4:
        raise SmokeFailure(f"tracker GPU vs CPU: p2-p6 differ by {map_err} of their max-abs (limit 1e-4)")
    if not same:
        raise SmokeFailure(f"tracker GPU vs CPU: valid ids/classes differ: {g['ids'][v].tolist()} "
                           f"{g['classes'][v].tolist()} vs {crecent['ids'][crecent['valid']].tolist()} "
                           f"{crecent['classes'][crecent['valid']].tolist()}")
    if box_err > 0.5:
        raise SmokeFailure(f"tracker GPU vs CPU: boxes differ by {box_err} px (limit 0.5)")
    if crow != rows[0]:
        raise SmokeFailure(f"tracker GPU vs CPU: CSV rows differ:\n{rows[0]}\n{crow}")
    return {"snaps": snaps, "ckpt": ckpt, "cfg": cfg, "tcfg": tcfg, "assoc": assoc, "pre": pre,
            "tracker": tracker, "stages": stages, "batch_ms": batch_ms, "profile": profile, "peak_gib": peak / 2**30,
            "counts": counts}


def bf16_convs(kernel_names) -> list[str]:
    """The names among ``kernel_names`` of bfloat16 convolution kernels (cuDNN
    names its forward convolutions ``...fprop...`` or ``...conv...``)."""
    return [k for k in kernel_names if "bf16" in k.lower() and ("fprop" in k.lower() or "conv" in k.lower())]


def mots_lines(recents, hw) -> list[str]:
    """MOTS txt lines (RLE) of a sequence's tracker snapshots."""
    from apse_uav_torch.evaluation.mots_export import file_lines_from_recent

    return [ln for f, r in enumerate(recents) for ln in file_lines_from_recent(r, f, hw)]


def mots_scores(gt_path: str, res_path: str, n: int) -> dict:
    """compute_mots_metrics of the txt results at res_path against gt_path,
    per MOTS class, with the number of objects (one per frame and track) in
    each file."""
    from apse_uav_torch.evaluation import mots

    gt, res = {"0000": mots.load_txt(gt_path)}, {"0000": mots.load_txt(res_path)}
    out = {"objects_gt": sum(len(v) for v in gt["0000"].values()),
           "objects_res": sum(len(v) for v in res["0000"].values())}
    for name, cid in (("car", mots.CLASS_CAR), ("pedestrian", mots.CLASS_PEDESTRIAN)):
        total = mots.compute_mots_metrics(gt, res, {"0000": n - 1}, cid)[1]
        out[name] = {"n_gt": total["n_gt"], "n_tr": total["n_tr"], "MOTSA": total["MOTSA"],
                     "MOTSP": total["MOTSP"], "IDS": total["id_switches"], "sMOTSA": total["sMOTSA"]}
    return out


def tracker_eval_phase(frames_np, t7: dict, card: str, dev) -> dict:
    """``tracker_test``'s loop (``track_sequence``) over the frames at full
    width, ``--preprocess``, batches of TRACK_BATCH, from phase 7's calibrated
    weights saved as the port's checkpoint (``--checkpoint``) and its default
    re-ID head saved and loaded through ``--assoc_weights``; once in float32
    and once with ``--bf16``, counts set to 0 before each.  Checks: K3-RGB
    launched; the float32 run bit-identical to phase 7's snapshots; its MOTS
    txt (the objects whose mask has pixels) scored against itself MOTSA =
    MOTSP = 1, IDS = 0 for every MOTS class that holds objects (at least
    one); the bf16 run with a track in every
    frame, ids >= 1 and never reused, p2-p6 within BF16_MAP_LIMIT of the
    float32 maps' max-abs and not equal to them; each run's p2-p6, RPN logits
    and mask probabilities in its compute dtype (bfloat16, float32); a bf16
    convolution kernel in the profiled batch of the bf16 run and none in the
    float32 run's.  Prints the bf16 run scored against the float32 run, and
    both runs' stage ms, frames/s, device busy, idle share, launches and peak
    memory."""
    import torch

    from apse_uav_torch.cli import tracker_test
    from apse_uav_torch.dcnn import cuda_auction
    from apse_uav_torch.dcnn.engines import full_fp32
    from apse_uav_torch.dcnn.models.mask_rcnn import RPN_LEVELS
    from apse_uav_torch.preproc import cuda_remap
    from apse_uav_torch.train.checkpoint import save_state
    from apse_uav_torch.utils import profiling

    n, (h, w) = frames_np.shape[0], frames_np.shape[1:3]
    out_dir = os.path.join(OUT_DIR, "tracker_eval")
    model_path = save_state(out_dir, "model", {"params": t7["ckpt"], "iteration": 0})
    head_path = save_state(out_dir, "head", {"params": t7["assoc"]})
    flags = ["--mots_evaluation", "unused", "--checkpoint", model_path, "--assoc_weights", head_path, "--depth",
             str(t7["cfg"].depth), "--num_classes", str(t7["cfg"].roi.num_classes), "--confidence",
             str(TRACK_CONFIDENCE), "--batch", str(TRACK_BATCH), "--preprocess",
             os.path.join(REPO, "data", "cam_params.json"), "--device", dev.type]
    runs = {}
    try:
        for name, extra in (("float32", []), ("bf16", ["--bf16"])):
            args = tracker_test.build_parser().parse_args(flags + extra)
            built = tracker_test.build_tracker(args, (h, w))
            with auction_calls() as sweep_counts:
                profiling.reset_counters()
                recents, stats = tracker_test.track_sequence(args, list(frames_np), built)
                torch.cuda.synchronize()
                counts = profiling.counted("launch")
            cli_sweeps = auction_sweeps(sweep_counts)
            if counts.get(cuda_remap.K3_RGB, 0) == 0:
                raise SmokeFailure(f"tracker_eval {name}: {cuda_remap.K3_RGB} not launched (counts {counts})")
            check_auction_launches(counts, n, f"tracker_eval {name}")
            path = os.path.join(out_dir, name, "0000.txt")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w") as f:
                f.writelines(ln + "\n" for ln in mots_lines(recents, (h, w)))
            runs[name] = {"args": args, "built": built, "recents": recents, "stats": stats, "counts": counts,
                          "cli_auction": cli_sweeps, "txt": path}
    finally:
        for path in (model_path, head_path):
            os.remove(path)

    # float32 through --checkpoint / --assoc_weights: phase 7 bit for bit.
    for i, (got, want) in enumerate(zip(runs["float32"]["recents"], [t7["snaps"][i] for i in range(n)])):
        for k, v in want.items():
            if not np.array_equal(got[k], v):
                raise SmokeFailure(f"tracker_eval float32 frame {i}: {k} differs from phase 7's")
    # An object whose pasted mask is empty (cropped away by a higher-scoring
    # overlap, or every probability below 0.5) is exported as the reference
    # exports it, but its mask IoU is 0 even against itself: the self-score
    # reads the objects with pixels.
    from apse_uav_torch.evaluation import rle

    with open(runs["float32"]["txt"]) as f:
        lines = f.read().splitlines()
    kept = [ln for ln in lines if rle.area({"size": [h, w], "counts": ln.split(" ")[5]}) > 0]
    nonempty = os.path.join(out_dir, "float32_nonempty", "0000.txt")
    os.makedirs(os.path.dirname(nonempty), exist_ok=True)
    with open(nonempty, "w") as f:
        f.writelines(ln + "\n" for ln in kept)
    self_score = mots_scores(nonempty, nonempty, n)
    self_score["objects_exported"], self_score["objects_with_empty_mask"] = len(lines), len(lines) - len(kept)
    held = [c for c in ("car", "pedestrian") if self_score[c]["n_gt"] > 0]
    if not held:
        raise SmokeFailure(f"tracker_eval: no MOTS class holds a detection: {self_score}")
    for c in held:
        t = self_score[c]
        if t["MOTSA"] != 1.0 or t["MOTSP"] != 1.0 or t["IDS"] != 0:
            raise SmokeFailure(f"tracker_eval float32 against itself, {c}: {t}")

    # bf16: a track in every frame, ids >= 1 never reused; maps near float32's.
    seen: set = set()
    for i, r in enumerate(runs["bf16"]["recents"]):
        ids = r["ids"][r["valid"]]
        if len(ids) == 0 or (ids < 1).any() or len(set(ids.tolist())) != len(ids):
            raise SmokeFailure(f"tracker_eval bf16 frame {i}: ids {ids.tolist()}")
        new = set(ids.tolist()) - seen
        if seen and new and min(new) <= max(seen):
            raise SmokeFailure(f"tracker_eval bf16 frame {i}: new ids {sorted(new)} not above {max(seen)}")
        seen |= new
    # Each run's maps, RPN logits and mask probabilities in its compute dtype.
    x = torch.from_numpy(frames_np[:TRACK_BATCH]).to(dev)
    maps, dtypes = {}, {}
    for name in runs:
        tracker, pre = runs[name]["built"]
        model = tracker.predictor.model
        with torch.no_grad(), full_fp32():
            dets, feats = model.inference(tracker.predictor.resize(pre(x, with_gray=False)[0]))
            logits, _ = model.proposal_generator["rpn_head"]({k: feats[k] for k in RPN_LEVELS})
        got = {**{k: feats[k].dtype for k in RPN_LEVELS}, "rpn_logits": logits["p2"].dtype,
               "mask_probs": dets["masks"].dtype}
        want = torch.bfloat16 if name == "bf16" else torch.float32
        dtypes[name] = {k: str(v) for k, v in got.items()}
        if any(v != want for v in got.values()):
            raise SmokeFailure(f"tracker_eval {name}: dtypes {dtypes[name]}, want {want}")
        maps[name] = {k: feats[k].float() for k in RPN_LEVELS}
        del dets, feats, logits
    map_err = {k: float((maps["bf16"][k] - v).abs().max() / v.abs().max()) for k, v in maps["float32"].items()}
    del maps
    bf16_vs_f32 = mots_scores(runs["float32"]["txt"], runs["bf16"]["txt"], n)

    # Both runs' stages, a batch end to end, its profile and peak memory.
    batch_np = frames_np[:TRACK_BATCH]
    timing = {}
    for name, run in runs.items():
        tracker, pre = run["built"]

        def batch():
            xb = torch.from_numpy(batch_np).to(dev)
            return tracker.materialize(tracker.process_frames_async(pre(xb, with_gray=False)[0]))

        stages, assoc_stats = tracker_stages(tracker, pre, batch_np, dev)
        batch_ms = wall_ms(batch)
        torch.cuda.reset_peak_memory_stats()
        batch()
        peak = torch.cuda.max_memory_allocated()
        prof = profile_call(batch, batch_ms, all_kernels=True)
        convs = bf16_convs(prof["kernel_names"])
        if bool(convs) != (name == "bf16"):
            raise SmokeFailure(f"tracker_eval {name}: bf16 convolution kernels in the profiled batch: {convs[:4]} "
                               f"(kernels named bf16: {[k for k in prof['kernel_names'] if 'bf16' in k.lower()][:8]})")
        timing[name] = {"stage_ms": stages, "association": assoc_stats, "cli_auction": run["cli_auction"],
                        "batch_ms": round(batch_ms, 3),
                        "frames_per_s": round(TRACK_BATCH * 1e3 / batch_ms, 3),
                        "device_busy_ms": prof["device_busy_ms"], "device_idle_share": prof["device_idle_share"],
                        "kernel_launches": prof["kernel_launches"], "peak_mem_gib": round(peak / 2**30, 3),
                        "top_kernels": prof["top_kernels"][:6], "bf16_conv_kernels": len(convs),
                        "cli_s": round(run["stats"]["seconds"], 3),
                        "launches": run["counts"]}
    log({"phase": "tracker_eval", "frames": n, "size": [w, h], "batch": TRACK_BATCH,
         "self_score_float32": self_score, "bf16_vs_float32": bf16_vs_f32, "bf16_map_rel_err": map_err,
         "bf16_map_limit": BF16_MAP_LIMIT, "dtypes": dtypes, "bf16_max_id": max(seen),
         "tracks_bf16": [int(r["valid"].sum()) for r in runs["bf16"]["recents"]], **timing, "card": card})
    if max(map_err.values()) > BF16_MAP_LIMIT:
        raise SmokeFailure(f"tracker_eval: bf16 p2-p6 differ from float32 by {map_err} of their max-abs "
                           f"(limit {BF16_MAP_LIMIT})")
    if min(map_err.values()) == 0.0:
        raise SmokeFailure(f"tracker_eval: a bf16 map equals its float32 map exactly: {map_err}")
    return {"built": runs["float32"]["built"], "recents": runs["float32"]["recents"]}


def assoc_step(state, det, emb, tcfg, metric: str, hw):
    """One frame's association under ``metric`` (``embeddings_exact``: the
    Jonker-Volgenant solve), then prune, snapshot and age."""
    import dataclasses as dc

    from apse_uav_torch.dcnn import structures, tracker as tr

    if metric != "embeddings_exact":
        return tr.tracker_step_assoc(state, det, emb, dc.replace(tcfg, association_metric=metric), hw)
    state = tr.associate_embeddings(state, det, emb, tcfg.embedding_dist_threshold, exact=True)
    state = structures.delete_undetected(state, tcfg.delete_after_undetected)
    return structures.finish_association(state), structures.recent_objects(state)


def association_phase(frames_np, t8: dict, card: str, dev) -> dict:
    """Phase 8's float32 detections and embeddings through ``embeddings`` (the
    default: the auction kernel), ``bbox_center_dist``, ``mask_iou`` and
    ``embeddings(exact=True)`` from an empty store, on the card and on the
    CPU: identical valid, ids and classes frame by frame; each metric's ms,
    syncs, launches and auction sweeps per batch.  The auction kernel on the
    real costs of the card's ``embeddings`` run (every frame, every budget)
    against the plain version's CPU run, and timed on them.
    Then ``linear_sum_assignment`` and
    ``auction_assignment`` on the card on seeded 32x32 costs, both ways: JV's
    cost equal to scipy's within float32 rounding, the auction within n x
    its last eps (spread / 4096); ms per solve."""
    import scipy.optimize
    import torch

    from apse_uav_torch.dcnn import cuda_auction, hungarian, structures

    tracker, pre = t8["built"]
    n, hw = frames_np.shape[0], tuple(frames_np.shape[1:3])
    batches = []
    for b in range(0, n, TRACK_BATCH):
        dets, feats = tracker.predictor(pre(torch.from_numpy(frames_np[b:b + TRACK_BATCH]).to(dev),
                                            with_gray=False)[0])
        batches.append(tracker.embed(dets, feats))
    tcfg = tracker.cfg
    res = {}
    real = []  # the auction's inputs in the card's embeddings run
    for metric in ("embeddings", "bbox_center_dist", "mask_iou", "embeddings_exact"):
        ids = {}
        for key, device in (("card", dev), ("cpu", torch.device("cpu"))):
            state = structures.init_track_state(tcfg.max_tracks, tcfg.embedding_dim, device=device)
            out = []
            with auction_calls(real if metric == "embeddings" and key == "card" else None):
                for det, emb in batches:
                    for t in range(emb.shape[0]):
                        state, recent = assoc_step(state, {k: v[t].to(device) for k, v in det.items()},
                                                   emb[t].to(device), tcfg, metric, hw)
                        out.append({k: recent[k].cpu().numpy() for k in ("valid", "ids", "classes")})
            ids[key] = out
        for i, (g, c) in enumerate(zip(ids["card"], ids["cpu"])):
            for k in g:
                if not np.array_equal(g[k], c[k]):
                    raise SmokeFailure(f"association {metric} frame {i}: {k} differ, card {g[k].tolist()} "
                                       f"CPU {c[k].tolist()}")
        det0, emb0 = batches[0]
        state0 = structures.init_track_state(tcfg.max_tracks, tcfg.embedding_dim, device=dev)
        for t in range(emb0.shape[0]):  # the store the first batch leaves
            state0, _ = assoc_step(state0, {k: v[t] for k, v in det0.items()}, emb0[t], tcfg, metric, hw)

        def one_batch():
            s = state0
            for t in range(emb0.shape[0]):
                s, _ = assoc_step(s, {k: v[t] for k, v in det0.items()}, emb0[t], tcfg, metric, hw)
            return s

        ms = wall_ms(one_batch)
        res[metric] = {"ms_per_batch": round(ms, 3), "batch": association_stats(one_batch, ms),
                       "tracks": [int(r["valid"].sum()) for r in ids["card"]],
                       "max_id": int(max(int(r["ids"][r["valid"]].max(initial=0)) for r in ids["card"]))}
    thr = tcfg.embedding_dist_threshold
    if len(real) != n:
        raise SmokeFailure(f"association: the auction ran {len(real)} times for {n} frames")
    auction = {"real_costs": auction_check([("real", tuple(a.cpu() for a in r)) for r in real], dev, thr),
               "timing_real_costs": auction_timing(real, thr)}
    solvers = {}
    for seed in range(3):
        c = np.random.default_rng(seed).uniform(0, 4, (32, 32)).astype(np.float32)
        for maximize in (False, True):
            r, sc = scipy.optimize.linear_sum_assignment(c, maximize=maximize)
            best = float(c[r, sc].astype(np.float64).sum())
            ct = torch.from_numpy(c).to(dev)
            for name, fn, limit in (("jv", hungarian.linear_sum_assignment, 1e-4),
                                    ("auction", hungarian.auction_assignment,
                                     32 * float(c.max() - c.min()) / 4096 + 1e-4)):
                cols = fn(ct, maximize)[1].cpu().numpy()
                got = float(c[np.arange(32), cols].astype(np.float64).sum())
                if sorted(cols.tolist()) != list(range(32)) or abs(got - best) > limit:
                    raise SmokeFailure(f"{name} seed {seed} maximize {maximize}: cost {got}, scipy {best}, "
                                       f"limit {limit}")
                entry = solvers.setdefault(name, {"max_cost_gap": 0.0})
                entry["max_cost_gap"] = max(entry["max_cost_gap"], abs(got - best))
                if seed == 0 and not maximize:
                    entry["ms_per_solve"] = round(wall_ms(lambda: fn(ct, maximize)), 3)
    log({"phase": "association", "frames": n, "metrics": res, "auction": auction, "solvers": solvers, "card": card})
    return {"metrics": res, "auction": auction}


def detector_phase(frames_np, card: str, dev) -> dict:
    """``detector_test``'s ``detect`` at ``aerial_view_test``'s defaults (R50-FPN,
    3 classes, no mask head, confidence 0.5) from a seeded checkpoint (its
    background bias calibrated on the frames) on 2 frames, on the card and on
    the CPU: the same valid detections and classes, boxes within 0.5 px."""
    import torch

    from apse_uav_torch.cli import aerial_view_test, detector_test, track_uav
    from apse_uav_torch.utils.synthetic import detectron2_checkpoint

    two = frames_np[:2]
    out = {}
    ckpt = detectron2_checkpoint(1, 50, 3)
    for key, device in (("card", dev.type), ("cpu", "cpu")):
        args = detector_test.build_parser().parse_args(aerial_view_test.aerial_argv(
            ["--images", "unused", "--weights", "unused", "--device", device]))
        if key == "card":
            calibration = calibrate_background(ckpt, track_uav.model_config(args), None, two, dev, per_frame=4)
        pred = detector_test.build_predictor(args, two.shape[1:3], ckpt)
        t0 = time.perf_counter()
        out[key] = [detector_test.detect(pred, f) for f in two]
        out[key + "_s"] = time.perf_counter() - t0
    box_err = 0.0
    for i, (g, c) in enumerate(zip(out["card"], out["cpu"])):
        if not np.array_equal(g["valid"], c["valid"]) or not np.array_equal(g["classes"][g["valid"]],
                                                                             c["classes"][c["valid"]]):
            raise SmokeFailure(f"detector frame {i}: valid or classes differ: {g['classes'][g['valid']].tolist()} "
                               f"vs {c['classes'][c['valid']].tolist()}")
        box_err = max(box_err, float(np.abs(g["boxes"][g["valid"]] - c["boxes"][c["valid"]]).max(initial=0.0)))
    if box_err > 0.5:
        raise SmokeFailure(f"detector: boxes differ by {box_err} px between the card and the CPU (limit 0.5)")
    res = {"detections": [int(g["valid"].sum()) for g in out["card"]], "box_err_px": box_err,
           "calibration": calibration, "card_s": round(out["card_s"], 3), "cpu_s": round(out["cpu_s"], 3)}
    log({"phase": "detector", **res, "card": card})
    if min(res["detections"]) < 1:
        raise SmokeFailure(f"detector: a frame without a detection above the confidence: {res['detections']}")
    return res


def remove_checkpoints(workdir: str) -> None:
    """Delete a training run's checkpoint files (hundreds of MB each) from the
    output directory once they are checked; results.txt / train_info.txt stay."""
    for name in os.listdir(workdir):
        if name in ("last", "bestAP", "bestAR") or name.startswith("epoch_"):
            os.remove(os.path.join(workdir, name))


def _finite_lines(path: str) -> list[float]:
    with open(path) as f:
        vals = [float(ln.split()[-1]) for ln in f.read().strip().splitlines()]
    if not vals or not all(np.isfinite(vals)):
        raise SmokeFailure(f"{path}: non-finite losses {vals}")
    return vals


def train_assoc_phase(ckpt: dict, card: str, dev, hw=(375, 1242), depth: int = 101) -> dict:
    """``train_association_head``'s CLI at its defaults on a synthetic
    KITTI-MOTS sequence (see the module docstring, phase 11); ``hw`` and
    ``depth`` shrink a CPU rehearsal."""
    import shutil

    import torch

    from apse_uav_torch.utils.synthetic import tracking_sequence, write_mots_sequence

    root = os.path.join(OUT_DIR, "train_assoc")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t0 = time.perf_counter()
    frames, objects = tracking_sequence(8, hw, 5, seed=7)
    write_mots_sequence(os.path.join(root, "instances"), os.path.join(root, "images"), "0000", frames, objects)
    with open(os.path.join(root, "seqmap.txt"), "w") as f:
        f.write("0000 empty 0 7\n")
    weights_path = os.path.join(root, "detector.pth")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in ckpt.items()}}, weights_path)
    data_s = time.perf_counter() - t0
    try:
        return _train_assoc(root, weights_path, frames, data_s, ckpt, card, dev, depth)
    finally:  # the checkpoint (~200 MB) and the frames stay out of the output directory
        os.remove(weights_path)
        shutil.rmtree(os.path.join(root, "images"), ignore_errors=True)


def _train_assoc(root, weights_path, frames, data_s, ckpt, card, dev, depth) -> dict:
    import torch

    from apse_uav_torch.cli import tracker_test, train_association_head as tah
    from apse_uav_torch.data.mot import MOTSLoader, RoiFeaturesGenerator
    from apse_uav_torch.dcnn.models.association import AssociationHead, init_weights
    from apse_uav_torch.train import optim, steps

    base = ["--instances_txt", os.path.join(root, "instances"), "--images", os.path.join(root, "images"),
            "--seqmap", os.path.join(root, "seqmap.txt"), "--weights", weights_path, "--epochs", "2",
            "--depth", str(depth), "--device", dev.type]
    runs = {}
    for name, extra in (("roi8", []), ("roi10", ["--roi_size", "10"])):
        logs = []
        t0 = time.perf_counter()
        head = tah.main(base + ["--workdir", os.path.join(root, name)] + extra, log_fn=logs.append)
        torch.cuda.synchronize()
        runs[name] = {"head": head, "s": time.perf_counter() - t0,
                      "losses": _finite_lines(os.path.join(root, name, "train_info.txt"))}
    head = runs["roi8"]["head"]
    start = init_weights(256 * 64, 128, seed=0)
    if np.array_equal(head.fc.weight.detach().cpu().numpy(), start["fc.weight"]):
        raise SmokeFailure("train_assoc: the head did not change")

    # The first step again, card against CPU, on the same ROIs.
    args = tah.build_parser().parse_args(base + ["--workdir", "unused"])
    model, cfg = tah.frozen_backbone(args, dev, ckpt)
    loader = MOTSLoader(args.instances_txt, args.images, ["0000"], RoiFeaturesGenerator(model, args.roi_size),
                        args.frames_in_batch)
    ids, rois = loader.get_training_batch("0000", 0)
    n = len(ids)
    cap = 1 << (n - 1).bit_length()
    ids_p, rois_p, valid = np.zeros(cap, np.int64), np.zeros((cap, *rois.shape[1:]), np.float32), np.arange(cap) < n
    ids_p[:n], rois_p[:n] = ids, rois
    step = {}
    for key, d in (("card", dev), ("cpu", torch.device("cpu"))):
        h = AssociationHead(rois[0].size)
        h.load_state_dict({k: torch.from_numpy(v) for k, v in start.items()})
        h = h.to(d)
        opt = optim.SGD(dict(h.named_parameters()), lr=0.01, momentum=0.9, finetune=False)
        loss = steps.association_train_step(h, opt, torch.from_numpy(rois_p).to(d), torch.from_numpy(ids_p).to(d),
                                            torch.from_numpy(valid).to(d))
        step[key] = (float(loss), {k: v.detach().cpu().numpy() for k, v in h.state_dict().items()},
                     {k: v.cpu().numpy() for k, v in opt.trace.items()})
    loss_err = abs(step["card"][0] - step["cpu"][0]) / abs(step["cpu"][0])
    upd_err, upd, grad_err = update_errors(step["card"][1], step["cpu"][1], start, step["card"][2], step["cpu"][2])
    # tracker_test reads the roi-10 head's epoch_1 through --assoc_weights.
    head_path = os.path.join(root, "roi10", "epoch_1")
    targs = tracker_test.build_parser().parse_args(["--sequence", "unused", "--weights", weights_path,
                                                    "--assoc_weights", head_path, "--depth", str(depth),
                                                    "--num_classes", "4", "--batch", str(TRACK_BATCH), "--device",
                                                    dev.type])
    built = tracker_test.build_tracker(targs, frames.shape[1:3])
    trained = runs["roi10"]["head"].state_dict()
    if not all(torch.equal(built[0].head.state_dict()[k].cpu(), v.cpu()) for k, v in trained.items()):
        raise SmokeFailure("train_assoc: tracker_test --assoc_weights did not load the trained head")
    recents, tstats = tracker_test.track_sequence(targs, list(frames[:TRACK_BATCH, :, :, ::-1]), built)
    res = {"frames": len(frames), "size": list(frames.shape[1:3]), "rois_first_batch": n, "padded_to": cap,
           "gradient_err_card_cpu": grad_err,
           "data_s": round(data_s, 3), "epoch_losses": {k: r["losses"] for k, r in runs.items()},
           "run_s": {k: round(r["s"], 3) for k, r in runs.items()}, "first_step_loss": step["card"][0],
           "loss_rel_err_card_cpu": loss_err, "update_err_card_cpu": upd_err, "update_max_abs": upd,
           "tracker_test_frames": tstats["frames"], "card": card}
    log({"phase": "train_assoc", **res})
    for name in ("roi8", "roi10"):
        remove_checkpoints(os.path.join(root, name))
    if len(recents) != TRACK_BATCH:
        raise SmokeFailure(f"train_assoc: tracker_test gave {len(recents)} snapshots for {TRACK_BATCH} frames")
    if loss_err > 1e-5 or upd_err > 1e-5 or grad_err > 1e-5:
        raise SmokeFailure(f"train_assoc: card vs CPU first step: loss {loss_err}, update {upd_err}, gradient "
                           f"{grad_err} (limits 1e-5)")
    return res


def update_errors(card: dict, cpu: dict, start: dict, card_trace: dict, cpu_trace: dict) -> tuple:
    """Card against CPU after one step from the same ``start``: (the largest
    difference of the updated tensors beyond the 2 ulp that rounding each
    side's own sum p + u can give, over the update's max-abs; that max-abs;
    the momentum traces' (the first step's gradients) largest difference
    over their max-abs)."""
    upd = max(float(np.abs(v - np.asarray(start[k])).max()) for k, v in cpu.items())
    excess = max(float(np.maximum(np.abs(card[k] - v) - 2 * np.spacing(np.abs(v)), 0).max()) for k, v in cpu.items())
    scale = max(float(np.abs(v).max()) for v in cpu_trace.values())
    grad = max(float(np.abs(card_trace[k] - v).max()) for k, v in cpu_trace.items()) / scale
    return excess / upd, upd, grad


def detector_step_profile(model, opt, images, gt, key) -> dict:
    """A training step of ``model`` on the card: steady ms (host clock ending
    in a synchronize), its split by stage (CUDA events at the step's marks),
    one step profiled, its host syncs and peak memory."""
    import torch

    from apse_uav_torch.train import steps

    def step(mark=None):
        return steps.detector_train_step(model, opt, images, gt, key, True, mark=mark)

    step_ms = wall_ms(step, iters=5)
    events = []

    def mark(stage):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((stage, ev))

    split = {}
    for _ in range(3):
        events.clear()
        mark("start")
        step(mark)
        torch.cuda.synchronize()
        for (_, a), (stage, b) in zip(events, events[1:]):
            split.setdefault(stage, []).append(a.elapsed_time(b))
    split = {k: round(float(np.median(v)), 3) for k, v in split.items()}
    profile = profile_call(step, step_ms)
    profile["top_kernels"] = profile["top_kernels"][:6]
    syncs = count_syncs(step)
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    return {"step_ms": round(step_ms, 3), "split_ms": split, "syncs_per_step": syncs,
            "peak_mem_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3), "profile": profile}


def train_detector_phase(ckpt: dict, card: str, dev, hw=None, depth: int = 101) -> dict:
    """``finetune_detector`` at ``finetune_uav``'s defaults (see the module
    docstring, phase 12); ``hw`` (the train size) and ``depth`` shrink a CPU
    rehearsal."""
    import shutil

    import torch

    from apse_uav_torch.cli import finetune_uav
    from apse_uav_torch.dcnn import flax_init
    from apse_uav_torch.train import checkpoint as tckpt, loop, optim, steps
    from apse_uav_torch.utils import profiling
    from apse_uav_torch.utils.synthetic import detection_scenes

    root = os.path.join(OUT_DIR, "train_detector")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    weights_path = os.path.join(root, "detector.pth")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in ckpt.items()}}, weights_path)
    workdir = os.path.join(root, "run")
    size = [] if hw is None else ["--train_size", str(hw[0]), str(hw[1])]
    args = finetune_uav.build_parser().parse_args(["--workdir", workdir, "--weights", weights_path, "--max_iter", "6",
                                                   "--test_period", "3", "--depth", str(depth), "--device", dev.type]
                                                  + size)
    cfg = finetune_uav.model_config(args)
    t0 = time.perf_counter()
    try:
        init = finetune_uav.initial_weights(args, cfg, dev)
    finally:
        os.remove(weights_path)
    init_s = time.perf_counter() - t0
    hw = tuple(args.train_size)
    evals = [next(detection_scenes(args.batch_size, hw, seed=99))]
    losses, logs = [], []
    profiling.reset_counters()
    t0 = time.perf_counter()
    model = loop.finetune_detector(cfg, detection_scenes(args.batch_size, hw, seed=0), lambda: evals, workdir,
                                   max_iter=args.max_iter, to_train=tuple(args.to_train), lr=args.lr,
                                   test_period=args.test_period, init_params=init, device=dev, log_fn=logs.append,
                                   on_step=lambda i, l: losses.append({k: float(v) for k, v in l.items()}))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = profiling.counted("launch")
    if len(losses) != 6 or not all(np.isfinite(v) for l in losses for v in l.values()):
        raise SmokeFailure(f"train_detector: losses {losses}")
    trained = [k for k, lab in optim.param_labels(list(init), args.to_train).items() if lab == "train"]
    got = model.state_dict()
    frozen_changed = [k for k in init if k not in trained and not torch.equal(got[k].cpu(), init[k].cpu())]
    unchanged = [k for k in trained if torch.equal(got[k].cpu(), init[k].cpu())]
    if frozen_changed or unchanged:
        raise SmokeFailure(f"train_detector: frozen changed {frozen_changed[:3]}, trained unchanged {unchanged[:3]}")
    with open(os.path.join(workdir, "results.txt")) as f:
        rows = f.read().strip().splitlines()
    missing = [n for n in ("last", "bestAP", "bestAR") if not os.path.exists(os.path.join(workdir, n))]
    if len(rows) != 3 or missing:
        raise SmokeFailure(f"train_detector: results.txt rows {len(rows) - 1}, missing checkpoints {missing}")
    state = tckpt.load_state(workdir, "last")
    resumed = loop.finetune_detector(cfg, detection_scenes(args.batch_size, hw, seed=0), lambda: evals, workdir,
                                     max_iter=6, to_train=tuple(args.to_train), init_params=init, device=dev,
                                     log_fn=logs.append)
    if (state["iteration"] != 6 or int(state["opt_state"]["count"]) != 6 or "resumed at iteration 6" not in logs
            or not all(torch.equal(v.cpu(), state["params"][k]) for k, v in resumed.state_dict().items())):
        raise SmokeFailure(f"train_detector: resume from last: iteration {state['iteration']}, count "
                           f"{int(state['opt_state']['count'])}, logs {logs[-2:]}")
    del resumed, state
    remove_checkpoints(workdir)

    # One step at batch 1, card against CPU, at the schedule's full rate, on
    # the card's (frozen) backbone maps and proposals: the maps are held to
    # the CPU's own alone, since ROIAlign's bf16 copy of them turns a last-bit
    # difference into a whole bf16 step, and top-k and NMS flip on such
    # differences of the logits.
    images, gt = next(detection_scenes(1, hw, seed=5))
    key = flax_init.prng_key(123)
    one = {}
    feats = proposals = None
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        t0 = time.perf_counter()
        m = loop.build_detector(cfg, init, 0, d)
        tensors = m.state_dict(keep_vars=True)
        opt = optim.build_finetune_optimizer(tensors, args.to_train, lr=optim.warmup_multistep_schedule(
            args.lr, (), 1, 1.0))
        steps.trainable_only(opt.trainable(), tensors.values())
        x = torch.from_numpy(images).to(d)
        with torch.no_grad():
            own_feats = m.features(x)
        own = m.training_proposals(x, own_feats)
        if feats is None:
            feats, proposals = own_feats, own
        else:  # the CPU's own maps and proposals against the card's
            map_err = max(float((own_feats[k] - feats[k].cpu()).abs().max() / own_feats[k].abs().max())
                          for k in own_feats)
            moved = ((own[0] - proposals[0].cpu()).abs().amax(dim=-1) > 0.01) | (own[1] != proposals[1].cpu())
        del own_feats
        l = steps.detector_train_step(m, opt, x, {k: torch.from_numpy(v).to(d) for k, v in gt.items()}, key, True,
                                      proposals=tuple(t.to(d) for t in proposals),
                                      features={k: v.to(d) for k, v in feats.items()})
        one[name] = ({k: float(v) for k, v in l.items()}, {k: tensors[k].detach().cpu().numpy() for k in opt.names},
                     {k: v.cpu().numpy() for k, v in opt.trace.items()}, time.perf_counter() - t0)
        del m, opt, tensors
    loss_err = {k: abs(one["card"][0][k] - v) / abs(v) for k, v in one["cpu"][0].items()}
    start = {k: torch.as_tensor(init[k]).cpu().numpy() for k in one["cpu"][1]}
    upd_err, upd, grad_err = update_errors(one["card"][1], one["cpu"][1], start, one["card"][2], one["cpu"][2])

    # The steady step at batch 4 on a fresh model.
    m = loop.build_detector(cfg, init, 0, dev)
    tensors = m.state_dict(keep_vars=True)
    opt = optim.build_finetune_optimizer(tensors, args.to_train, lr=optim.warmup_multistep_schedule(args.lr, (), 50))
    steps.trainable_only(opt.trainable(), tensors.values())
    bimages, bgt = next(detection_scenes(args.batch_size, hw, seed=6))
    perf = detector_step_profile(m, opt, torch.from_numpy(bimages).to(dev),
                                 {k: torch.from_numpy(v).to(dev) for k, v in bgt.items()}, key)
    res = {"depth": cfg.depth, "batch": args.batch_size, "size": list(hw), "iterations": 6,
           "init_s": round(init_s, 3), "run_s": round(run_s, 3), "losses": losses,
           "results": [r.split("\t")[:3] for r in rows[1:]], "launches": counts,
           "card_cpu_loss_rel_err": loss_err, "card_cpu_update_err": upd_err, "update_max_abs": upd,
           "card_cpu_gradient_err": grad_err, "card_cpu_map_rel_err": map_err,
           "cpu_own_proposals_moved": int(moved.sum()),
           "proposals": int(proposals[1].sum()),
           "cpu_step_s": round(one["cpu"][3], 3), **perf, "card": card}
    log({"phase": "train_detector", **{k: v for k, v in res.items() if k != "profile"}})
    log({"phase": "train_detector_profile", **perf["profile"]})
    if max(loss_err.values()) > 1e-4 or upd_err > 1e-4 or grad_err > 1e-4 or map_err > 1e-4:
        raise SmokeFailure(f"train_detector: card vs CPU: losses {loss_err}, update {upd_err}, gradient "
                           f"{grad_err}, maps {map_err} (limits 1e-4)")
    return res


def learning_phase(card: str, dev) -> dict:
    """The reference's learning regression on the card (phase 13)."""
    import shutil

    import torch

    from apse_uav_torch.train import loop
    from apse_uav_torch.utils.synthetic import learning_config, learning_scenes

    root = os.path.join(OUT_DIR, "learning")
    shutil.rmtree(root, ignore_errors=True)
    evals = [next(learning_scenes(seed=1000 + i)) for i in range(4)]
    t0 = time.perf_counter()
    loop.finetune_detector(learning_config(), learning_scenes(seed=0), lambda: evals, root, max_iter=150,
                           test_period=25, lr=0.005, seed=0, device=dev, log_fn=lambda s: None)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    remove_checkpoints(root)
    with open(os.path.join(root, "results.txt")) as f:
        lines = f.read().strip().splitlines()
    header = lines[0].split("\t")
    ap50 = [float(ln.split("\t")[header.index("AP50")]) for ln in lines[1:]]
    res = {"iterations": 150, "ap50_every_25": ap50, "ap50_final": ap50[-1], "ap50_best": max(ap50),
           "seconds": round(seconds, 3), "card": card}
    log({"phase": "learning", **res})
    if len(ap50) != 6 or max(ap50) < 0.7:
        raise SmokeFailure(f"learning: AP50 {ap50} never reached 0.7")
    return res


# -- slice 8: C4, bf16 training, surgery CLIs, COWC, SelectivePredictor, parallelism --


def reset_and_read(fn):
    """``fn()`` with every launch count set to 0 just before and read just
    after: (its result, the counts).  Of the slice-8 paths only the ArUco
    front of phase 20 reaches kernels of ``csrc``; the others leave every
    count at 0."""
    from apse_uav_torch.utils import profiling

    profiling.reset_counters()
    out = fn()
    return out, profiling.counted("launch")


def rel_err(a, b) -> float:
    """max |a - b| over max |b| (tensors on any device)."""
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-12))


def unmatched_detections(a: dict, b: dict, i: int, box_tol: float, score_tol: float, thresh: float) -> int:
    """Valid detections of image i in ``a`` with no detection in ``b`` of the
    same class, a box within ``box_tol`` px and a score within ``score_tol``
    (both ways), leaving out those whose score lies within ``score_tol`` of
    the threshold or of the lowest kept score (where a last-bit difference
    may decide the cut)."""
    import torch

    def rows(d):
        v = d["valid"][i].cpu()
        return d["classes"][i].cpu()[v], d["boxes"][i].cpu()[v], d["scores"][i].cpu()[v]

    (ca, ba, sa), (cb, bb, sb) = rows(a), rows(b)
    low = min(float(sa.min()) if len(sa) else 1.0, float(sb.min()) if len(sb) else 1.0)
    missing = 0
    for (c1, b1, s1), (c2, b2, s2) in (((ca, ba, sa), (cb, bb, sb)), ((cb, bb, sb), (ca, ba, sa))):
        for c, box, sc in zip(c1, b1, s1):
            if abs(float(sc) - thresh) <= score_tol or abs(float(sc) - low) <= score_tol:
                continue
            ok = (c2 == c) & ((b2 - box).abs().amax(dim=-1) <= box_tol) & ((s2 - sc).abs() <= score_tol)
            missing += int(not bool(torch.any(ok)))
    return missing


def c4_phase(frames_np, card: str, dev, cfg=None) -> dict:
    """R101-C4 (``mask_rcnn_r101_c4(4)``'s widths and input sizes) through
    ``TrackPredictor`` on 4 frames from a seeded detectron2-named C4 ``.pkl``
    (phase 14; a smaller ``cfg`` shrinks a CPU rehearsal)."""
    import pickle

    import torch

    from apse_uav_torch.dcnn import weights as W
    from apse_uav_torch.dcnn.config import mask_rcnn_r101_c4
    from apse_uav_torch.dcnn.engines import TrackPredictor, full_fp32
    from apse_uav_torch.dcnn.models.roi_heads import box_inference
    from apse_uav_torch.utils.synthetic import detectron2_checkpoint

    cfg = cfg or mask_rcnn_r101_c4(4)
    depth = cfg.depth
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, "c4_r101.pkl")
    with open(path, "wb") as f:
        pickle.dump({"model": detectron2_checkpoint(8, depth, 4, architecture="c4"), "__author__": "seeded"}, f)
    frames = frames_np[:TRACK_BATCH]
    h, w = frames.shape[1:3]
    t0 = time.perf_counter()
    weights = W.load_torch_file(path)
    os.remove(path)
    load_s = time.perf_counter() - t0
    # Random weights: the background bias set so that each frame holds >= 10
    # candidates above the threshold, none near it (as in phase 7).
    calibration = calibrate_background(weights, cfg, None, frames, dev)
    t0 = time.perf_counter()
    pred = TrackPredictor(cfg, weights, (h, w), device=dev)
    load_s += time.perf_counter() - t0
    if pred.missing:
        raise SmokeFailure(f"c4: the C4 import left {pred.missing[:3]} at init")
    model = pred.model
    x_dev = torch.from_numpy(frames).to(dev)
    (dets, feats), counts = reset_and_read(lambda: pred(x_dev))
    torch.cuda.synchronize()
    d, r = cfg.roi.detections_per_image, 2 * cfg.roi.mask_pooler_resolution
    if (tuple(dets["boxes"].shape) != (TRACK_BATCH, d, 4) or tuple(dets["masks"].shape) != (TRACK_BATCH, d, r, r)
            or set(feats) != {"res2", "res3", "res4"}):
        raise SmokeFailure(f"c4: shapes {tuple(dets['boxes'].shape)}, {tuple(dets['masks'].shape)}, {sorted(feats)}")
    bad = [k for k, v in {**dets, **feats}.items() if v.is_floating_point() and not torch.isfinite(v).all()]
    if bad:
        raise SmokeFailure(f"c4: non-finite outputs {bad}")

    # Stage times (each alone, ending in a synchronize), the batch profiled.
    x = pred.resize(x_dev)
    hw_pad = pred.pad_hw
    stage = {}
    with torch.no_grad(), full_fp32():
        f = model.features(x)
        boxes, _, valid = model.proposals(f, hw_pad)
        nb, p = boxes.shape[:2]
        det = model.detect(f, boxes, valid, hw_pad)
        stage["backbone"] = wall_ms(lambda: model.features(x))
        stage["rpn_proposals"] = wall_ms(lambda: model.proposals(f, hw_pad))

        def box_head():
            logits, deltas = model.box_outputs(model.roi_transform(f["res4"], boxes), nb, p)
            return box_inference(logits, deltas, boxes, valid, hw_pad, cfg.roi)

        stage["res5_box_head"] = wall_ms(box_head)
        stage["res5_mask_rerun"] = wall_ms(lambda: model.roi_heads.mask_head(
            model.roi_transform(f["res4"], det["boxes"])))
    batch_ms = wall_ms(lambda: pred(x_dev))
    profile = profile_call(lambda: pred(x_dev), batch_ms)
    profile["top_kernels"] = profile["top_kernels"][:6]
    torch.cuda.reset_peak_memory_stats()
    pred(x_dev)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30

    # Frame 1 on the CPU: its own res4 against the card's; the detections
    # from the card's maps and proposals (top-k and NMS order follow the
    # scores' last bits).
    cpred = TrackPredictor(cfg, weights, (h, w), device="cpu")
    cx = cpred.resize(frames[:1])
    with torch.no_grad():
        cf = cpred.model.features(cx)
        map_err = rel_err(feats["res4"][:1], cf["res4"])
        card_f = {k: v[:1].cpu() for k, v in feats.items()}
        cdet = cpred.postprocess(cpred.model.detect(card_f, boxes[:1].cpu(), valid[:1].cpu(), hw_pad))
    gdet = {k: v[:1] for k, v in dets.items()}
    unmatched = unmatched_detections(gdet, cdet, 0, 1e-3 * max(h, w) / 1344, 1e-4, cfg.roi.score_thresh_test)
    same = bool(torch.equal(gdet["valid"].cpu(), cdet["valid"]) and torch.equal(gdet["classes"].cpu(),
                                                                                  cdet["classes"]))
    box_err = float((gdet["boxes"].cpu() - cdet["boxes"]).abs().max()) if same else None
    mask_err = float((gdet["masks"].cpu() - cdet["masks"]).abs().max()) if same else None
    res = {"depth": depth, "frames": TRACK_BATCH, "size": [w, h], "net_hw": list(pred.net_hw),
           "pad_hw": list(pred.pad_hw), "proposals": p, "detections": d, "mask_size": r,
           "valid_detections": dets["valid"].sum(dim=1).tolist(), "calibration": calibration,
           "load_s": round(load_s, 3),
           "batch_ms": round(batch_ms, 3), "frames_per_s": round(TRACK_BATCH * 1e3 / batch_ms, 3),
           "stage_ms": {k: round(v, 3) for k, v in stage.items()}, "device_busy_ms": profile["device_busy_ms"],
           "device_idle_share": profile["device_idle_share"], "kernel_launches": profile["kernel_launches"],
           "top_kernels": profile["top_kernels"], "peak_mem_gib": round(peak, 3), "launches": counts,
           "card_cpu_res4_rel_err": map_err, "card_cpu_same_order": same, "card_cpu_box_err_px": box_err,
           "card_cpu_mask_err": mask_err, "card_cpu_unmatched": unmatched, "card": card}
    log({"phase": "c4", **res})
    if min(res["valid_detections"]) < 1:
        raise SmokeFailure(f"c4: no detection above the threshold in some frame: {res['valid_detections']}")
    if map_err > 1e-4 or unmatched or (same and (box_err > 1e-2 or mask_err > 1e-4)):
        raise SmokeFailure(f"c4: card vs CPU: res4 {map_err} (limit 1e-4), unmatched detections {unmatched}, "
                           f"boxes {box_err} px (limit 1e-2), masks {mask_err} (limit 1e-4)")
    return res


def c4_train_phase(card: str, dev, cfg=None, hw=(768, 1344)) -> dict:
    """One R101-C4 fine-tune step at batch 2 (phase 15): the default
    ``to_train`` trains the RPN head and the mask head only (``res5`` and the
    box predictor frozen, as the reference labels them), card against CPU on
    the card's maps and proposals; the step's ms on the card."""
    import torch

    from apse_uav_torch.dcnn import flax_init
    from apse_uav_torch.dcnn.config import mask_rcnn_r101_c4
    from apse_uav_torch.train import loop, optim, steps
    from apse_uav_torch.utils.synthetic import detection_scenes, detectron2_checkpoint

    cfg = cfg or mask_rcnn_r101_c4(4)
    depth = cfg.depth
    ckpt = detectron2_checkpoint(8, depth, 4, architecture="c4")
    images, gt = next(detection_scenes(2, hw, seed=7))
    ms = 8  # box-filled masks at 1/8 of the image (the losses crop them at any scale)
    gt["masks"] = np.zeros((2, gt["boxes"].shape[1], hw[0] // ms, hw[1] // ms), np.float32)
    for i, j in zip(*np.nonzero(gt["valid"])):
        x1, y1, x2, y2 = (gt["boxes"][i, j] / ms).astype(int)
        gt["masks"][i, j, y1:y2 + 1, x1:x2 + 1] = 1.0
    to_train = ("proposal_generator", "roi_heads")
    key = flax_init.prng_key(123)
    one, feats, proposals, counts = {}, None, None, None
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        m = loop.build_detector(cfg, ckpt, 0, d)
        tensors = m.state_dict(keep_vars=True)
        opt = optim.build_finetune_optimizer(tensors, to_train, lr=optim.warmup_multistep_schedule(0.02, (), 1, 1.0))
        steps.trainable_only(opt.trainable(), tensors.values())
        x = torch.from_numpy(images).to(d)
        g = {k: torch.from_numpy(v).to(d) for k, v in gt.items()}
        if feats is None:
            with torch.no_grad():
                feats = m.features(x)
            proposals = m.training_proposals(x, feats)
        t0 = time.perf_counter()
        l, c = reset_and_read(lambda: steps.detector_train_step(
            m, opt, x, g, key, True, proposals=tuple(t.to(d) for t in proposals),
            features={k: v.to(d) for k, v in feats.items()}))
        counts = counts or c
        one[name] = ({k: float(v) for k, v in l.items()},
                     {k: tensors[k].detach().cpu().numpy().copy() for k in opt.names},
                     {k: v.cpu().numpy().copy() for k, v in opt.trace.items()}, time.perf_counter() - t0, opt.names)
        if name == "card":
            perf = detector_step_profile(m, opt, x, g, key)
            frozen_moved = [k for k, v in tensors.items() if k not in opt.names
                            and not np.array_equal(v.detach().cpu().numpy(), ckpt[k])]
        del m, opt, tensors
    names = one["card"][4]
    trained = sorted({k.split(".")[1] for k in names})
    loss_err = {k: abs(one["card"][0][k] - v) / abs(v) for k, v in one["cpu"][0].items()}
    upd_err, upd, grad_err = update_errors(one["card"][1], one["cpu"][1], ckpt, one["card"][2], one["cpu"][2])
    res = {"depth": depth, "batch": 2, "size": list(hw), "trained_modules": trained,
           "trained_tensors": len(names), "frozen_moved": frozen_moved[:3], "losses": one["card"][0],
           "card_cpu_loss_rel_err": loss_err, "card_cpu_update_err": upd_err, "update_max_abs": upd,
           "card_cpu_gradient_err": grad_err, "cpu_step_s": round(one["cpu"][3], 3), "launches": counts,
           **{k: v for k, v in perf.items() if k != "profile"}, "device_busy_ms": perf["profile"]["device_busy_ms"],
           "device_idle_share": perf["profile"]["device_idle_share"],
           "kernel_launches": perf["profile"]["kernel_launches"], "card": card}
    log({"phase": "c4_train", **res})
    if trained != ["mask_head", "rpn_head"] or frozen_moved:
        raise SmokeFailure(f"c4_train: trained {trained} (want mask_head, rpn_head), frozen moved {frozen_moved[:3]}")
    if max(loss_err.values()) > 1e-4 or upd_err > 1e-4 or grad_err > 1e-4:
        raise SmokeFailure(f"c4_train: card vs CPU: losses {loss_err}, update {upd_err}, gradient {grad_err} "
                           "(limits 1e-4)")
    return res


def train_bf16_phase(ckpt: dict, f32_step_ms: float, card: str, dev, hw=None, depth: int = 101) -> dict:
    """``finetune_uav``'s defaults in the reference's bf16 regime
    (``compute_dtype="bfloat16"``, ``head_compute_dtype="float32"``) from
    phase 7's checkpoint (phase 16): the steady step beside phase 12's
    float32 one, and one step at batch 1 card against CPU on the card's bf16
    maps and proposals."""
    import torch

    from apse_uav_torch.cli import finetune_uav
    from apse_uav_torch.dcnn import flax_init
    from apse_uav_torch.train import loop, optim, steps
    from apse_uav_torch.utils.synthetic import detection_scenes

    size = [] if hw is None else ["--train_size", str(hw[0]), str(hw[1])]
    args = finetune_uav.build_parser().parse_args(["--workdir", "unused", "--depth", str(depth)] + size)
    cfg = dataclasses.replace(finetune_uav.model_config(args), compute_dtype="bfloat16",
                              head_compute_dtype="float32")
    hw = tuple(args.train_size)
    key = flax_init.prng_key(123)
    images, gt = next(detection_scenes(1, hw, seed=5))
    one, given, counts = {}, None, None
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        m = loop.build_detector(cfg, ckpt, 0, d)
        tensors = m.state_dict(keep_vars=True)
        opt = optim.build_finetune_optimizer(tensors, args.to_train, lr=optim.warmup_multistep_schedule(
            args.lr, (), 1, 1.0))
        steps.trainable_only(opt.trainable(), tensors.values())
        x = torch.from_numpy(images).to(d)
        if given is None:
            with torch.no_grad():
                feats = m.features(x)
            given = feats, m.training_proposals(x, feats)
        l, c = reset_and_read(lambda: steps.detector_train_step(
            m, opt, x, {k: torch.from_numpy(v).to(d) for k, v in gt.items()}, key, True,
            proposals=tuple(t.to(d) for t in given[1]), features={k: v.to(d) for k, v in given[0].items()}))
        counts = counts or c
        one[name] = ({k: float(v) for k, v in l.items()}, {k: tensors[k].detach().cpu().numpy() for k in opt.names},
                     {k: v.cpu().numpy() for k, v in opt.trace.items()})
        del m, opt, tensors
    dtypes = sorted({str(v.dtype) for v in given[0].values()})
    loss_err = {k: abs(one["card"][0][k] - v) / abs(v) for k, v in one["cpu"][0].items()}
    upd_err, upd, grad_err = update_errors(one["card"][1], one["cpu"][1], ckpt, one["card"][2], one["cpu"][2])
    m = loop.build_detector(cfg, ckpt, 0, dev)
    tensors = m.state_dict(keep_vars=True)
    opt = optim.build_finetune_optimizer(tensors, args.to_train, lr=optim.warmup_multistep_schedule(args.lr, (), 50))
    steps.trainable_only(opt.trainable(), tensors.values())
    bimages, bgt = next(detection_scenes(args.batch_size, hw, seed=6))
    perf = detector_step_profile(m, opt, torch.from_numpy(bimages).to(dev),
                                 {k: torch.from_numpy(v).to(dev) for k, v in bgt.items()}, key)
    param_dtypes = sorted({str(v.dtype) for v in tensors.values()})
    res = {"depth": depth, "batch": args.batch_size, "size": list(hw), "map_dtypes": dtypes,
           "param_dtypes": param_dtypes, "step_ms": perf["step_ms"], "float32_step_ms": f32_step_ms,
           "split_ms": perf["split_ms"], "syncs_per_step": perf["syncs_per_step"], "peak_mem_gib": perf["peak_mem_gib"],
           "device_busy_ms": perf["profile"]["device_busy_ms"],
           "device_idle_share": perf["profile"]["device_idle_share"],
           "kernel_launches": perf["profile"]["kernel_launches"], "top_kernels": perf["profile"]["top_kernels"],
           "losses": one["card"][0], "card_cpu_loss_rel_err": loss_err, "card_cpu_update_err": upd_err,
           "update_max_abs": upd, "card_cpu_gradient_err": grad_err, "launches": counts, "card": card}
    log({"phase": "train_bf16", **res})
    if dtypes != ["torch.bfloat16"] or param_dtypes != ["torch.float32"]:
        raise SmokeFailure(f"train_bf16: maps {dtypes}, parameters {param_dtypes}")
    if not all(np.isfinite(v) for v in one["card"][0].values()):
        raise SmokeFailure(f"train_bf16: losses {one['card'][0]}")
    if max(loss_err.values()) > 1e-4 or upd_err > 1e-4 or grad_err > 1e-4:
        raise SmokeFailure(f"train_bf16: card vs CPU: losses {loss_err}, update {upd_err}, gradient {grad_err} "
                           "(limits 1e-4)")
    return res


def _reloads(workdir: str, cfg) -> int:
    """Load ``workdir/last`` into a model of ``cfg``: the number of missing keys."""
    from apse_uav_torch.dcnn import weights as W
    from apse_uav_torch.dcnn.models.c4 import build_model
    from apse_uav_torch.train import checkpoint as tckpt

    state = tckpt.load_state(workdir, "last")
    return len(W.load_detectron2(build_model(cfg), state["params"])[0])


def surgery_phase(frame_np, card: str, dev, depth: int = 101, hw=(540, 960), train_size=None) -> dict:
    """The weight-surgery and remaining training CLIs on the card (phase 17):
    ``add_mask_head`` on two seeded R-FPN checkpoints (the result loads into
    the port and gives masks), ``finetune_segmentation`` (2 iterations,
    ``--merge_into``), ``finetune_faster_rcnn_aerial --rpn_only`` and
    ``finetune_coco_dataset`` (2 iterations each) on seeded COCO and UAVDT
    trees under OUT_DIR; every run exits 0 and every checkpoint reloads."""
    import pickle
    import shutil

    import torch

    from apse_uav_torch.cli import (add_mask_head, finetune_coco_dataset, finetune_faster_rcnn_aerial,
                                    finetune_segmentation)
    from apse_uav_torch.dcnn import weights as W
    from apse_uav_torch.dcnn.config import mask_rcnn_r50_fpn, mask_rcnn_r101_fpn
    from apse_uav_torch.dcnn.engines import TrackPredictor
    from apse_uav_torch.utils.synthetic import detectron2_checkpoint, write_coco_dataset, write_uavdt_dataset

    root = os.path.join(OUT_DIR, "surgery")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t0 = time.perf_counter()
    ann, images = write_coco_dataset(os.path.join(root, "coco"), 5, hw, seed=3)
    uav = write_uavdt_dataset(os.path.join(root, "uav"), 2, 2, hw, seed=4)
    data_s = time.perf_counter() - t0

    def save_pth(path, ckpt):
        torch.save({"model": {k: torch.from_numpy(v) for k, v in ckpt.items()}}, path)

    det_pth, src_pkl = os.path.join(root, "det.pth"), os.path.join(root, "coco80.pkl")
    save_pth(det_pth, detectron2_checkpoint(11, depth, 4, mask_on=False))
    with open(src_pkl, "wb") as f:
        pickle.dump({"model": detectron2_checkpoint(12, depth, 80), "__author__": "seeded"}, f)
    merged = os.path.join(root, "merged.pkl")
    dev_flag = ["--device", dev.type]
    runs = {}

    def run(name, fn):
        t = time.perf_counter()
        rc, counts = reset_and_read(fn)
        torch.cuda.synchronize()
        runs[name] = {"rc": rc, "s": round(time.perf_counter() - t, 3), "launches": counts}
        if rc != 0:
            raise SmokeFailure(f"surgery: {name} exited {rc}")

    run("add_mask_head", lambda: add_mask_head.main(["--detector", det_pth, "--mask_source", src_pkl, "--out", merged,
                                                     "--depth", str(depth), "--class_rows", "2", "7", "5", "0"]))
    cfg101 = mask_rcnn_r101_fpn(4) if depth == 101 else mask_rcnn_r50_fpn(4)
    cfg101 = dataclasses.replace(cfg101, depth=depth)
    weights = W.load_torch_file(merged)
    pred = TrackPredictor(cfg101, weights, frame_np.shape[:2], device=dev)
    dets, _ = pred(frame_np[None])
    if pred.missing or not torch.isfinite(dets["masks"]).all():
        raise SmokeFailure(f"surgery: add_mask_head's output: missing {pred.missing[:3]}")
    del pred
    size = [] if train_size is None else ["--train_size", str(train_size[0]), str(train_size[1])]
    seg_out = os.path.join(root, "seg_merged.pkl")
    run("finetune_segmentation", lambda: finetune_segmentation.main(
        ["--coco_json", ann, "--coco_images", images, "--workdir", os.path.join(root, "seg"), "--weights", merged,
         "--depth", str(depth), "--max_iter", "2", "--test_period", "2", "--merge_into", det_pth, "--merge_out",
         seg_out] + size + dev_flag))
    aerial_w = os.path.join(root, "aerial.pth")
    save_pth(aerial_w, detectron2_checkpoint(13, 50, 3, mask_on=False))
    run("finetune_faster_rcnn_aerial", lambda: finetune_faster_rcnn_aerial.main(
        ["--uavdt_dir", uav, "--workdir", os.path.join(root, "aerial"), "--weights", aerial_w, "--max_iter", "2",
         "--test_period", "2", "--rpn_only"] + dev_flag))
    run("finetune_coco_dataset", lambda: finetune_coco_dataset.main(
        ["--coco_json", ann, "--coco_images", images, "--workdir", os.path.join(root, "coco_run"), "--num_classes",
         "4", "--max_iter", "2"] + dev_flag))
    missing = {"seg_merged": len(W.load_detectron2(TrackPredictor(cfg101, None, (64, 64), "cpu").model,
                                                   W.load_torch_file(seg_out))[0]),
               "finetune_segmentation": _reloads(os.path.join(root, "seg"), cfg101),
               "finetune_faster_rcnn_aerial": _reloads(os.path.join(root, "aerial"),
                                                       dataclasses.replace(mask_rcnn_r50_fpn(3), mask_on=False)),
               "finetune_coco_dataset": _reloads(os.path.join(root, "coco_run"), mask_rcnn_r50_fpn(4))}
    for sub in ("seg", "aerial", "coco_run"):
        remove_checkpoints(os.path.join(root, sub))
    for path in (det_pth, src_pkl, merged, seg_out, aerial_w):
        os.remove(path)
    res = {"depth": depth, "data_s": round(data_s, 3), "runs": runs, "reload_missing": missing,
           "merged_detections": int(dets["valid"].sum()), "card": card}
    log({"phase": "surgery", **res})
    if any(missing.values()):
        raise SmokeFailure(f"surgery: checkpoints that do not reload: {missing}")
    return res


def write_cowc_image(root: str, size: int = 2048, n_cars: int = 200, n_neg: int = 200, seed: int = 0) -> None:
    """One seeded COWC-style image: textured asphalt with bright car blobs,
    its ``_Annotated_Cars.png`` (saturated-red points) and
    ``_Annotated_Negatives.png`` (saturated-blue points)."""
    from PIL import Image

    from apse_uav_torch.utils.synthetic import ASPHALT

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    img = (ASPHALT + 12 * np.sin(xx / 13.0) * np.cos(yy / 11.0))[..., None] + rng.normal(0, 5, (size, size, 3))
    cars = np.zeros((size, size, 3), np.uint8)
    neg = np.zeros((size, size, 3), np.uint8)
    for r, c in rng.integers(20, size - 20, (n_cars, 2)):
        img[r - 8:r + 8, c - 4:c + 4] = rng.uniform(60, 230, 3)
        cars[r, c, 0] = 255
    for r, c in rng.integers(0, size, (n_neg, 2)):
        neg[r, c, 2] = 255
    os.makedirs(root, exist_ok=True)
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(os.path.join(root, "tile.png"))
    Image.fromarray(cars).save(os.path.join(root, "tile_Annotated_Cars.png"))
    Image.fromarray(neg).save(os.path.join(root, "tile_Annotated_Negatives.png"))


def cowc_phase(ckpt: dict, cfg, card: str, dev, size: int = 2048) -> dict:
    """``CowcRoiFeaturesLoader`` with R101-FPN's ``roi_features`` on one
    seeded 2048x2048 COWC image (four 1024 patches, 400 points; phase 18):
    features a second, and one chunk card against CPU."""
    import shutil

    import torch

    from PIL import Image

    from apse_uav_torch.data.cowc import (CowcRoiFeaturesLoader, _patch_instances, _points_from_annotation,
                                          build_roi_feature_fn)
    from apse_uav_torch.dcnn import weights as W
    from apse_uav_torch.dcnn.models.c4 import build_model

    root = os.path.join(OUT_DIR, "cowc")
    shutil.rmtree(root, ignore_errors=True)
    write_cowc_image(root, size)
    model = build_model(cfg).eval()
    W.load_detectron2(model, ckpt)
    fn = build_roi_feature_fn(model.to(dev))
    patch = min(1024, size // 2)
    CowcRoiFeaturesLoader(fn, root, patch_size=patch)  # warm-up (cuDNN's choices)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loader, counts = reset_and_read(lambda: CowcRoiFeaturesLoader(fn, root, patch_size=patch))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    batches = list(loader)
    n_points = sum(len(_points_from_annotation(os.path.join(root, f"tile_Annotated_{k}.png"), ch)[0])
                   for k, ch in (("Cars", 0), ("Negatives", 2)))
    # One chunk (patch 0's first 128 boxes), card against CPU.
    img = np.array(Image.open(os.path.join(root, "tile.png")))[:patch, :patch].astype(np.float32)
    cars = _points_from_annotation(os.path.join(root, "tile_Annotated_Cars.png"), 0)
    negs = _points_from_annotation(os.path.join(root, "tile_Annotated_Negatives.png"), 2)
    boxes = _patch_instances(cars, negs, (0, 0), patch, 18)[0][:128]
    card_f = fn(img[None], boxes[None]).cpu()
    cmodel = build_model(cfg).eval()
    W.load_detectron2(cmodel, ckpt)
    cpu_f = build_roi_feature_fn(cmodel)(img[None], boxes[None])
    err = rel_err(card_f, cpu_f)
    shutil.rmtree(root)
    res = {"image": [size, size], "patch": patch, "points": n_points, "batches": len(batches),
           "feature_dim": int(batches[0][0].shape[1]) if batches else None, "seconds": round(seconds, 3),
           "features_per_s": round(n_points / seconds, 3), "card_cpu_chunk_rel_err": err, "chunk_rows": len(boxes),
           "launches": counts, "card": card}
    log({"phase": "cowc", **res})
    if not batches or not all(np.isfinite(f).all() for f, _ in batches):
        raise SmokeFailure(f"cowc: {len(batches)} batches, or non-finite features")
    if err > 2e-2:
        raise SmokeFailure(f"cowc: card vs CPU chunk {err} (limit 2e-2)")
    return res


def selective_phase(frames_np, ckpt: dict, cfg, card: str, dev) -> dict:
    """``SelectivePredictor`` (proposals from p6 alone) at
    ``uav_tracker_config()`` on 4 frames with phase 7's weights (phase 19):
    its two timings, and frame 1 card against CPU."""
    import torch

    from apse_uav_torch.dcnn.engines import SelectivePredictor

    frames = frames_np[:TRACK_BATCH]
    h, w = frames.shape[1:3]
    sel = SelectivePredictor(cfg, ckpt, (h, w), device=dev)
    x = torch.from_numpy(frames).to(dev)
    sel(x)
    dets, counts = reset_and_read(lambda: sel(x))
    timings = {k: round(v * 1e3, 3) for k, v in sel.timings.items()}
    # Card against CPU at the zoo's threshold (0.05): p6's few large
    # proposals leave no detection above the tracker's 0.5.
    low = dataclasses.replace(cfg, roi=dataclasses.replace(cfg.roi, score_thresh_test=0.05))
    gd = {k: v.cpu() for k, v in SelectivePredictor(low, ckpt, (h, w), device=dev)(x[:1]).items()}
    cdets = SelectivePredictor(low, ckpt, (h, w), device="cpu")(frames[:1])
    unmatched = unmatched_detections(gd, cdets, 0, 0.5, 1e-4, 0.05)
    res = {"frames": TRACK_BATCH, "size": [w, h], "rpn_levels": list(sel.rpn_levels), "timings_ms": timings,
           "valid_detections": dets["valid"].sum(dim=1).tolist(),
           "compared_at_0.05": int(cdets["valid"].sum()),
           "card_cpu_same_order": bool(torch.equal(gd["valid"], cdets["valid"])
                                       and torch.equal(gd["classes"], cdets["classes"])),
           "card_cpu_unmatched": unmatched, "launches": counts, "card": card}
    log({"phase": "selective", **res})
    if unmatched:
        raise SmokeFailure(f"selective: card vs CPU frame 1: {unmatched} detections unmatched (boxes within 0.5 px, "
                           "scores within 1e-4)")
    return res


def sharding_check(devices, cfg, ckpt: dict, frames_np, iters: int = 3) -> dict:
    """Frame sharding: one ``TrackPredictor`` replica of ``cfg`` a device of
    ``devices`` through ``sharded_inference_fn`` on ``frames_np`` (B, H, W,
    3) u8, B a multiple of the device count, against the first device
    running each device's chunk (the same batch size, so the same
    convolution algorithms): the same detections, boxes within 1e-3 px.
    Frames a second of the sharded run and of the first device alone on all
    the frames (host clock, ending when every device is done)."""
    import torch

    from apse_uav_torch.dcnn.engines import TrackPredictor
    from apse_uav_torch.device import synchronize
    from apse_uav_torch.parallel.mesh import shard_batch, sharded_inference_fn

    hw = frames_np.shape[1:3]
    replicas = [TrackPredictor(cfg, ckpt, hw, device=d) for d in devices]
    run = sharded_inference_fn(lambda pred, x: pred(x)[0], replicas, devices)
    ref = replicas[0]
    got, counts = reset_and_read(lambda: run(frames_np))
    chunks = [{k: v.to(devices[0]) for k, v in ref(c.to(devices[0]))[0].items()}
              for c in shard_batch(devices, frames_np)]
    want = {k: torch.cat([c[k] for c in chunks]) for k in got}
    same = all(torch.equal(got[k], want[k]) for k in ("valid", "classes"))
    box_err = float((got["boxes"] - want["boxes"]).abs().max()) if same else None

    def wall(fn) -> float:
        fn()
        for d in devices:
            synchronize(d)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        for d in devices:
            synchronize(d)
        return (time.perf_counter() - t0) / iters

    sharded_s = wall(lambda: run(frames_np))
    one_s = wall(lambda: ref(frames_np))
    n = frames_np.shape[0]
    return {"check": "frame_sharding", "devices": [str(d) for d in devices], "frames": n, "size": [hw[1], hw[0]],
            "valid_detections": int(got["valid"].sum()), "same_detections": same, "box_err_px": box_err,
            "sharded_frames_per_s": n / sharded_s, "one_device_frames_per_s": n / one_s,
            "speedup": one_s / sharded_s, "launches": counts,
            "ok": bool(same and box_err <= 1e-3 and int(got["valid"].sum()) > 0)}


def finetune_dp_job(ckpt: dict, world: int, hw=None, depth: int = 101):
    """The data-parallel step at ``finetune_uav``'s defaults (R101-FPN, its
    ``to_train`` and rate, ``detection_scenes`` at its 768x1344 train size)
    from ``ckpt``: ``finetune_uav``'s batch of 4, or 2 images a rank where
    ``world`` ranks need more.  ``hw`` and ``depth`` shrink a CPU rehearsal."""
    from apse_uav_torch.cli import finetune_uav
    from apse_uav_torch.dcnn import flax_init
    from apse_uav_torch.parallel import dp
    from apse_uav_torch.utils.synthetic import detection_scenes

    size = [] if hw is None else ["--train_size", str(hw[0]), str(hw[1])]
    args = finetune_uav.build_parser().parse_args(["--workdir", "unused", "--depth", str(depth)] + size)
    n = world * max(2, args.batch_size // world)
    images, gt = next(detection_scenes(n, tuple(args.train_size), seed=6))
    return dp.DPJob(finetune_uav.model_config(args), {k: np.asarray(v) for k, v in ckpt.items()}, images, gt,
                    flax_init.prng_key(123), tuple(args.to_train), args.lr)


def dp_check(job, world: int, device) -> dict:
    """``job`` data-parallel over ``world`` spawned ranks (NCCL on cards,
    rank r on card r; gloo on the CPU) against ``dp.plain_step`` on
    ``device`` with the whole batch.  One rank must give the plain step's
    numbers (within 1e-6: the all-reduce of one rank is exact); several, the
    losses and updated tensors within rtol 5e-4, atol 1e-5 (the bound the
    reference's mesh step is held to)."""
    from apse_uav_torch.dcnn.engines import full_fp32
    from apse_uav_torch.parallel import dp

    backend = "nccl" if device.type == "cuda" else "gloo"
    t0 = time.perf_counter()
    losses, state = dp.run_group(world, job, backend)
    dp_s = time.perf_counter() - t0
    with full_fp32():
        want, want_state = dp.plain_step(job, device)
    loss_err = max(abs(losses[k] - v) / max(abs(v), 1e-12) for k, v in want.items())
    param_err = max(float(np.abs(state[k] - v).max()) for k, v in want_state.items())
    if world == 1:
        ok = loss_err <= 1e-6 and param_err <= 1e-6
    else:
        ok = (all(np.isclose(losses[k], v, rtol=5e-4, atol=1e-5) for k, v in want.items())
              and all(np.allclose(state[k], v, rtol=5e-4, atol=1e-5) for k, v in want_state.items()))
    moved = sum(not np.array_equal(want_state[k], job.init[k]) for k in want_state if k in job.init)
    return {"check": "data_parallel_step", "backend": backend, "ranks": world, "images": int(job.images.shape[0]),
            "size": list(job.images.shape[1:3]), "depth": job.cfg.depth, "tensors_moved": moved,
            "dp_s": dp_s, "loss_rel_err": loss_err, "param_max_abs_err": param_err, "losses": losses,
            "ok": bool(ok and all(np.isfinite(v) for v in losses.values()) and moved > 0)}


def parallel_phase(frames_np, frames, pipe, ckpt: dict, cfg, card: str, dev, dp_hw=None, dp_depth: int = 101) -> dict:
    """``sharded_inference_fn`` (R101-FPN) and ``shard_map_batch`` (the
    two-pass ArUco front) over ``data_mesh()`` (every visible card) against
    the unsharded runs, and the data-parallel step at ``finetune_uav``'s
    defaults on one NCCL rank against the plain step (phase 20).
    ``dp_hw``, ``dp_depth`` shrink a CPU rehearsal."""
    import torch

    from apse_uav_torch.aruco import cuda_labeling, cuda_proposals
    from apse_uav_torch.parallel import mesh as pmesh
    from apse_uav_torch.preproc import cuda_pool, cuda_remap

    devices = pmesh.data_mesh()
    sharding = sharding_check(devices, cfg, ckpt, frames_np[:TRACK_BATCH], iters=1)
    front = pmesh.shard_map_batch(devices, lambda fr: pipe.front(fr)["msp"])
    sharded_front, front_counts = reset_and_read(lambda: front(frames))
    plain_front, plain_counts = reset_and_read(lambda: pipe.front(frames)["msp"])
    front_equal = bool(torch.equal(sharded_front.to(dev), plain_front))
    front_kernels = (cuda_pool.NAME, cuda_remap.K3, cuda_proposals.NAME, cuda_remap.K4, cuda_labeling.NAME)
    front_missing = [n for n in front_kernels if front_counts.get(n, 0) < len(devices)]
    step = dp_check(finetune_dp_job(ckpt, 1, dp_hw, dp_depth), 1, dev)
    res = {"mesh": [str(d) for d in devices], "cards": len(devices), "sharding": sharding,
           "aruco_front_equal": front_equal, "aruco_front_launches": front_counts,
           "aruco_front_unsharded_launches": plain_counts, "dp": step, "card": card}
    log({"phase": "parallel", **res})
    if not (sharding["ok"] and front_equal and step["ok"]) or front_missing:
        raise SmokeFailure(f"parallel: sharding {sharding}, front equal {front_equal}, front kernels not launched "
                           f"once a card {front_missing}, DP step {step}")
    return res


def all_cards_main(n_frames: int = 8) -> int:
    """``--all-cards``: frame sharding of R101-FPN over every visible card
    against card 0, and the data-parallel step at ``finetune_uav``'s defaults
    over one NCCL process a card against the plain step on card 0 (see the
    module docstring)."""
    import torch

    from apse_uav_torch.dcnn.config import uav_tracker_config
    from apse_uav_torch.parallel.mesh import data_mesh
    from apse_uav_torch.utils.synthetic import detectron2_checkpoint

    card = nvidia_smi()
    devices = data_mesh()
    cfg = uav_tracker_config()
    cfg = dataclasses.replace(cfg, roi=dataclasses.replace(cfg.roi, score_thresh_test=0.05))
    ckpt = detectron2_checkpoint(0, 101, 4)
    frames_np = np.random.default_rng(0).integers(0, 255, (n_frames, 2160, 3840, 3), np.uint8)
    results = [sharding_check(devices, cfg, ckpt, frames_np),
               dp_check(finetune_dp_job(ckpt, len(devices)), len(devices), devices[0])]
    for r in results:
        log({"phase": "all_cards", **r, "card": card})
    if not all(r["ok"] for r in results):
        raise SmokeFailure(f"all_cards: {[r['check'] for r in results if not r['ok']]} failed")
    print(card)
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


def scene_specs(i: int):
    from apse_uav_torch.utils.synthetic import MarkerSpec

    return [
        MarkerSpec(4, (0.5, -2.0), yaw_deg=14.0 + 7 * i, leds=LEDS),
        MarkerSpec(1, (7.5, 3.0), yaw_deg=40.0 + 5 * i),
        MarkerSpec(2, (-9.0, 2.0), yaw_deg=70.0 - 9 * i),
        MarkerSpec(3, (4.0, -6.5), yaw_deg=5.0 + 11 * i),
    ]


# Phase 21, the operating point: seven yaws at 40 m and the yaw-30 scene at
# 25, 50 and 65 m (tests/test_aruco_operating_point.py), host LEDs 0b10110010.
OP_LEDS = 0b10110010
OP_SCENES = tuple((40.0, float(yaw)) for yaw in range(0, 91, 15)) + ((25.0, 30.0), (50.0, 30.0), (65.0, 30.0))
# Corner error against the rendered truth: per-scene mean and worst corner
# (px), and the mean signed error of each axis over all scenes (px).
OP_MEAN_PX, OP_WORST_PX, OP_BIAS_PX = 0.5, 1.5, 0.1
# dist_aruco against the world distance of the marker centres: the JAX
# package's worst error on the same ten scenes plus 0.02 m (see phase 21).
OP_JAX_DIST_ERR = 0.6161317932311636
OP_DIST_M = OP_JAX_DIST_ERR + 0.02
OP_PAPER_M = 0.5
# Altitudes whose frames must decode the LEDs: all four, as the JAX package
# decodes 0b10110010 on every one of the ten scenes.
OP_LED_ALTS = (25.0, 40.0, 50.0, 65.0)


def op_specs(yaw: float):
    """The operating point's four vehicles at camera-relative yaw ``yaw``."""
    from apse_uav_torch.utils.synthetic import MarkerSpec

    return [
        MarkerSpec(4, (0.5, -2.0), yaw_deg=yaw + 4.0, leds=OP_LEDS),
        MarkerSpec(1, (7.5, 3.0), yaw_deg=yaw - 12.0),
        MarkerSpec(2, (-9.0, 2.0), yaw_deg=yaw + 30.0),
        MarkerSpec(3, (4.0, -6.5), yaw_deg=yaw + 75.0),
    ]


def score_scene(out: dict, specs, mtx, altitude: float) -> dict:
    """One scene's pipeline outputs (numpy, frame 0 of a first frame) against
    the renderer's geometry: the corners of ids 1-4 against their projected
    world corners, the marker side (px) against the true quad's, the pose's
    range at the true marker length and the ``altitude`` column against the
    altitude, and dist_aruco of vehicles 1-3 against the world distance of
    their marker centres from the host's."""
    from apse_uav_torch.utils.synthetic import MARKER_LEN, marker_world_corners, project_world_to_undistorted

    by_id = {s.marker_id: s for s in specs}
    truth = np.stack([project_world_to_undistorted(marker_world_corners(by_id[m]), mtx, altitude)
                      for m in range(1, 5)])  # (4 ids, 4 corners, 2)
    err = out["corners"][0].astype(np.float64) - truth
    dist_px = np.linalg.norm(err, axis=-1)
    side = np.linalg.norm(truth - np.roll(truth, -1, axis=1), axis=-1).mean(-1)
    host = np.asarray(by_id[4].center_xy)
    dist_true = np.array([np.linalg.norm(np.asarray(by_id[v].center_xy) - host) for v in (1, 2, 3)])
    tz = out["tvec"][0, 3, 2] * MARKER_LEN / out["marker_length"][0]
    return {
        "present": out["measured"][0].tolist(),
        "corner_mean_px": float(dist_px.mean()), "corner_worst_px": float(dist_px.max()),
        "corner_signed_sum_px": err.reshape(-1, 2).sum(0).tolist(), "n_corners": int(dist_px.size),
        "marker_side_err_px": (out["msp_avg"][0] - side).tolist(),
        "pose_range_err_m": float(tz - altitude), "altitude_column_err_m": float(out["altitude"][0] - altitude),
        "dist_aruco_err_m": (out["dist_aruco"][0] - dist_true).tolist(), "leds": int(out["leds"][0]),
    }


def op_summary(scores: list[dict]) -> dict:
    """Over the scenes: the worst per-scene mean and the worst corner (px),
    the mean signed error of each axis (px) and the worst |dist_aruco| error (m)."""
    n = sum(s["n_corners"] for s in scores)
    return {"corner_mean_px_worst_scene": max(s["corner_mean_px"] for s in scores),
            "corner_worst_px": max(s["corner_worst_px"] for s in scores),
            "corner_bias_px": (np.sum([s["corner_signed_sum_px"] for s in scores], axis=0) / n).tolist(),
            "dist_aruco_worst_m": max(max(abs(e) for e in s["dist_aruco_err_m"]) for s in scores)}


def operating_point_phase(mtx, dist, card: str, dev, size=(W, H)) -> dict:
    """Phase 21: the ten scenes of ``OP_SCENES`` rendered by the port's
    ``SceneRenderer`` on the card, each a first frame with a fresh carry
    through the two-pass and the single-pass ``ArucoPipeline`` (counts set to
    0 before each run, the pipeline built in it, so its colour table counts),
    held against ground truth (``score_scene``)."""
    from apse_uav_torch.aruco import cuda_labeling, cuda_proposals
    from apse_uav_torch.aruco.pipeline import ArucoPipeline, ArucoPipelineConfig, init_carry
    from apse_uav_torch.device import synchronize
    from apse_uav_torch.preproc import cuda_pool, cuda_remap
    from apse_uav_torch.utils import profiling
    from apse_uav_torch.utils.synthetic import SceneRenderer

    t_phase = time.perf_counter()
    frames, renderer = [], None
    t0 = time.perf_counter()
    for alt, yaw in OP_SCENES:
        if renderer is None or renderer.altitude != alt:
            renderer = SceneRenderer(mtx, dist, size, altitude=alt, supersample=2, cache=False, device=dev)
        frames.append(renderer.render(op_specs(yaw)).permute(2, 0, 1)[None].contiguous())
    synchronize(dev)
    render_s = time.perf_counter() - t0
    del renderer
    paths = (("two_pass", ArucoPipelineConfig(), (cuda_remap.TABLE, cuda_pool.NAME, cuda_remap.K3,
                                                  cuda_proposals.NAME, cuda_remap.K4, cuda_labeling.NAME)),
             ("single_pass", ArucoPipelineConfig(two_pass=False), (cuda_remap.TABLE, cuda_remap.K3,
                                                                   cuda_proposals.NAME, cuda_labeling.NAME)))
    result = {"phase": "operating_point", "size": list(size), "render_s": render_s}
    details = {}
    for name, cfg, names in paths:
        scores = []
        for (alt, yaw), frame in zip(OP_SCENES, frames):
            profiling.reset_counters()
            pipe = ArucoPipeline(mtx, dist, size, cfg, device=dev)
            carry = init_carry(cfg, dev)
            synchronize(dev)
            t0 = time.perf_counter()
            _, out = pipe.process(frame, carry, first=True)
            synchronize(dev)
            call_ms = (time.perf_counter() - t0) * 1e3
            counts = profiling.counted("launch")
            missing = [n for n in names if counts.get(n, 0) == 0]
            if missing:
                raise SmokeFailure(f"operating point {name} at {alt} m, yaw {yaw}: kernels not launched: {missing}")
            s = score_scene({k: v.cpu().numpy() for k, v in out.items()}, op_specs(yaw), mtx, alt)
            s.update({"scene": [alt, yaw], "call_ms": call_ms, "launches": counts})
            scores.append(s)
        details[name] = scores
        summary = op_summary(scores)
        # One row a scene: altitude, yaw, corner mean and worst (px), worst
        # |dist_aruco| error (m), LEDs, ms of the process call.
        result[name] = {**summary, "scenes": [
            [*s["scene"], s["corner_mean_px"], s["corner_worst_px"], max(abs(e) for e in s["dist_aruco_err_m"]),
             s["leds"], s["call_ms"]] for s in scores],
            "marker_side_err_px_range": [min(min(s["marker_side_err_px"]) for s in scores),
                                         max(max(s["marker_side_err_px"]) for s in scores)],
            "pose_range_err_m": [s["pose_range_err_m"] for s in scores],
            "altitude_column_err_m": [s["altitude_column_err_m"] for s in scores]}
        fails = []
        for s in scores:
            alt, yaw = s["scene"]
            if not all(s["present"]):
                fails.append(f"{alt} m yaw {yaw}: ids present {s['present']}")
            if s["corner_mean_px"] > OP_MEAN_PX or s["corner_worst_px"] > OP_WORST_PX:
                fails.append(f"{alt} m yaw {yaw}: corners mean {s['corner_mean_px']:.4f} px, worst "
                             f"{s['corner_worst_px']:.4f} px (limits {OP_MEAN_PX}, {OP_WORST_PX})")
            if max(abs(e) for e in s["dist_aruco_err_m"]) > OP_DIST_M:
                fails.append(f"{alt} m yaw {yaw}: dist_aruco errors {s['dist_aruco_err_m']} m (limit {OP_DIST_M})")
            if alt in OP_LED_ALTS and s["leds"] != OP_LEDS:
                fails.append(f"{alt} m yaw {yaw}: LEDs decode to {s['leds']:#010b}, rendered {OP_LEDS:#010b}")
        if max(abs(b) for b in summary["corner_bias_px"]) > OP_BIAS_PX:
            fails.append(f"corner bias {summary['corner_bias_px']} px (limit {OP_BIAS_PX})")
        if fails:
            log(result)
            raise SmokeFailure(f"operating point, {name}: " + "; ".join(fails))
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "operating_point.json"), "w") as f:
        json.dump(details, f)
    result.update({"seconds": time.perf_counter() - t_phase, "dist_bound_m": OP_DIST_M,
                   "jax_dist_err_m": OP_JAX_DIST_ERR, "paper_m": OP_PAPER_M, "card": card})
    log(result)
    return result


def nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    return smi[0].strip() if smi else "unknown"


def main(argv=None) -> int:
    import argparse

    import torch

    p = argparse.ArgumentParser(description="The port's smoke run on the card(s); see the module docstring.")
    p.add_argument("--all-cards", action="store_true",
                   help="only frame sharding and the data-parallel step, over every visible card")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "apse_uav_torch")):
        print("chip_smoke: the apse_uav_torch package is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.all_cards:
        return all_cards_main()
    card = nvidia_smi()
    dev = torch.device("cuda", 0)

    from apse_uav_torch import _build
    from apse_uav_torch.aruco import cuda_labeling, cuda_proposals, detector as det, patch_select
    from apse_uav_torch.aruco.pipeline import ArucoPipeline, ArucoPipelineConfig, init_carry
    from apse_uav_torch.core import camera
    from apse_uav_torch.preproc import cuda_pool, cuda_remap, remap, twopass
    from apse_uav_torch.utils import csv_io, profiling
    from apse_uav_torch.utils.synthetic import labeling_masks, render_scene

    # -- 1. build -------------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build()
    ptxas = {name: [ln.strip() for ln in text.splitlines()
                    if "registers" in ln or "bytes smem" in ln or "spill" in ln] for name, text in logs.items()}
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
    t0 = time.perf_counter()
    pipe, out_np, counts = run_path(lambda: ArucoPipeline(mtx, dist, (W, H), cfg, device=dev), frames, cfg, dev,
                                    (cuda_remap.TABLE, cuda_labeling.NAME, cuda_proposals.NAME, cuda_remap.K3,
                                     cuda_remap.K4, cuda_pool.NAME))
    first_s = time.perf_counter() - t0
    layers = path_times(pipe, frames, cfg, dev)
    profile = profile_call(lambda: pipe.process(frames, init_carry(cfg, dev), first=True), layers["process_ms"])
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
    spipe, sout, scounts = run_path(lambda: ArucoPipeline(mtx, dist, (W, H), scfg, device=dev), frames, scfg, dev,
                                    (cuda_remap.TABLE, cuda_labeling.NAME, cuda_proposals.NAME, cuda_remap.K3))
    slayers = path_times(spipe, frames, scfg, dev)
    sprofile = profile_call(lambda: spipe.process(frames, init_carry(scfg, dev), first=True), slayers["process_ms"])
    log({"phase": "single_pass", "frames": BATCH, "size": [W, H],
         "frames_per_s": round(BATCH * 1e3 / slayers["process_ms"], 3), **slayers, "launches": scounts,
         "detected": sout["detected"].tolist(), "leds": sout["leds"].tolist(),
         "dist_aruco": sout["dist_aruco"].round(4).tolist(), "card": card})
    log({"phase": "single_pass_profile", **sprofile})
    scpipe = ArucoPipeline(mtx, dist, (W, H), scfg, device="cpu")
    log({"phase": "single_pass_gpu_cpu", **gpu_vs_cpu(spipe, scpipe, scfg, frames[:2], dev)})

    # -- 4. Preprocessor (K3's RGB mode) on the HWC frames ------------------------
    profiling.reset_counters()
    pre = remap.Preprocessor(mtx, dist, (W, H), device=dev)
    rgb, gray_rgb = pre(frames_hwc)
    torch.cuda.synchronize()
    pcounts = profiling.counted("launch")
    if pcounts.get(cuda_remap.K3_RGB, 0) == 0 or pcounts.get(cuda_remap.TABLE, 0) == 0:
        raise SmokeFailure(f"{cuda_remap.K3_RGB} or its table not launched by Preprocessor (counts {pcounts})")
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
    table = pipe.table
    kernels = []

    def same(got, want, what: str) -> None:
        if not torch.equal(got, want):
            d = (got.to(torch.int64) - want.to(torch.int64)).abs()
            raise SmokeFailure(f"{what}: {int((d > 0).sum())} values differ, by up to {int(d.max())}")

    # The colour tables against the LAB chain of every colour; their build time
    # (set-up: once per pipeline or Preprocessor, gamma and device).
    same(table, remap.lab_gamma_table(2.0, device=dev, chunk=1 << 22), "colour table vs plain")
    same(pre.table, remap.lab_gamma_table(2.0, rgb=True, device=dev, chunk=1 << 22), "packed colour table vs plain")
    log({"phase": "setup", "colour_table_ms": round(cuda_ms(lambda: cuda_remap.colour_table(2.0, dev), 3, 1), 4),
         "colour_table_rgb_ms": round(cuda_ms(lambda: cuda_remap.colour_table(2.0, dev, rgb=True), 3, 1), 4),
         "card": card})

    # K5 over the whole padded output, and K3 on the pooled plan.
    pooled_src = cuda_pool.pool_source(frames, st, pipe._pooled_hw)
    same(pooled_src, twopass.pool_source_u8(frames, st, pipe._pooled_hw), "K5 vs plain (pad included)")
    k3 = cuda_remap.remap_gray(pooled_src, pipe.map_pooled, *pipe._pooled_tiles, table=table)
    # Bit-identical: the table holds the chain's bits (-fmad=false, rintf, IEEE
    # division), the blend rounds as the plain version does.
    same(k3, remap.remap_gray_u8(pooled_src, pipe.map_pooled), "K3 vs plain, pooled plan")
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
    # K1 on the (60 B, 64, 64) windows of the real frames plus random masks (the
    # timed windows), and on masks the fixed schedule does not converge on.
    centers, sizes, scores, valid = props
    full_gray = cuda_remap.remap_gray(frames, pipe.map_full, pipe._sel_th, pipe._sel_tw, table=table)
    _, darks = det.binarized_windows(full_gray.to(torch.float32), centers, sizes, p)
    gen = torch.Generator(device=dev).manual_seed(0)
    noise = torch.rand((darks.shape[0] // 4, p.window, p.window), generator=gen, device=dev) < 0.5
    darks = torch.cat([darks, noise]).contiguous()
    hard = torch.from_numpy(np.stack(list(labeling_masks(p.window).values()))).to(dev)
    checked = torch.cat([darks, hard]).contiguous()
    k1_err = int((cuda_labeling.labels(checked) != det._label_sweeps(checked)).sum())
    if k1_err:
        raise SmokeFailure(f"K1 vs plain: {k1_err} labels differ")
    # K4 on the full-res plan with -1 padding and duplicated tile ids.
    sel, _ = patch_select.select_tiles_batched(
        centers, valid, h=H, w=W, th=pipe._sel_th, tw=pipe._sel_tw, groups=pipe._groups,
        t_sel=cfg.sel_tile_budget, per_scale_k=p.per_scale_k)
    sel = torch.cat([sel, sel[:, :8], torch.full((BATCH, 8), -1, dtype=torch.int32, device=dev)], dim=1).contiguous()
    k4 = cuda_remap.remap_gray_selected(frames, pipe.map_full, sel, pipe._sel_th, pipe._sel_tw, table=table)
    full_plain = remap.remap_gray_u8(frames, pipe.map_full)
    same(full_gray, full_plain, "K3 vs plain, full frame")
    nty, ntx = H // pipe._sel_th, W // pipe._sel_tw
    picked = torch.zeros((BATCH, nty * ntx), dtype=torch.bool, device=dev)
    fr, slot = (sel >= 0).nonzero(as_tuple=True)
    picked[fr, sel[fr, slot].long()] = True
    n_sel_tiles = int(picked.sum())
    n_tiles_any = int(picked.any(dim=0).sum())
    on_sel = picked.reshape(BATCH, nty, 1, ntx, 1).expand(-1, -1, pipe._sel_th, -1, pipe._sel_tw).reshape(BATCH, H, W)
    same(k4[on_sel], full_plain[on_sel], "K4 vs plain on the selected tiles")
    same(k4[on_sel], full_gray[on_sel], "K4 vs K3 full frame on the selected tiles")
    same(gray_rgb, full_gray, "K3's RGB mode: gray vs K3's gray-only launch on the full frame")
    del full_plain

    # The same kernels on uniform random frames: nearly every pixel a colour of
    # its own, the tables' worst case.
    gen = torch.Generator(device=dev).manual_seed(2024)
    rand = torch.randint(0, 256, (BATCH, 3, H, W), generator=gen, device=dev, dtype=torch.uint8)
    rand_hwc = rand.permute(0, 2, 3, 1).contiguous()
    rand_pooled = cuda_pool.pool_source(rand, st, pipe._pooled_hw)
    same(rand_pooled, twopass.pool_source_u8(rand, st, pipe._pooled_hw), "K5 vs plain, random frames")
    same(cuda_remap.remap_gray(rand_pooled, pipe.map_pooled, *pipe._pooled_tiles, table=table),
         remap.remap_gray_u8(rand_pooled, pipe.map_pooled), "K3 vs plain, pooled plan, random frames")
    rand_full = remap.remap_gray_u8(rand, pipe.map_full)
    same(cuda_remap.remap_gray(rand, pipe.map_full, pipe._sel_th, pipe._sel_tw, table=table), rand_full,
         "K3 vs plain, full frame, random frames")
    same(cuda_remap.remap_gray_selected(rand, pipe.map_full, sel, pipe._sel_th, pipe._sel_tw, table=table)[on_sel],
         rand_full[on_sel], "K4 vs plain, random frames")
    del rand_full
    rgb_plain, gray_plain = remap.remap_rgb_gray_u8(rand_hwc, pre.map_xy, hwc=True)
    rgb_r, gray_r = pre(rand_hwc)
    same(rgb_r, rgb_plain, "K3 RGB mode vs plain, random frames")
    same(gray_r, gray_plain, "K3 RGB mode gray vs plain, random frames")
    del rgb_plain, gray_plain, rgb_r, gray_r
    log({"phase": "random_frames", "frames": BATCH, "size": [W, H], "bit_identical": ["pool", "remap_full pooled",
         "remap_full full frame", "remap_selected", "remap_full_rgb"], "card": card})

    # One call of each redesigned wrapper with synchronisation as an error.
    for name, fn in (("labeling", lambda: cuda_labeling.labels(darks)),
                     ("proposals", lambda: cuda_proposals.proposals_from_pool(pool, H, W, p)),
                     ("remap_full", lambda: cuda_remap.remap_gray(pooled_src, pipe.map_pooled, *pipe._pooled_tiles,
                                                                  table=table)),
                     ("remap_selected", lambda: cuda_remap.remap_gray_selected(frames, pipe.map_full, sel, pipe._sel_th,
                                                                               pipe._sel_tw, table=table)),
                     ("remap_full_rgb", lambda: pre(frames_hwc))):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
        except RuntimeError as e:
            raise SmokeFailure(f"{name} synchronises the device: {e}") from e
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()

    # Timings at the paths' shapes.
    import torch.nn.functional as F

    def grid_sample_call(src, map_xy):
        h_in, w_in = src.shape[-2:]
        grid = torch.stack([map_xy[..., 0] * (2.0 / (w_in - 1)) - 1.0, map_xy[..., 1] * (2.0 / (h_in - 1)) - 1.0], -1)
        grid = grid[None].expand(src.shape[0], -1, -1, -1)
        srcf = src.to(torch.float32)
        return lambda: F.grid_sample(srcf, grid, mode="bilinear", padding_mode="zeros", align_corners=True)

    def remap_bound(src_bytes: int, map_px: int, px_frames: int, out_bytes: int):
        """Source read once, map once per batch, outputs written once; ~36 FP32
        ops of blend per pixel and frame and ~20 to decode a map entry."""
        return bound(src_bytes + map_px * 8 + px_frames * out_bytes, px_frames * 36 + map_px * 20)

    px_pooled = pipe.map_pooled.shape[0] * pipe.map_pooled.shape[1]
    tile_px = pipe._sel_th * pipe._sel_tw
    h4, w4 = H // st, W // st
    plans = det.scale_plans(H, W, p)
    k2_ops = BATCH * h4 * w4 * (2 + sum(20 + 2 * (2 * e.r_d + 1) + 4 for e in plans))
    n_rgb = BATCH * H * W
    frames_f32 = frames.to(torch.float32)
    rows = [
        ("labeling", "apse_uav_torch/csrc/labeling.cu", cuda_labeling.NAME, k1_err,
         lambda: cuda_labeling.labels(darks), lambda: det._label_sweeps(darks), None,
         bound(darks.numel() * 5, darks.shape[0] * 500e3)),
        # Bytes: the pool and the proposal slots (17 bytes each); operations per
        # cell and scale: ~20 for the score, 2 (2 r + 1) for the dilation, 4 NMS.
        ("proposals", "apse_uav_torch/csrc/proposals.cu", cuda_proposals.NAME, k2_err,
         lambda: cuda_proposals.proposals_from_pool(pool, H, W, p), lambda: det._proposals_from_pool(pool, H, W, p),
         None, bound(pool.numel() * 4 + BATCH * len(plans) * p.per_scale_k * 17, k2_ops)),
        ("remap_full", "apse_uav_torch/csrc/remap.cu", cuda_remap.K3, 0,
         lambda: cuda_remap.remap_gray(pooled_src, pipe.map_pooled, *pipe._pooled_tiles, table=table),
         lambda: remap.remap_gray_u8(pooled_src, pipe.map_pooled), grid_sample_call(pooled_src, pipe.map_pooled),
         remap_bound(pooled_src.numel(), px_pooled, BATCH * px_pooled, 1)),
        # Source and output of the selected tiles, the map of every tile some frame selected.
        ("remap_selected", "apse_uav_torch/csrc/remap.cu", cuda_remap.K4, 0,
         lambda: cuda_remap.remap_gray_selected(frames, pipe.map_full, sel, pipe._sel_th, pipe._sel_tw, table=table),
         lambda: remap.remap_gray_u8(frames, pipe.map_full), grid_sample_call(frames, pipe.map_full),
         bound(n_sel_tiles * tile_px * 4 + n_tiles_any * tile_px * 8, n_sel_tiles * tile_px * 36
               + n_tiles_any * tile_px * 20)),
        # Library yardstick: F.avg_pool2d on the f32 frame (no u8 rounding, no pad).
        ("pool", "apse_uav_torch/csrc/pool.cu", cuda_pool.NAME, 0,
         lambda: cuda_pool.pool_source(frames, st, pipe._pooled_hw),
         lambda: twopass.pool_source_u8(frames, st, pipe._pooled_hw), lambda: F.avg_pool2d(frames_f32, st),
         bound(frames.numel() + pooled_src.numel(), pooled_src.numel() * 16)),
        # Source, map, RGB and gray.
        ("remap_full_rgb", "apse_uav_torch/csrc/remap.cu", cuda_remap.K3_RGB, rgb_err,
         lambda: pre(frames_hwc), lambda: remap.remap_rgb_gray_u8(frames_hwc, pre.map_xy, hwc=True),
         grid_sample_call(frames, pre.map_xy), remap_bound(frames_hwc.numel(), H * W, n_rgb, 4)),
        # The gray table: 2^24 bytes written, ~300 operations of LAB chain a colour.
        ("colour_table", "apse_uav_torch/csrc/remap.cu", cuda_remap.TABLE, 0,
         lambda: cuda_remap.colour_table(2.0, dev), lambda: remap.lab_gamma_table(2.0, device=dev, chunk=1 << 22),
         None, bound(remap.N_COLOURS, remap.N_COLOURS * 300)),
    ]
    for name, source, key, err, kern, plain, lib, (b_ms, b_by) in rows:
        ms = cuda_ms(kern)
        plain_ms = cuda_ms(plain, iters=3, warmup=1)
        lib_ms = cuda_ms(lib) if lib is not None else None
        # Launches in the run of the kernel's own path: Preprocessor for K3's RGB
        # mode, the two-pass main path for the others (the single_pass phase
        # prints that path's counts).
        launches = pcounts.get(key, 0) if key == cuda_remap.K3_RGB else counts.get(key, 0)
        kms = kernel_ms(kern, KERNEL_NAMES[name])
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": REPLACES[name],
                        "launches": launches, "max_abs_err": float(err), "ms": round(ms, 4),
                        "kernel_ms": None if kms is None else round(kms, 4),
                        "plain_ms": round(plain_ms, 4), "bound_ms": round(b_ms, 5), "bound_by": b_by,
                        "library_ms": None if lib_ms is None else round(lib_ms, 4)})
    # K3 at the single-pass front's shape (the full frame), the random batch, and
    # the pixel rates against F.grid_sample's on the same shapes.
    by_name = {r["name"]: r for r in kernels}
    k3_full = lambda: cuda_remap.remap_gray(frames, pipe.map_full, pipe._sel_th, pipe._sel_tw, table=table)  # noqa: E731
    k3_full_ms = cuda_ms(k3_full)
    k3_full_b, _ = remap_bound(frames.numel(), H * W, n_rgb, 1)
    random_ms = {
        "remap_full_pooled": cuda_ms(lambda: cuda_remap.remap_gray(rand_pooled, pipe.map_pooled, *pipe._pooled_tiles,
                                                                   table=table)),
        "remap_full_fullres": cuda_ms(lambda: cuda_remap.remap_gray(rand, pipe.map_full, pipe._sel_th, pipe._sel_tw,
                                                                    table=table)),
        "remap_selected": cuda_ms(lambda: cuda_remap.remap_gray_selected(rand, pipe.map_full, sel, pipe._sel_th,
                                                                         pipe._sel_tw, table=table)),
        "remap_full_rgb": cuda_ms(lambda: pre(rand_hwc)),
    }
    gpx = {  # output pixels (frames x pixels) per second, in units of 1e9
        "remap_full_pooled": BATCH * px_pooled / by_name["remap_full"]["ms"] / 1e6,
        "remap_full_fullres": n_rgb / k3_full_ms / 1e6,
        "remap_selected": n_sel_tiles * tile_px / by_name["remap_selected"]["ms"] / 1e6,
        "remap_full_rgb": n_rgb / by_name["remap_full_rgb"]["ms"] / 1e6,
        "grid_sample_pooled": BATCH * px_pooled / by_name["remap_full"]["library_ms"] / 1e6,
        "grid_sample_fullres": n_rgb / by_name["remap_selected"]["library_ms"] / 1e6,
    }
    log({"phase": "kernels", "k3_pooled_pixels": k3.numel(), "k3_fullres_pixels": full_gray.numel(),
         "k3_fullres_ms": round(k3_full_ms, 4), "k3_fullres_kernel_ms": kernel_ms(k3_full, ("remap_kernel",)),
         "k3_fullres_bound_ms": round(k3_full_b, 5),
         "k3_fullres_plain_ms": round(cuda_ms(lambda: remap.remap_gray_u8(frames, pipe.map_full), 3, 1), 4),
         "random_frames_ms": {k: round(v, 4) for k, v in random_ms.items()},
         "gpx_per_s": {k: round(v, 3) for k, v in gpx.items()},
         "k4_selected_pixels": int(on_sel.sum()), "k4_selected_tiles": n_sel_tiles, "k4_tiles_any_frame": n_tiles_any,
         "k2_max_score_err": k2_err,
         "k2_kernel_ms_by_launch": kernel_split(lambda: cuda_proposals.proposals_from_pool(pool, H, W, p),
                                                KERNEL_NAMES["proposals"]),
         # A flat pool has no candidate: the fused kernel's floor (core scores only).
         "k2_flat_pool_kernel_ms_by_launch": kernel_split(
             lambda: cuda_proposals.proposals_from_pool(torch.full_like(pool, 128.0), H, W, p),
             KERNEL_NAMES["proposals"]), "k5_pooled_bytes": pooled_src.numel(), "k3_rgb_pixels": n_rgb,
         "library_calls": {"remap_full": "F.grid_sample f32, no LAB chain", "remap_selected": "F.grid_sample f32",
                           "pool": "F.avg_pool2d f32, no u8 rounding, no pad",
                           "remap_full_rgb": "F.grid_sample f32, no LAB chain"},
         "card": card})

    # The gated auction (the tracker's solver) at the tracker's 32 x 32 on the
    # warp kernel and above it on the block kernel: seeded and crafted problems
    # at every budget against the plain version's CPU run, one call under
    # sync-as-error, timed on a seeded problem.
    from apse_uav_torch.dcnn import cuda_auction

    problems = auction_problems()
    a5 = auction_check(problems, dev)
    a5_block = auction_check(auction_block_problems(), dev)
    _, (c5, rv5, cv5) = problems[0]
    log({"phase": "auction", **a5, "block_kernel": a5_block, "timing_random_32x32": auction_timing(
        [(torch.from_numpy(c5).to(dev), torch.from_numpy(rv5).to(dev), torch.from_numpy(cv5).to(dev))], 0.6),
        "card": card})
    g5 = gconv_check(frames_hwc, dev)
    kernels.append({"name": "gconv", "route": "cuda", "source": "apse_uav_torch/csrc/gconv.cu",
                    "replaces": REPLACES["gconv"], "launches": g5["forward_launches"], "max_abs_err": g5["max_abs_err"],
                    **{k: g5["per_frame"][k] for k in ("ms", "kernel_ms", "bound_ms", "library_ms")},
                    "bound_by": g5["bound_by"], "plain_ms": g5["per_frame"]["library_ms"]})

    # -- 6. GPU against CPU, two-pass ---------------------------------------------
    cpipe = ArucoPipeline(mtx, dist, (W, H), cfg, device="cpu")
    log({"phase": "gpu-cpu", **gpu_vs_cpu(pipe, cpipe, cfg, frames[:2], dev)})
    del cpipe, rand, rand_hwc, rand_pooled, frames_f32

    # -- 7. the DCNN tracking path (track_uav) at full width ----------------------
    frames_np = frames_hwc.cpu().numpy()
    t7 = tracker_phase(frames_np, mtx, dist, card, dev)

    # -- 8.-10. tracker_test (float32 and bf16), association, detector_test -------
    t8 = tracker_eval_phase(frames_np, t7, card, dev)
    ckpt = t7["ckpt"]
    auction_launches = t7["counts"].get(cuda_auction.WARP, 0)
    del t7
    a9 = association_phase(frames_np, t8, card, dev)["auction"]
    del t8
    # The auction's row, the kernel track_uav's path ran (the warp kernel):
    # launches on that path (phase 7), times and bound per solve on the real
    # costs of phase 9.
    t9 = a9["timing_real_costs"]
    kernels.append({"name": cuda_auction.WARP, "route": "cuda", "source": "apse_uav_torch/csrc/auction.cu",
                    "replaces": REPLACES["auction"], "launches": auction_launches,
                    "max_abs_err": float(max(a5["max_abs_err"], a5_block["max_abs_err"],
                                             a9["real_costs"]["max_abs_err"])), "ms": t9["ms"],
                    "kernel_ms": t9["kernel_ms"], "plain_ms": t9["plain_ms"], "bound_ms": t9["bound_ms"],
                    "bound_by": t9["bound_by"], "library_ms": None})
    detector_phase(frames_np, card, dev)

    # -- 11.-13. training: the association head, the detector, the learning bar --
    torch.cuda.empty_cache()
    train_assoc_phase(ckpt, card, dev)
    t12 = train_detector_phase(ckpt, card, dev)
    learning_phase(card, dev)

    # -- 14.-20. slice 8: C4, bf16 training, surgery, COWC, selective, parallel ---
    torch.cuda.empty_cache()
    c4_phase(frames_np, card, dev)
    torch.cuda.empty_cache()
    c4_train_phase(card, dev)
    torch.cuda.empty_cache()
    train_bf16_phase(ckpt, t12["step_ms"], card, dev)
    surgery_phase(frames_np[0], card, dev)
    from apse_uav_torch.dcnn.config import uav_tracker_config

    cowc_phase(ckpt, uav_tracker_config(), card, dev)
    selective_phase(frames_np, ckpt, uav_tracker_config(), card, dev)
    parallel_phase(frames_np, frames, pipe, ckpt, uav_tracker_config(), card, dev)

    # -- 21. the 4K operating point against ground truth --------------------------
    operating_point_phase(mtx, dist, card, dev)

    print(card)
    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
