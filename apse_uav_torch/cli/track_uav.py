"""Vehicle tracking over a UAV sequence -> DCNN comparison CSV, on the PyTorch port.

Flags and outputs are those of the JAX reference's ``cli/track_uav.py``: the
Mask R-CNN tracker runs over a 4K video (or image directory), logs per-frame
mask centroids and closest-points-to-host into the 17-column CSV that the
ArUco pipeline reads, and optionally writes visualised frames; plus
``--device cuda|cpu`` (``cuda`` raises when no card is visible, never falls
back).  With ``--preprocess`` the port's ``Preprocessor`` (kernel K3's RGB
mode on the card) undistorts and gamma-corrects each batch, which stays on
the device.  TF32 is switched off, so the float32 model runs in float32;
``--bf16`` runs the backbone and heads in bfloat16 with float32 parameters,
as the reference's ``--bf16`` does.  ``--assoc_weights`` names a checkpoint
of the port's format (``apse_uav_torch.train.checkpoint``; a reference
checkpoint converts through ``convert.checkpoint_state``), whose ``params``
are the re-ID head's.  Without it, or if the path does not exist (a warning
then says so), the re-ID head takes the reference's default: its flax
initialisation under ``PRNGKey(1)``, reproduced without JAX
(``models.association.head_weights``), so the ids match the reference's.
``--profile DIR`` writes a Chrome trace of the run, the program's spans
beside the kernels, to ``DIR/trace.json``.

Usage:
    python -m apse_uav_torch.cli.track_uav --video seq.mp4 \
        --weights model_final.pkl --num_classes 4 --host_id 4 \
        --log_file dcnn_data.csv [--write_images out/ --preprocess cam.json]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import os
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--video", help="input video path")
    src.add_argument("--images", help="input image directory")
    p.add_argument("--weights", required=True, help="detector checkpoint (.pkl/.pth)")
    p.add_argument("--assoc_weights", default=None,
                   help="association head checkpoint (the port's format, e.g. workdir/bestAP); default: the "
                        "reference's default head (flax init under PRNGKey(1))")
    p.add_argument("--depth", type=int, default=101, choices=(50, 101))
    p.add_argument("--num_classes", type=int, default=4)
    p.add_argument("--confidence", type=float, default=0.5)
    p.add_argument("--host_id", type=int, default=4, help="host (Ford) track id for closest points")
    p.add_argument("--log_file", default=None, help="write the 17-col DCNN CSV here")
    p.add_argument("--write_images", default=None, help="directory for visualized frames")
    p.add_argument("--start_frame", type=int, default=0)
    p.add_argument("--stop_frame", type=int, default=None)
    p.add_argument("--batch", type=int, default=4, help="frames per detector batch")
    p.add_argument("--bf16", action="store_true", help="bf16 backbone/head compute (f32 params)")
    p.add_argument("--preprocess", default=None, help="cam_params.json: undistort+gamma frames first")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default; raises when no card is visible) or cpu (plain PyTorch path)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="trace the run (the program's spans beside the kernels) into DIR/trace.json")
    return p


def _frames(args):
    """Yield (idx, frame_bgr_u8) of the video or image directory (cv2)."""
    import cv2

    if args.video:
        video = cv2.VideoCapture(args.video)
        try:
            idx = 0
            while True:
                ret, frame = video.read()
                if not ret:
                    return
                if idx >= args.start_frame and (args.stop_frame is None or idx <= args.stop_frame):
                    yield idx, frame
                idx += 1
                if args.stop_frame is not None and idx > args.stop_frame:
                    return
        finally:
            video.release()
    else:
        names = sorted(os.listdir(args.images))
        for idx, name in enumerate(names):
            if idx < args.start_frame:
                continue
            if args.stop_frame is not None and idx > args.stop_frame:
                return
            yield idx, cv2.imread(os.path.join(args.images, name))


def model_config(args):
    """The ModelConfig the flags ask for, by the reference CLIs' rules:
    ``--depth`` (26, 50 or 101), ``--num_classes``, ``--confidence`` and,
    where the CLI has them, ``--bf16`` and ``--no_mask``."""
    from apse_uav_torch.dcnn.config import mask_rcnn_r50_fpn, mask_rcnn_r101_fpn

    cfg = (mask_rcnn_r101_fpn if args.depth == 101 else mask_rcnn_r50_fpn)(num_classes=args.num_classes)
    if args.depth == 26:
        cfg = dataclasses.replace(cfg, depth=26)
    cfg = dataclasses.replace(cfg, roi=dataclasses.replace(cfg.roi, score_thresh_test=args.confidence))
    if getattr(args, "bf16", False):
        cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    if getattr(args, "no_mask", False):
        cfg = dataclasses.replace(cfg, mask_on=False)
    return cfg


def cli_device(args):
    """The device ``--device`` names (``cuda`` raises when no card is
    visible), with TF32 off so that the float32 model runs in float32."""
    import torch

    from apse_uav_torch.device import resolve_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return resolve_device(args.device)


def build_tracker(args, orig_hw: tuple[int, int], cfg=None):
    """The RcnnTracker the flags ask for, for frames of ``orig_hw``, and the
    ``Preprocessor`` (or None) that goes before it.  The detector's weights
    are ``--checkpoint``'s ``params`` (the port's checkpoint format) where
    the CLI has that flag and it is given, else ``--weights``' detectron2
    file; ``--association`` picks the metric where the CLI has it.  ``cfg``
    overrides :func:`model_config`."""
    from apse_uav_torch.dcnn import weights as W
    from apse_uav_torch.dcnn.config import TrackerConfig
    from apse_uav_torch.dcnn.engines import RcnnTracker
    from apse_uav_torch.dcnn.models.association import head_weights

    device = cli_device(args)
    cfg = model_config(args) if cfg is None else cfg
    checkpoint = getattr(args, "checkpoint", None)
    if checkpoint:
        from apse_uav_torch.train.checkpoint import load_state

        state = load_state(os.path.dirname(checkpoint) or ".", os.path.basename(checkpoint))
        if state is None:
            raise SystemExit(f"checkpoint not found: {checkpoint}")
        weights = state["params"] if "params" in state else state
    elif args.weights:
        weights = W.load_torch_file(args.weights)
    else:
        raise SystemExit("one of --weights / --checkpoint is required")
    tcfg = TrackerConfig()
    if getattr(args, "association", None):
        tcfg = dataclasses.replace(tcfg, association_metric=args.association)
    assoc = head_weights(args.assoc_weights, cfg.fpn_channels * tcfg.roi_size**2, tcfg.embedding_dim)
    tracker = RcnnTracker(cfg, tcfg, weights, assoc, orig_hw, device=device)
    if tracker.predictor.missing:
        print(f"warning: {len(tracker.predictor.missing)} params not found in checkpoint (left at init)")
    pre = None
    if args.preprocess:
        from apse_uav_torch.preproc.remap import Preprocessor

        pre = Preprocessor.from_json(args.preprocess, (orig_hw[1], orig_hw[0]), device=device)
    return tracker, pre


def track_frames(tracker, pre, frames, batch: int):
    """Track ``frames``, an iterable of (idx, (H, W, 3) u8 BGR numpy frame),
    in batches of ``batch`` frames through ``pre`` (or none) and
    ``tracker``.  One batch deep: batch N+1 is dispatched before the host
    takes batch N's snapshots.  Yields (idx, frame, snapshot as numpy) for
    every frame, in order."""
    import torch

    from apse_uav_torch.utils import profiling

    def dispatch(chunk):
        """Enqueue preprocess + detect + associate for a batch."""
        batch = getattr(tracker, "dispatched", 0) + 1  # the number the tracker gives this dispatch
        with profiling.span("track.upload", batch):
            x = torch.from_numpy(np.stack([f for _, f in chunk]))
            # A pageable copy: the host waits for the work queued before it.
            with profiling.sync("upload"):
                x = x.to(tracker.device)
        if pre is not None:
            # Stays on the device: the predictor reads it there.
            with profiling.span("track.preprocess", batch):
                x, _ = pre(x, with_gray=False)
        return tracker.process_frames_async(x), chunk

    def consume(pending):
        handle, chunk = pending
        recents = tracker.materialize(handle)
        for b, (idx, frame) in enumerate(chunk):
            yield idx, frame, {k: v[b] for k, v in recents.items()}

    pending, chunk = None, []
    for item in frames:
        chunk.append(item)
        if len(chunk) == batch:
            nxt = dispatch(chunk)
            if pending is not None:
                yield from consume(pending)
            pending, chunk = nxt, []
    if chunk:
        nxt = dispatch(chunk)
        if pending is not None:
            yield from consume(pending)
        pending = nxt
    if pending is not None:
        yield from consume(pending)


def track(args, frames, on_frame=None) -> dict:
    """The CLI's loop over ``frames``, an iterable of (idx, (H, W, 3) u8 BGR
    numpy frame), through :func:`track_frames`, the host writing CSV rows
    and images; under ``profiling.trace(args.profile)`` when ``--profile``
    is given.  ``on_frame(idx, recent)``, if given, receives each frame's
    snapshot (numpy).  Writes ``args.log_file``; returns {"frames", "rows",
    "max_obj_id", "seconds"}."""
    from apse_uav_torch.utils import profiling
    from apse_uav_torch.utils.mask_geometry import dcnn_log_line, write_dcnn_log

    frames = iter(frames)
    try:
        first = next(frames)
    except StopIteration:
        raise ValueError("no frames to track") from None
    orig_hw = first[1].shape[:2]
    tracker, pre = build_tracker(args, orig_hw)
    vis = None
    if args.write_images:
        from apse_uav_torch.utils.visualizer import TrackVisualizer

        vis = TrackVisualizer()
        os.makedirs(args.write_images, exist_ok=True)

    log_lines: list[str] = []
    max_obj_id = 0
    n_done = 0
    traced = profiling.trace(args.profile) if args.profile else contextlib.nullcontext()
    t_start = time.perf_counter()
    with traced:
        for idx, frame, recent in track_frames(tracker, pre, itertools.chain([first], frames), args.batch):
            if args.log_file:
                line, highest = dcnn_log_line(recent, args.host_id, idx, orig_hw)
                log_lines.append(line)
                max_obj_id = max(max_obj_id, highest)
            if on_frame is not None:
                on_frame(idx, recent)
            if vis is not None:
                import cv2

                cv2.imwrite(os.path.join(args.write_images, f"image_{idx:04d}.png"), vis.draw(frame, recent))
            n_done += 1
            if n_done % args.batch == 0:
                print(f"frame {idx}: {n_done / (time.perf_counter() - t_start):.2f} fps", end="\r")
    print()
    if args.log_file:
        write_dcnn_log(args.log_file, log_lines, args.host_id, max_obj_id)
        print(f"wrote {args.log_file} ({len(log_lines)} rows, {max_obj_id} ids)")
    return {"frames": n_done, "rows": len(log_lines), "max_obj_id": max_obj_id,
            "seconds": time.perf_counter() - t_start}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    track(args, _frames(args))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
