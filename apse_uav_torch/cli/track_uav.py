"""Vehicle tracking over a UAV sequence -> DCNN comparison CSV, on the PyTorch port.

Flags and outputs are those of the JAX reference's ``cli/track_uav.py``: the
Mask R-CNN tracker runs over a 4K video (or image directory), logs per-frame
mask centroids and closest-points-to-host into the 17-column CSV that the
ArUco pipeline reads, and optionally writes visualised frames; plus
``--device cuda|cpu`` (``cuda`` raises when no card is visible, never falls
back) and ``--arch c4``, which runs Mask R-CNN R-C4 (res5 as the ROI head;
the re-ID embeddings read its res2) where the reference runs R-FPN, and
``--resnext 32x8d``, which runs Mask R-CNN X101-32x8d-FPN (the R-FPN
tracker on a ResNeXt trunk: 32 groups in every bottleneck's 3x3).  With
``--preprocess`` the port's ``Preprocessor`` (kernel K3's RGB mode on the
card) undistorts and gamma-corrects each batch, which stays on the device.
TF32 is switched off, so the float32 model runs in float32; ``--bf16`` runs the backbone and heads in bfloat16 with float32 parameters,
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
        --log_file dcnn_data.csv [--write_images out/ --preprocess cam.json] [--arch c4 | --resnext 32x8d]
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
    p.add_argument("--arch", default="fpn", choices=("fpn", "c4"),
                   help="fpn (mask_rcnn_R_{50,101}_FPN_3x) or c4 (mask_rcnn_R_{50,101}_C4_3x: res5 as the ROI head)")
    p.add_argument("--resnext", default=None, choices=("32x8d",),
                   help="a ResNeXt trunk: 32x8d = mask_rcnn_X_101_32x8d_FPN_3x (with --arch fpn --depth 101)")
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
    where the CLI has them, ``--arch`` (R-FPN without it), ``--resnext``
    (X101-32x8d-FPN, only with R-FPN at depth 101), ``--bf16`` and
    ``--no_mask``."""
    from apse_uav_torch.dcnn import config as C

    arch = getattr(args, "arch", "fpn")
    if getattr(args, "resnext", None):
        if arch != "fpn" or args.depth != 101:
            raise SystemExit(f"--resnext {args.resnext} needs --arch fpn --depth 101 "
                             f"(mask_rcnn_X_101_32x8d_FPN_3x), not --arch {arch} --depth {args.depth}")
        r50 = r101 = C.mask_rcnn_x101_32x8d_fpn
    else:
        r50, r101 = {"fpn": (C.mask_rcnn_r50_fpn, C.mask_rcnn_r101_fpn),
                     "c4": (C.mask_rcnn_r50_c4, C.mask_rcnn_r101_c4)}[arch]
    cfg = (r101 if args.depth == 101 else r50)(num_classes=args.num_classes)
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
    from apse_uav_torch.dcnn.engines import RcnnTracker, reid_map
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
    assoc = head_weights(args.assoc_weights, reid_map(cfg)[1] * tcfg.roi_size**2, tcfg.embedding_dim)
    tracker = RcnnTracker(cfg, tcfg, weights, assoc, orig_hw, device=device)
    if tracker.predictor.missing:
        print(f"warning: {len(tracker.predictor.missing)} params not found in checkpoint (left at init)")
    pre = None
    if args.preprocess:
        from apse_uav_torch.preproc.remap import Preprocessor

        pre = Preprocessor.from_json(args.preprocess, (orig_hw[1], orig_hw[0]), device=device)
    return tracker, pre


class UploadRing:
    """Page-locked host buffers, used in turn, through which batches of
    frames reach the card.

    :meth:`stage` copies a batch's frames (numpy arrays of one shape and
    dtype, at most ``batch`` of them) into the next slot, a ``(batch, *frame
    shape)`` buffer, and returns the slot's number and its first
    ``len(frames)`` rows.  The slots are allocated at the first batch and
    again only when the frames' shape or dtype changes; torch's CPU copy
    fills them with its intra-op threads, and their pages are already
    resident.  :meth:`upload` copies the staged rows into a fresh tensor on
    the card without blocking the host and records an event after the copy:
    a slot is refilled only once its event has passed, and a wait there
    counts as ``sync.upload_slot``.  ``pin=False`` keeps the slots in
    pageable memory, for :meth:`stage` alone.
    """

    SLOTS = 2  # one filled while the other's copy may still be queued

    def __init__(self, batch: int, pin: bool = True):
        self.batch, self.pin = batch, pin
        self.buffers: list = []
        self.events: list = [None] * self.SLOTS  # each slot's last copy to the card, while it may be pending
        self.turn = 0  # the slot that stage() fills next

    def stage(self, frames):
        """Copy ``frames`` into the next slot; returns (slot number, its
        first ``len(frames)`` rows)."""
        import torch

        from apse_uav_torch.utils import profiling

        if not 0 < len(frames) <= self.batch:
            raise ValueError(f"{len(frames)} frames for slots of {self.batch}")
        # A C-contiguous frame as it is; a copy only of a view that no tensor
        # can hold (negative strides, as a channel-reversed frame[..., ::-1]).
        src = [torch.from_numpy(np.ascontiguousarray(f)) for f in frames]
        shape = (self.batch, *src[0].shape)
        if not self.buffers or self.buffers[0].shape != shape or self.buffers[0].dtype != src[0].dtype:
            # A copy still reading an old slot keeps its memory: the caching
            # host allocator hands a block out again only after its copies.
            self.buffers = [torch.empty(shape, dtype=src[0].dtype, pin_memory=self.pin) for _ in range(self.SLOTS)]
            self.events = [None] * self.SLOTS
        i = self.turn
        self.turn = (i + 1) % self.SLOTS
        event, self.events[i] = self.events[i], None
        if event is not None and not event.query():
            with profiling.sync("upload_slot"):
                event.synchronize()
        rows = self.buffers[i][:len(src)]
        for row, f in zip(rows, src):
            row.copy_(f)
        return i, rows

    def upload(self, frames, device):
        """``frames`` staged and copied to a fresh (n, *frame shape) tensor on
        ``device``, a card; the copy queues behind the work before it on
        the current stream, and the host goes on."""
        import torch

        i, rows = self.stage(frames)
        x = torch.empty(rows.shape, dtype=rows.dtype, device=device)
        x.copy_(rows, non_blocking=True)
        self.events[i] = torch.cuda.Event()
        self.events[i].record(torch.cuda.current_stream(device))
        return x


def track_frames(tracker, pre, frames, batch: int):
    """Track ``frames``, an iterable of (idx, (H, W, 3) u8 BGR numpy frame),
    in batches of ``batch`` frames through ``pre`` (or none) and
    ``tracker``.  One batch deep: batch N+1 is dispatched before the host
    takes batch N's snapshots.  On a card each batch goes up through an
    the :class:`UploadRing` (counted as ``track.upload_pinned``);
    on the CPU it is stacked.  Yields (idx, frame, snapshot as numpy) for
    every frame, in order."""
    import torch

    from apse_uav_torch.utils import profiling

    ring = UploadRing(batch) if torch.device(tracker.device).type == "cuda" else None

    def dispatch(chunk):
        """Enqueue preprocess + detect + associate for a batch."""
        batch = getattr(tracker, "dispatched", 0) + 1  # the number the tracker gives this dispatch
        with profiling.span("track.upload", batch):
            if ring is not None:
                # A copy from page-locked memory: it waits on the card for the
                # work queued before it, and the host goes on to dispatch the batch.
                x = ring.upload([f for _, f in chunk], tracker.device)
                profiling.count("track.upload_pinned")
            else:
                x = torch.from_numpy(np.stack([f for _, f in chunk]))
                # On the CPU the stacked frames are already where the tracker reads them.
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
