"""Vehicle tracking over a UAV sequence -> DCNN comparison CSV, on the PyTorch port.

Flags and outputs are those of the JAX reference's ``cli/track_uav.py``: the
Mask R-CNN tracker runs over a 4K video (or image directory), logs per-frame
mask centroids and closest-points-to-host into the 17-column CSV that the
ArUco pipeline reads, and optionally writes visualised frames; plus
``--device cuda|cpu`` (``cuda`` raises when no card is visible, never falls
back).  With ``--preprocess`` the port's ``Preprocessor`` (kernel K3's RGB
mode on the card) undistorts and gamma-corrects each batch, which stays on
the device.  TF32 is switched off, so the float32 model runs in float32.
``--bf16`` and ``--assoc_weights`` are not ported yet and raise.  Without
``--assoc_weights`` the re-ID head takes seeded weights
(``models.association.init_weights``), as the reference takes its own
initialisation.

Usage:
    python -m apse_uav_torch.cli.track_uav --video seq.mp4 \
        --weights model_final.pkl --num_classes 4 --host_id 4 \
        --log_file dcnn_data.csv [--write_images out/ --preprocess cam.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--video", help="input video path")
    src.add_argument("--images", help="input image directory")
    p.add_argument("--weights", required=True, help="detector checkpoint (.pkl/.pth)")
    p.add_argument("--assoc_weights", default=None, help="association head checkpoint (not ported yet: raises)")
    p.add_argument("--depth", type=int, default=101, choices=(50, 101))
    p.add_argument("--num_classes", type=int, default=4)
    p.add_argument("--confidence", type=float, default=0.5)
    p.add_argument("--host_id", type=int, default=4, help="host (Ford) track id for closest points")
    p.add_argument("--log_file", default=None, help="write the 17-col DCNN CSV here")
    p.add_argument("--write_images", default=None, help="directory for visualized frames")
    p.add_argument("--start_frame", type=int, default=0)
    p.add_argument("--stop_frame", type=int, default=None)
    p.add_argument("--batch", type=int, default=4, help="frames per detector batch")
    p.add_argument("--bf16", action="store_true", help="bf16 compute (not ported yet: raises)")
    p.add_argument("--preprocess", default=None, help="cam_params.json: undistort+gamma frames first")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default; raises when no card is visible) or cpu (plain PyTorch path)")
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


def track(args, frames, on_frame=None) -> dict:
    """The CLI's loop over ``frames``, an iterable of (idx, (H, W, 3) u8 BGR
    numpy frame): batches of ``args.batch`` frames, dispatched one batch ahead
    of the host's consumption (CSV rows, images).  ``on_frame(idx, recent)``,
    if given, receives each frame's snapshot (numpy).  Writes
    ``args.log_file``; returns {"frames", "rows", "max_obj_id", "seconds"}."""
    import torch

    from apse_uav_torch.dcnn import weights as W
    from apse_uav_torch.dcnn.config import TrackerConfig, mask_rcnn_r50_fpn, mask_rcnn_r101_fpn
    from apse_uav_torch.dcnn.engines import RcnnTracker
    from apse_uav_torch.dcnn.models.association import init_weights
    from apse_uav_torch.device import resolve_device
    from apse_uav_torch.utils.mask_geometry import dcnn_log_line, write_dcnn_log

    if args.bf16:
        raise NotImplementedError("--bf16: the bf16 compute path is not ported yet (ROADMAP.md, item 12)")
    if args.assoc_weights:
        raise NotImplementedError("--assoc_weights: loading the association head's training checkpoint needs "
                                  "train/checkpoint.py, not ported yet (ROADMAP.md, item 12)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = resolve_device(args.device)
    make = mask_rcnn_r50_fpn if args.depth == 50 else mask_rcnn_r101_fpn
    cfg = make(num_classes=args.num_classes)
    cfg = dataclasses.replace(cfg, roi=dataclasses.replace(cfg.roi, score_thresh_test=args.confidence))

    frames = iter(frames)
    try:
        first_idx, first = next(frames)
    except StopIteration:
        raise ValueError("no frames to track") from None
    orig_hw = first.shape[:2]
    pre = None
    if args.preprocess:
        from apse_uav_torch.preproc.remap import Preprocessor

        pre = Preprocessor.from_json(args.preprocess, (orig_hw[1], orig_hw[0]), device=device)

    tcfg = TrackerConfig()
    assoc = init_weights(cfg.fpn_channels * tcfg.roi_size**2, tcfg.embedding_dim)
    tracker = RcnnTracker(cfg, tcfg, W.load_torch_file(args.weights), assoc, orig_hw, device=device)
    if tracker.predictor.missing:
        print(f"warning: {len(tracker.predictor.missing)} params not found in checkpoint (left at init)")
    vis = None
    if args.write_images:
        from apse_uav_torch.utils.visualizer import TrackVisualizer

        vis = TrackVisualizer()
        os.makedirs(args.write_images, exist_ok=True)

    log_lines: list[str] = []
    max_obj_id = 0
    n_done = 0
    t_start = time.perf_counter()

    def dispatch(batch_frames, batch_idxs):
        """Enqueue preprocess + detect + associate for a batch."""
        x = torch.from_numpy(np.stack(batch_frames)).to(device)
        if pre is not None:
            # Stays on the device: the predictor reads it there.
            x, _ = pre(x, with_gray=False)
        return tracker.process_frames_async(x), batch_frames, batch_idxs

    def consume(pending):
        nonlocal max_obj_id, n_done
        handle, batch_frames, batch_idxs = pending
        recents = tracker.materialize(handle)
        for b, idx in enumerate(batch_idxs):
            recent = {k: v[b] for k, v in recents.items()}
            if args.log_file:
                line, highest = dcnn_log_line(recent, args.host_id, idx, orig_hw)
                log_lines.append(line)
                max_obj_id = max(max_obj_id, highest)
            if on_frame is not None:
                on_frame(idx, recent)
            if vis is not None:
                import cv2

                cv2.imwrite(os.path.join(args.write_images, f"image_{idx:04d}.png"), vis.draw(batch_frames[b], recent))
        n_done += len(batch_idxs)
        print(f"frame {batch_idxs[-1]}: {n_done / (time.perf_counter() - t_start):.2f} fps", end="\r")

    # One batch deep: batch N+1 is dispatched before the host consumes batch N.
    pending = None
    batch_frames, batch_idxs = [first], [first_idx]
    for idx, frame in frames:
        batch_frames.append(frame)
        batch_idxs.append(idx)
        if len(batch_frames) == args.batch:
            nxt = dispatch(batch_frames, batch_idxs)
            if pending is not None:
                consume(pending)
            pending = nxt
            batch_frames, batch_idxs = [], []
    if batch_frames:
        nxt = dispatch(batch_frames, batch_idxs)
        if pending is not None:
            consume(pending)
        pending = nxt
    if pending is not None:
        consume(pending)
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
