"""Tracker test harnesses on the PyTorch port (standard_rcnn_tracker_test.py equivalent).

Flags are those of the JAX reference's ``cli/tracker_test.py``, plus
``--device cuda|cpu`` (``cuda`` raises when no card is visible, never falls
back; ``--force_cpu`` is ``--device cpu``) and ``--preprocess cam.json`` (the
port's ``Preprocessor``, kernel K3's RGB mode on the card, before the
detector, as in ``track_uav``).  Modes:

* ``--sequence DIR``  -- run over an image directory with frames/s timing;
* ``--mots_evaluation SEQMAP --kitti_root DIR`` -- write uint16 id PNG
  results per KITTI-MOTS sequence under ``--output_dir`` for ``mots_eval``;
* ``--video PATH`` / ``--webcam`` -- a live capture loop (cv2 window).

``--checkpoint workdir/bestAP`` reads the port's checkpoint format
(``apse_uav_torch.train.checkpoint``; a reference checkpoint converts
through ``convert.checkpoint_state``); ``--weights`` a detectron2 file.
Without ``--assoc_weights`` the re-ID head is the reference's default.
The loop over one sequence is :func:`track_sequence`, which takes numpy
frames, so it runs without cv2 or PIL.

Usage:
    python -m apse_uav_torch.cli.tracker_test --mots_evaluation seqmap.txt \
        --kitti_root images/ --weights model_final.pkl --num_classes 80
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import os
import time

from apse_uav_torch.cli import track_uav


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("--sequence", help="image directory")
    mode.add_argument("--mots_evaluation", help="seqmap file")
    mode.add_argument("--webcam", action="store_true")
    mode.add_argument("--video", help="video file path or stream URL (anything cv2.VideoCapture opens)")
    p.add_argument("--kitti_root", default=None, help="KITTI-MOTS images root (one dir per sequence)")
    p.add_argument("--output_dir", default="mots_results")
    p.add_argument("--weights", default=None, help="detectron2-format .pkl/.pth weights")
    p.add_argument("--checkpoint", default=None,
                   help="the port's checkpoint of a model (directory/name, e.g. workdir/bestAP)")
    p.add_argument("--assoc_weights", default=None,
                   help="association head checkpoint (the port's format); default: the reference's default head")
    p.add_argument("--depth", type=int, default=101, choices=(26, 50, 101))
    p.add_argument("--num_classes", type=int, default=80)
    p.add_argument("--bf16", action="store_true", help="bf16 backbone/head compute (f32 params)")
    p.add_argument("--confidence", type=float, default=0.5)
    p.add_argument("--association", default=None, choices=("embeddings", "bbox_center_dist", "mask_iou"),
                   help="association metric (rcnn_tracker.py:79-147)")
    p.add_argument("--batch", type=int, default=4)
    # Scale knobs for small runs (synthetic sequences, CPU hosts).
    p.add_argument("--min_size", type=int, default=None, help="override INPUT min_size_test")
    p.add_argument("--max_size", type=int, default=None, help="override INPUT max_size_test")
    p.add_argument("--proposal_topk", type=int, default=None, help="override RPN pre/post-NMS test top-k")
    p.add_argument("--detections", type=int, default=None, help="override detections per image")
    p.add_argument("--pixel_norm", choices=("caffe", "unit"), default="caffe",
                   help="'unit' = mean 128 / std 64 (scratch-trained models)")
    p.add_argument("--preprocess", default=None, help="cam_params.json: undistort+gamma frames first")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default; raises when no card is visible) or cpu (plain PyTorch path)")
    p.add_argument("--force_cpu", dest="device", action="store_const", const="cpu", help="the same as --device cpu")
    return p


def model_config(args):
    """``track_uav``'s ModelConfig with the scale knobs on top."""
    cfg = track_uav.model_config(args)
    inp = cfg.input
    if args.min_size:
        inp = dataclasses.replace(inp, min_size_test=args.min_size)
    if args.max_size:
        inp = dataclasses.replace(inp, max_size_test=args.max_size)
    if args.pixel_norm == "unit":
        inp = dataclasses.replace(inp, pixel_mean=(128.0,) * 3, pixel_std=(64.0,) * 3)
    cfg = dataclasses.replace(cfg, input=inp)
    if args.proposal_topk:
        cfg = dataclasses.replace(cfg, rpn=dataclasses.replace(cfg.rpn, pre_nms_topk_test=args.proposal_topk,
                                                               post_nms_topk_test=args.proposal_topk))
    if args.detections:
        cfg = dataclasses.replace(cfg, roi=dataclasses.replace(cfg.roi, detections_per_image=args.detections))
    return cfg


def build_tracker(args, orig_hw: tuple[int, int]):
    """``track_uav.build_tracker`` with this CLI's :func:`model_config`: the
    RcnnTracker and the ``Preprocessor`` (or None) for frames of ``orig_hw``."""
    return track_uav.build_tracker(args, orig_hw, model_config(args))


def track_sequence(args, frames, built=None) -> tuple[list[dict], dict]:
    """The tracker over one sequence: ``frames`` an iterable of (H, W, 3) u8
    BGR numpy frames through ``track_uav.track_frames`` in batches of
    ``args.batch``.  ``built``: a (tracker, preprocessor) pair from
    :func:`build_tracker` to use instead of building one from the first
    frame.  Returns (one snapshot per frame, as numpy, and {"frames",
    "seconds", "frames_per_s", "hw"}: hw the frames' (H, W))."""
    frames = iter(frames)
    first = next(frames, None)
    if first is None:
        return [], {"frames": 0, "seconds": 0.0, "frames_per_s": 0.0, "hw": None}
    hw = tuple(first.shape[:2])
    t0 = time.perf_counter()
    tracker, pre = build_tracker(args, hw) if built is None else built
    recents = [r for _, _, r in track_uav.track_frames(tracker, pre, enumerate(itertools.chain([first], frames)),
                                                       args.batch)]
    seconds = time.perf_counter() - t0
    return recents, {"frames": len(recents), "seconds": seconds, "frames_per_s": len(recents) / max(seconds, 1e-9),
                     "hw": hw}


def _read_frames(directory: str, names: list[str]):
    import cv2

    for name in names:
        yield cv2.imread(os.path.join(directory, name))


def run_sequence(args) -> int:
    names = sorted(os.listdir(args.sequence))
    _, stats = track_sequence(args, _read_frames(args.sequence, names))
    print(f"{stats['frames']} frames: average fps {stats['frames_per_s']:.2f}")
    return 0


def run_mots(args) -> int:
    from PIL import Image

    from apse_uav_torch.evaluation.mots import load_seqmap
    from apse_uav_torch.evaluation.mots_export import result_image_from_recent

    seq_names, max_frames = load_seqmap(args.mots_evaluation)
    for seq in seq_names:
        seq_dir = os.path.join(args.kitti_root, seq)
        out_dir = os.path.join(args.output_dir, seq)
        os.makedirs(out_dir, exist_ok=True)
        names = sorted(os.listdir(seq_dir))[: max_frames[seq] + 1]
        recents, stats = track_sequence(args, _read_frames(seq_dir, names))
        for f, recent in enumerate(recents):
            Image.fromarray(result_image_from_recent(recent, stats["hw"])).save(os.path.join(out_dir, f"{f:06d}.png"))
        print(f"sequence {seq}: wrote {len(names)} result images")
    return 0


def _run_capture(args, source, err) -> int:
    import cv2

    from apse_uav_torch.utils.visualizer import TrackVisualizer

    cam = cv2.VideoCapture(source)
    ret, frame = cam.read()
    if not ret:
        print(err)
        return 1
    tracker, pre = build_tracker(args, frame.shape[:2])
    vis = TrackVisualizer()
    while True:
        ret, frame = cam.read()
        if not ret:
            break
        recent, _ = track_sequence(args, [frame], (tracker, pre))
        cv2.imshow("tracking", vis.draw(frame, recent[0]))
        if cv2.waitKey(1) == ord("q"):
            break
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.sequence:
        return run_sequence(args)
    if args.mots_evaluation:
        if not args.kitti_root:
            raise SystemExit("--mots_evaluation requires --kitti_root")
        return run_mots(args)
    if args.video:
        return _run_capture(args, args.video, f"cannot open {args.video}")
    return _run_capture(args, 0, "no webcam available")


if __name__ == "__main__":
    raise SystemExit(main())
