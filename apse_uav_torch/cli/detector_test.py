"""Detector smoke test over an image directory on the PyTorch port
(standard_rcnn_detector_test.py / aerial_view_test.py equivalent).

Flags are those of the JAX reference's ``cli/detector_test.py``, plus
``--device cuda|cpu`` (``cuda`` raises when no card is visible, never falls
back).  Runs the detector on each image and writes an annotated copy
(``<name>_det<ext>``) next to it or into ``--output_dir``.  The detection
itself is :func:`detect`, which takes a numpy frame, so it runs without
cv2; reading, drawing and writing stay in :func:`main`.

Usage:
    python -m apse_uav_torch.cli.detector_test --images test_images/ \
        --weights model_final.pth [--no_mask] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from apse_uav_torch.cli import track_uav


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--images", required=True)
    p.add_argument("--weights", required=True)
    p.add_argument("--depth", type=int, default=101, choices=(50, 101))
    p.add_argument("--num_classes", type=int, default=4)
    p.add_argument("--confidence", type=float, default=0.5)
    p.add_argument("--no_mask", action="store_true", help="Faster R-CNN weights (no mask head)")
    p.add_argument("--output_dir", default=None)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default; raises when no card is visible) or cpu (plain PyTorch path)")
    return p


def build_predictor(args, orig_hw: tuple[int, int], weights=None):
    """The TrackPredictor the flags ask for (``track_uav.model_config``), for
    frames of ``orig_hw``; ``weights`` (a loaded state dict) saves reading
    ``args.weights`` again."""
    from apse_uav_torch.dcnn import weights as W
    from apse_uav_torch.dcnn.engines import TrackPredictor

    device = track_uav.cli_device(args)
    weights = W.load_torch_file(args.weights) if weights is None else weights
    return TrackPredictor(track_uav.model_config(args), weights, orig_hw, device=device)


def detect(predictor, frame: np.ndarray) -> dict[str, np.ndarray]:
    """One (H, W, 3) u8 frame -> its detections as numpy, in the tracker
    snapshot's layout (``ids`` the detection slots): valid, ids, boxes,
    scores, classes and, with a mask head, masks (float32)."""
    dets, _ = predictor(frame[None])
    out = {"valid": dets["valid"][0], "ids": np.arange(dets["boxes"].shape[1]), "boxes": dets["boxes"][0],
           "scores": dets["scores"][0], "classes": dets["classes"][0]}
    if "masks" in dets:
        out["masks"] = dets["masks"][0].float()
    return {k: v if isinstance(v, np.ndarray) else v.cpu().numpy() for k, v in out.items()}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import cv2

    from apse_uav_torch.dcnn import weights as W
    from apse_uav_torch.utils.visualizer import TrackVisualizer

    weights = W.load_torch_file(args.weights)
    out_dir = args.output_dir or args.images
    os.makedirs(out_dir, exist_ok=True)
    vis = TrackVisualizer()
    predictor = None
    for name in sorted(os.listdir(args.images)):
        if not name.lower().endswith((".jpg", ".png", ".bmp")) or "_det" in name:
            continue
        frame = cv2.imread(os.path.join(args.images, name))
        if predictor is None or predictor.orig_hw != frame.shape[:2]:
            predictor = build_predictor(args, frame.shape[:2], weights)
        recent = detect(predictor, frame)
        stem, ext = os.path.splitext(name)
        cv2.imwrite(os.path.join(out_dir, f"{stem}_det{ext}"), vis.draw(frame, recent))
        print(f"{name}: {int(recent['valid'].sum())} detections")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
