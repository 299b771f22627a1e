"""ArUco measurement CLI on the PyTorch port (CUDA by default).

Flags and CSV schemas are those of the JAX reference's ``cli/aruco_detect.py``
(images ``image_%04d.png``, the cam_params.json format, the DCNN centroid
CSV, both result schemas, annotated images with ``--save_images``, the live
annotated view with ``--display``: the reference's imshow loop, ``q``
quits), plus ``--device cuda|cpu``.  ``cuda`` raises when no card is visible; it never
falls back to the CPU.  TF32 is switched off for matmuls and cuDNN so that
the geometry stays in full float32.

Usage:
    python -m apse_uav_torch.cli.aruco_detect \
        --path_camera_params data/cam_params.json \
        --use_images --path_input_images frames/ \
        --save_results --path_output_results out.csv
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--start_frame", type=int, default=1)
    p.add_argument("--stop_frame", type=int, default=None)
    p.add_argument("--step_frame", type=int, default=1)
    p.add_argument("--save_results", action="store_true")
    p.add_argument("--save_images", action="store_true")
    p.add_argument("--use_centroid_data", action="store_true")
    p.add_argument("--N_avg", type=int, default=1)
    p.add_argument("--LEDs_threshold", type=float, default=None)
    p.add_argument("--led_bias", type=float, nargs=2, default=(0.0, 0.0), metavar=("DX", "DY"),
                   help="cv2-compat shift (px) of projected LED sample points")
    p.add_argument("--source_lidar", dest="sourceLidar", action="store_true")
    p.add_argument("--path_camera_params", required=True)
    p.add_argument("--use_images", action="store_true")
    p.add_argument("--path_input_images", default=None)
    p.add_argument("--use_video", action="store_true")
    p.add_argument("--path_input_video", default=None)
    p.add_argument("--path_dcnn_data", default=None)
    p.add_argument("--path_output_results", default=None)
    p.add_argument("--path_output_images", default=None)
    p.add_argument("--batch", type=int, default=8, help="frames per device batch")
    p.add_argument("--width", type=int, default=3840)
    p.add_argument("--height", type=int, default=2160)
    p.add_argument("--display", action="store_true",
                   help="live annotated view (reference aruco_detect.py:787-800 imshow loop; 'q' quits)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default; raises when no card is visible) or cpu (plain PyTorch path)")
    return p


def _frame_reader(args):
    """Yield (k, frame_bgr_u8) respecting start/stop/step semantics."""
    import cv2

    if args.use_images:
        stop = args.stop_frame
        if stop is None:
            stop = len(os.listdir(args.path_input_images))
        k = args.start_frame
        while k <= stop:
            frame = cv2.imread(os.path.join(args.path_input_images, "image_%04d.png" % k))
            if frame is None:
                break
            yield k, frame
            k += args.step_frame
    else:
        video = cv2.VideoCapture(args.path_input_video)
        try:
            for _ in range(args.start_frame - 1):
                ret, _ = video.read()
                if not ret:
                    return
            k = args.start_frame
            stop = args.stop_frame if args.stop_frame is not None else np.inf
            while k <= stop and video.isOpened():
                ret, frame = video.read()
                if not ret:
                    break
                yield k, frame
                k += args.step_frame
                for _ in range(args.step_frame - 1):
                    ret, _ = video.read()
                    if not ret:
                        break
        finally:
            video.release()


def _annotate(frame: np.ndarray, row: dict) -> np.ndarray:
    """Draw detections + measurements onto the frame (the JAX CLI's
    annotation, the reference's printDataOnImage / drawLinesOnImage in
    spirit)."""
    import cv2

    img = frame.copy()
    font = cv2.FONT_HERSHEY_SIMPLEX
    corners = row["corners"]  # (4 slots, 4, 2) xy
    detected = row["detected"]
    centers = []
    for v in range(4):
        if not detected[v]:
            centers.append(None)
            continue
        quad = corners[v].astype(np.int32)
        cv2.polylines(img, [quad.reshape(-1, 1, 2)], True, (0, 255, 0), 2)
        c = quad.mean(axis=0).astype(int)
        centers.append(c)
        cv2.putText(img, f"id {v + 1}", tuple(c + np.array([6, -6])), font, 0.9, (0, 255, 255), 2)
    host = centers[3]
    if host is not None:
        for v in range(3):
            if centers[v] is None:
                continue
            cv2.line(img, tuple(host), tuple(centers[v]), (255, 128, 0), 2)
            mid = ((host + centers[v]) // 2).astype(int)
            cv2.putText(img, f"{row['dist_aruco'][v]:.2f} m", tuple(mid), font, 0.9, (255, 128, 0), 2)
        cv2.putText(
            img,
            f"alt {row['altitude']:.1f} m  L {row['marker_length']:.3f}  LEDs {int(row['leds'])}",
            (20, 40), font, 1.0, (255, 255, 255), 2,
        )
    return img


def _save_annotated(out_dir: str, k: int, frame: np.ndarray, row: dict) -> None:
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    cv2.imwrite(os.path.join(out_dir, f"image_{k:04d}.png"), _annotate(frame, row))


class Display:
    """The reference's live view: each annotated frame in one cv2 window;
    ``q`` asks to stop (:attr:`quit`).  cv2 is imported when the first frame
    is shown."""

    WINDOW = "aruco_detect"

    def __init__(self):
        self.quit = False
        self.cv2 = None

    def show(self, frame: np.ndarray, row: dict) -> None:
        if self.cv2 is None:
            import cv2

            self.cv2 = cv2
        self.cv2.imshow(self.WINDOW, _annotate(frame, row))
        if self.cv2.waitKey(1) & 0xFF == ord("q"):
            self.quit = True

    def close(self) -> None:
        if self.cv2 is not None:
            self.cv2.destroyAllWindows()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not args.use_images and not args.use_video:
        print("error: choose --use_images or --use_video", file=sys.stderr)
        return 2

    import torch

    from apse_uav_torch.aruco.pipeline import ArucoPipeline, ArucoPipelineConfig, init_carry
    from apse_uav_torch.core import camera
    from apse_uav_torch.device import resolve_device
    from apse_uav_torch.utils import csv_io

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = resolve_device(args.device)
    mtx, dist = camera.load_camera_params(args.path_camera_params)
    cfg = ArucoPipelineConfig(
        n_avg=args.N_avg, step_frame=args.step_frame, use_centroid_data=args.use_centroid_data,
        source_lidar=args.sourceLidar, leds_threshold=args.LEDs_threshold, led_bias_px=tuple(args.led_bias),
    )
    pipe = ArucoPipeline(mtx, dist, (args.width, args.height), cfg, device=device)
    carry = init_carry(cfg, device)
    centroid_data = csv_io.read_centroid_data(args.path_dcnn_data) if args.use_centroid_data else None
    writer = csv_io.ResultsWriter(args.path_output_results, args.use_centroid_data) if args.save_results else None
    display = Display() if args.display else None

    n_frames = 0
    first = True
    t_start = time.perf_counter()

    def run(ks, frames):
        nonlocal carry, first, n_frames
        batch = torch.from_numpy(np.stack(frames).transpose(0, 3, 1, 2).copy()).to(device)
        crows = None
        if centroid_data is not None:
            idx = np.clip(np.asarray(ks) - 1, 0, len(centroid_data) - 1)
            crows = torch.as_tensor(centroid_data[idx], dtype=torch.int32, device=device)
        carry, out = pipe.process(batch, carry, first=first, centroid_rows=crows)
        first = False
        out = {key: val.cpu().numpy() for key, val in out.items() if key != "gray"}
        for i, k in enumerate(ks):
            row = {key: val[i] for key, val in out.items()}
            if writer is not None:
                writer.write_frame(k, row)
            if args.save_images and args.path_output_images:
                _save_annotated(args.path_output_images, k, frames[i], row)
            if display is not None and not display.quit:
                display.show(frames[i], row)
        n_frames += len(ks)

    try:
        ks, frames = [], []
        for k, frame in _frame_reader(args):
            if frame.shape[:2] != (args.height, args.width):
                raise SystemExit(f"frame {k} has shape {frame.shape}, expected {(args.height, args.width)}")
            ks.append(k)
            frames.append(frame)
            if len(ks) == args.batch:
                run(ks, frames)
                ks, frames = [], []
                if display is not None and display.quit:
                    break
        else:
            if ks:
                run(ks, frames)
    finally:
        if writer is not None:
            writer.close()
        if display is not None:
            display.close()
    dt = time.perf_counter() - t_start
    print(f"processed {n_frames} frames in {dt:.2f}s ({n_frames / dt:.1f} fps)" if n_frames else "no frames processed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
