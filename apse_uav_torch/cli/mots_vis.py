"""Render MOTS tracking results over frames, on the PyTorch port (mots_vis/visualize_mots.py).

Blends per-track coloured masks into each frame and optionally assembles an
mp4 (PIL to read and write frames, cv2 for the video; both imported only
here).  Usage:
    python -m apse_uav_torch.cli.mots_vis tracks_folder img_folder out_folder seqmap [--mp4]
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def _color(track_id: int) -> np.ndarray:
    rng = np.random.default_rng(track_id * 7919)
    return rng.integers(60, 255, 3).astype(np.uint8)


def process_sequence(seq: str, tracks_folder: str, img_folder: str, out_folder: str, max_frame: int) -> None:
    from PIL import Image

    from apse_uav_torch.evaluation import rle as rletools
    from apse_uav_torch.evaluation.mots import load_txt

    frames = load_txt(os.path.join(tracks_folder, seq + ".txt"))
    seq_img = os.path.join(img_folder, seq)
    out_dir = os.path.join(out_folder, seq)
    os.makedirs(out_dir, exist_ok=True)
    for f in range(max_frame + 1):
        src = os.path.join(seq_img, f"{f:06d}.png")
        if not os.path.exists(src):
            src = os.path.join(seq_img, f"{f:06d}.jpg")
        if not os.path.exists(src):
            continue
        img = np.asarray(Image.open(src).convert("RGB")).copy()
        for obj in frames.get(f, []):
            if obj.class_id > 2:
                continue
            m = rletools.decode(obj.mask).astype(bool)
            img[m] = (img[m] * 0.6 + _color(obj.track_id) * 0.4).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(out_dir, f"{f:06d}.png"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("tracks_folder")
    p.add_argument("img_folder")
    p.add_argument("output_folder")
    p.add_argument("seqmap_filename")
    p.add_argument("--mp4", action="store_true", help="also assemble <seq>.mp4")
    args = p.parse_args(argv)
    from apse_uav_torch.evaluation.mots import load_seqmap

    seq_names, max_frames = load_seqmap(args.seqmap_filename)
    for seq in seq_names:
        process_sequence(seq, args.tracks_folder, args.img_folder, args.output_folder, max_frames[seq])
        if args.mp4:
            from apse_uav_torch.utils.videowriter import write_video

            write_video(
                os.path.join(args.output_folder, seq),
                os.path.join(args.output_folder, seq + ".mp4"),
                fps=10.0,
            )
        print(f"visualized {seq}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
