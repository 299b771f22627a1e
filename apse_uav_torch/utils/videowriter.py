"""PNG-directory -> video assembly (dcnn/utils/videowriter.py equivalent).

The port's copy of the JAX reference's ``utils/videowriter.py``:
natural-sorted frame ordering (videowriter.py:12-18); writes AVI/MP4 via
cv2, imported only when a video is written.  Exposed as a function (the
original runs on import, :39)."""

from __future__ import annotations

import os
import re


def natural_sort(names: list[str]) -> list[str]:
    def key(s):
        return [int(t) if t.isdigit() else t.lower() for t in re.split(r"(\d+)", s)]

    return sorted(names, key=key)


def write_video(image_dir: str, out_path: str, fps: float = 30.0, ext: str = ".png") -> int:
    """Assemble all ``ext`` frames in ``image_dir`` into a video; returns frame count."""
    import cv2

    names = natural_sort([f for f in os.listdir(image_dir) if f.endswith(ext)])
    if not names:
        raise FileNotFoundError(f"no {ext} frames in {image_dir}")
    first = cv2.imread(os.path.join(image_dir, names[0]))
    h, w = first.shape[:2]
    fourcc = cv2.VideoWriter_fourcc(*("mp4v" if out_path.endswith(".mp4") else "DIVX"))
    writer = cv2.VideoWriter(out_path, fourcc, fps, (w, h))
    for name in names:
        writer.write(cv2.imread(os.path.join(image_dir, name)))
    writer.release()
    return len(names)
