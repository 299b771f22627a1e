"""Mask geometry for the DCNN CSV: centroids, closest points, aligned IoU.

The port's own copy of the JAX reference's ``utils/mask_geometry.py`` (host
numpy, the reference's conventions: pixel coordinates are 1-indexed,
centroids use floor division), with :func:`paste_mask_np` (the reference's
``evaluation/mots_export.paste_mask_np``) beside it: the tracker's compact
(R, R) masks are pasted at full resolution before these functions see them.
"""

from __future__ import annotations

import numpy as np


def paste_mask_np(mask_rr: np.ndarray, box: np.ndarray, image_hw: tuple[int, int], thresh: float = 0.5) -> np.ndarray:
    """Paste one (R, R) box-space mask into a full (H, W) bool image (nearest cell)."""
    h, w = image_hw
    r = mask_rr.shape[0]
    x1, y1, x2, y2 = box
    out = np.zeros((h, w), bool)
    ix1, iy1 = max(int(np.floor(x1)), 0), max(int(np.floor(y1)), 0)
    ix2, iy2 = min(int(np.ceil(x2)), w), min(int(np.ceil(y2)), h)
    if ix2 <= ix1 or iy2 <= iy1:
        return out
    xs = (np.arange(ix1, ix2) + 0.5 - x1) / max(x2 - x1, 1e-4) * r - 0.5
    ys = (np.arange(iy1, iy2) + 0.5 - y1) / max(y2 - y1, 1e-4) * r - 0.5
    xi = np.clip(np.round(xs).astype(int), 0, r - 1)
    yi = np.clip(np.round(ys).astype(int), 0, r - 1)
    out[iy1:iy2, ix1:ix2] = mask_rr[np.ix_(yi, xi)] >= thresh
    return out


def get_mask_centroid(mask: np.ndarray) -> tuple[float, float]:
    """Mass centroid (x, y), 1-indexed, floor-divided (mask_utils.py:27-38)."""
    ys, xs = np.nonzero(mask)
    mass = len(xs)
    if mass == 0:
        return (0.0, 0.0)
    x = float((xs + 1).sum() // mass)
    y = float((ys + 1).sum() // mass)
    return (x, y)


def compute_closest_point(mask: np.ndarray, point: tuple[float, float]) -> tuple[float, float]:
    """Closest 1-indexed mask pixel to ``point`` (mask_utils.py:6-23)."""
    ys, xs = np.nonzero(mask)
    if len(xs) == 0:
        return (float("nan"), float("nan"))
    xs1 = xs + 1.0
    ys1 = ys + 1.0
    d = (xs1 - point[0]) ** 2 + (ys1 - point[1]) ** 2
    i = int(np.argmin(d))
    return (float(xs1[i]), float(ys1[i]))


def translate_and_crop_mask(mask: np.ndarray, translation: tuple[int, int]) -> np.ndarray:
    """Shift a mask by (dx, dy), zero-filling (mask_utils.py:57-77)."""
    h, w = mask.shape
    dx, dy = int(translation[0]), int(translation[1])
    out = np.zeros_like(mask)
    src_x = slice(max(0, -dx), min(w, w - dx))
    src_y = slice(max(0, -dy), min(h, h - dy))
    dst_x = slice(max(0, dx), min(w, w + dx))
    dst_y = slice(max(0, dy), min(h, h + dy))
    out[dst_y, dst_x] = mask[src_y, src_x]
    return out


def compute_masks_iou(
    detection_mask: np.ndarray, object_mask: np.ndarray, detection_centroid=None
) -> float:
    """Centroid-aligned IoU (mask_utils.py:41-54, with the latent ``self.``
    bug fixed as the evident intent)."""
    object_centroid = get_mask_centroid(object_mask)
    if detection_centroid is None:
        detection_centroid = get_mask_centroid(detection_mask)
    translation = (
        object_centroid[0] - detection_centroid[0],
        object_centroid[1] - detection_centroid[1],
    )
    moved = translate_and_crop_mask(detection_mask, translation)
    inter = (moved & object_mask).sum()
    union = (moved | object_mask).sum()
    return float(inter) / float(union) if union else 0.0


# ---------------------------------------------------------------------------
# DCNN comparison CSV (visualize_uav.py:117-141,223-233)
# ---------------------------------------------------------------------------


def dcnn_log_line(recent: dict, host_id: int, frame_idx: int, image_hw: tuple[int, int]) -> tuple[str, int]:
    """One tracker snapshot -> one CSV row (generate_log_oneline semantics).

    Columns per track id 1..highest: cent_x, cent_y, clos_x, clos_y where
    clos_* is the mask point closest to the host vehicle's centroid.
    """
    valid = np.asarray(recent["valid"]).astype(bool)
    idxs = np.nonzero(valid)[0]
    if len(idxs) == 0:
        return "", 0
    ids = [int(recent["ids"][i]) for i in idxs]
    masks = [
        paste_mask_np(np.asarray(recent["masks"][i]), np.asarray(recent["boxes"][i]), image_hw)
        for i in idxs
    ]
    centroids = [get_mask_centroid(m) for m in masks]
    if host_id in ids:
        host_centroid = centroids[ids.index(host_id)]
        closest = [compute_closest_point(m, host_centroid) for m in masks]
    else:
        closest = [("nan", "nan")] * len(ids)
    parts = [str(frame_idx)]
    highest = max(ids)
    for ob_id in range(1, highest + 1):
        if ob_id in ids:
            k = ids.index(ob_id)
            cx, cy = closest[k]
            parts += [
                str(int(centroids[k][0])),
                str(int(centroids[k][1])),
                # Ints like the shipped data CSVs (the consumer,
                # readCentroidData at aruco_detect.py:118, does int()).
                "nan" if isinstance(cx, str) or np.isnan(cx) else str(int(cx)),
                "nan" if isinstance(cy, str) or np.isnan(cy) else str(int(cy)),
            ]
        else:
            parts += [""] * 4
    return ",".join(parts), highest


def write_dcnn_log(path: str, lines: list[str], host_id: int, max_obj_id: int) -> None:
    """Write the reference log format: ``Ford id:`` line + header + rows
    (visualize_uav.py:223-233)."""
    header = "frame"
    for i in range(1, max_obj_id + 1):
        header += f",id_{i} cent_x,id_{i} cent_y,id_{i} clos_x,id_{i} clos_y"
    with open(path, "w") as f:
        f.write(f"Ford id: {host_id}\n")
        f.write(header + "\n")
        f.write("\n".join(lines))
