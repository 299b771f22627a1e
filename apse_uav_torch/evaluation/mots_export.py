"""Tracker output -> MOTS results (txt lines / uint16 PNGs), host side.

Equivalent of the reference's dcnn/utils/mots_evaluation.py: COCO->MOTS
class remap (:31-36), id = class_id * 1000 + track_id (:51), RLE txt lines
(:25-55), uint16 id images (:58-77), and disjoint-mask enforcement by
cropping lower-scoring overlaps (:97-123).

The port's copy of the JAX reference's ``evaluation/mots_export.py``.  Input
is the tracker's fixed-capacity "recent objects" snapshot
(``apse_uav_torch.dcnn.structures.recent_objects``, as numpy) whose masks are
(R, R) box-space probabilities; they are pasted to full resolution here.
"""

from __future__ import annotations

import numpy as np

from apse_uav_torch.evaluation import rle as rletools

# detectron2 COCO ids: 0 = person, 2 = car  ->  MOTS: car = 1, pedestrian = 2.
COCO_TO_MOTS = {2: 1, 0: 2}


def paste_mask_np(mask_rr: np.ndarray, box: np.ndarray, image_hw: tuple[int, int], thresh: float = 0.5) -> np.ndarray:
    """Paste one (R, R) box-space mask into a full (H, W) bool image."""
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


def crop_overlapping_masks(masks: list[np.ndarray], scores: list[float]) -> list[np.ndarray]:
    """Make masks disjoint: higher score wins overlaps (mots_evaluation.py:97-123)."""
    order = np.argsort(-np.asarray(scores))
    occupied = None
    out: list[np.ndarray | None] = [None] * len(masks)
    for i in order:
        m = masks[i].copy()
        if occupied is not None:
            m &= ~occupied
            occupied = occupied | m
        else:
            occupied = m.copy()
        out[i] = m
    return out  # type: ignore[return-value]


def _full_masks(recent: dict, image_hw: tuple[int, int]):
    valid = np.asarray(recent["valid"]).astype(bool)
    idxs = np.nonzero(valid)[0]
    masks = [
        paste_mask_np(np.asarray(recent["masks"][i]), np.asarray(recent["boxes"][i]), image_hw)
        for i in idxs
    ]
    scores = [float(recent["scores"][i]) for i in idxs]
    masks = crop_overlapping_masks(masks, scores)
    return idxs, masks


def file_lines_from_recent(recent: dict, frame: int, image_hw: tuple[int, int]) -> list[str]:
    """One frame's tracker snapshot -> MOTS txt lines."""
    idxs, masks = _full_masks(recent, image_hw)
    lines = []
    for i, mask in zip(idxs, masks):
        coco_class = int(recent["classes"][i])
        if coco_class not in COCO_TO_MOTS:
            continue
        mots_class = COCO_TO_MOTS[coco_class]
        obj_id = mots_class * 1000 + int(recent["ids"][i])
        r = rletools.encode(mask.astype(np.uint8))
        counts = r["counts"].decode() if isinstance(r["counts"], bytes) else r["counts"]
        lines.append(f"{frame} {obj_id} {mots_class} {image_hw[0]} {image_hw[1]} {counts}")
    return lines


def result_image_from_recent(recent: dict, image_hw: tuple[int, int]) -> np.ndarray:
    """One frame's tracker snapshot -> uint16 id image."""
    out = np.zeros(image_hw, np.uint16)
    idxs, masks = _full_masks(recent, image_hw)
    for i, mask in zip(idxs, masks):
        coco_class = int(recent["classes"][i])
        if coco_class not in COCO_TO_MOTS:
            continue
        obj_id = COCO_TO_MOTS[coco_class] * 1000 + int(recent["ids"][i])
        out[mask] = obj_id
    return out


def parse_mots_seqmap(path: str):
    """(seq names, {seq: max frame}) — mots_evaluation.py:80-94."""
    from apse_uav_torch.evaluation.mots import load_seqmap

    return load_seqmap(path)
