"""MOTS (multi-object tracking & segmentation) data formats and metrics.

The port's copy of the JAX reference's ``evaluation/mots.py`` (itself a
fresh implementation of the original's vendored mots_tools): the txt/PNG
data formats (mots_common/io.py), the CLEAR-MOT-style metric suite
(mots_eval/MOTS_metrics.py -- sMOTSA, MOTSA, MOTSP, MOTSAL, MODSA, MODSP,
recall/precision/F1/FAR, MT/PT/ML, id switches, fragments), and the seqmap
evaluation loop (mots_eval/eval.py).  Mask operations run on the port's numpy RLE
codec (:mod:`apse_uav_torch.evaluation.rle`); PIL is imported only where a
PNG is read.

Formats (KITTI-MOTS):
* txt line: ``frame track_id class_id img_h img_w rle_string``
* PNG: uint16 id images, pixel = class_id * 1000 + instance (id 10000 =
  ignore region)
"""

from __future__ import annotations

import dataclasses
import glob
import math
import os
from collections import defaultdict
from typing import Callable

import numpy as np

from apse_uav_torch.evaluation import rle as rletools

CLASS_CAR = 1
CLASS_PEDESTRIAN = 2
IGNORE_CLASS = 10


@dataclasses.dataclass
class SegmentedObject:
    mask: dict  # RLE
    class_id: int
    track_id: int


# ---------------------------------------------------------------------------
# I/O (mots_common/io.py)
# ---------------------------------------------------------------------------


def load_txt(path: str) -> dict[int, list[SegmentedObject]]:
    """Parse a MOTS txt file -> {frame: [SegmentedObject]}.

    Enforces the format invariants the reference asserts (io.py:45-58):
    unique ids per frame and non-overlapping masks.
    """
    objects_per_frame: dict[int, list[SegmentedObject]] = {}
    track_ids_per_frame: dict[int, set[int]] = {}
    combined_mask_per_frame: dict[int, dict] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            fields = line.split(" ")
            frame = int(fields[0])
            track_id = int(fields[1])
            if frame not in track_ids_per_frame:
                track_ids_per_frame[frame] = set()
            if track_id in track_ids_per_frame[frame]:
                raise AssertionError(f"multiple objects with track id {track_id} in frame {frame}")
            track_ids_per_frame[frame].add(track_id)
            class_id = int(fields[2])
            if class_id not in (CLASS_CAR, CLASS_PEDESTRIAN, IGNORE_CLASS):
                raise AssertionError("unknown object class " + fields[2])
            mask = {"size": [int(fields[3]), int(fields[4])], "counts": fields[5].encode()}
            if frame not in objects_per_frame:
                objects_per_frame[frame] = []
            if frame not in combined_mask_per_frame:
                combined_mask_per_frame[frame] = mask
            else:
                overlap = rletools.area(
                    rletools.merge([combined_mask_per_frame[frame], mask], intersect=True)
                )
                if overlap > 0:
                    raise AssertionError(f"objects with overlapping masks in frame {frame}")
                combined_mask_per_frame[frame] = rletools.merge(
                    [combined_mask_per_frame[frame], mask]
                )
            objects_per_frame[frame].append(SegmentedObject(mask, class_id, track_id))
    return objects_per_frame


def load_image(path: str, id_divisor: int = 1000) -> list[SegmentedObject]:
    """uint16 id-image -> objects (io.py:87-105)."""
    from PIL import Image

    img = np.array(Image.open(path))
    objects = []
    for oid in np.unique(img):
        if oid == 0:
            continue
        class_id = int(oid) // id_divisor
        mask = rletools.encode((img == oid).astype(np.uint8))
        objects.append(SegmentedObject(mask, class_id, int(oid)))
    return objects


def load_images_for_folder(path: str) -> dict[int, list[SegmentedObject]]:
    files = sorted(glob.glob(os.path.join(path, "*.png")))
    return {int(os.path.basename(f).split(".")[0]): load_image(f) for f in files}


def load_seqmap(path: str) -> tuple[list[str], dict[str, int]]:
    """seqmap lines: ``name empty start end`` (io.py:108-118)."""
    seq_names, max_frames = [], {}
    with open(path) as f:
        for line in f:
            fields = line.strip().split(" ")
            if not fields[0]:
                continue
            seq = "%04d" % int(fields[0])
            seq_names.append(seq)
            max_frames[seq] = int(fields[3])
    return seq_names, max_frames


def load_sequences(path: str, seq_names: list[str]) -> dict[str, dict[int, list[SegmentedObject]]]:
    out = {}
    for seq in seq_names:
        seq_path_txt = os.path.join(path, seq + ".txt")
        seq_path_dir = os.path.join(path, seq)
        if os.path.exists(seq_path_txt):
            out[seq] = load_txt(seq_path_txt)
        elif os.path.isdir(seq_path_dir):
            out[seq] = load_images_for_folder(seq_path_dir)
        else:
            raise FileNotFoundError(f"no data for sequence {seq} under {path}")
    return out


def write_sequences(gt: dict[str, dict[int, list[SegmentedObject]]], out_folder: str) -> None:
    os.makedirs(out_folder, exist_ok=True)
    for seq, frames in gt.items():
        with open(os.path.join(out_folder, seq + ".txt"), "w") as f:
            for frame in sorted(frames):
                for obj in frames[frame]:
                    h, w = obj.mask["size"]
                    counts = obj.mask["counts"]
                    if isinstance(counts, bytes):
                        counts = counts.decode()
                    print(frame, obj.track_id, obj.class_id, h, w, counts, file=f)


def images_to_txt(input_folder: str, output_folder: str) -> None:
    """PNG GT tree -> txt RLE files (mots_common/images_to_txt.py)."""
    seqs = sorted(os.listdir(input_folder))
    gt = {seq: load_images_for_folder(os.path.join(input_folder, seq)) for seq in seqs}
    write_sequences(gt, output_folder)


# ---------------------------------------------------------------------------
# Metrics (mots_eval/MOTS_metrics.py)
# ---------------------------------------------------------------------------

_COUNT_FIELDS = (
    "n_gt n_tr n_itr tp fp fn total_cost id_switches fragments "
    "MT PT ML n_gt_trajectories n_tr_trajectories total_num_frames MODSP"
).split()

_METRIC_ORDER = [
    ("sMOTSA", "sMOTSA"), ("MOTSA", "MOTSA"), ("MOTSP", "MOTSP"),
    ("MOTSAL", "MOTSAL"), ("MODSA", "MODSA"), ("MODSP", "MODSP"),
    ("Recall", "recall"), ("Prec", "precision"), ("F1", "F1"), ("FAR", "FAR"),
    ("MT", "MT"), ("PT", "PT"), ("ML", "ML"),
    ("TP", "tp"), ("FP", "fp"), ("FN", "fn"),
    ("IDS", "id_switches"), ("Frag", "fragments"),
    ("GT Obj", "n_gt"), ("GT Trk", "n_gt_trajectories"),
    ("TR Obj", "n_tr"), ("TR Trk", "n_tr_trajectories"), ("Ig TR Tck", "n_itr"),
]


def mask_iou(a: SegmentedObject, b: SegmentedObject, criterion: str = "union") -> float:
    is_crowd = criterion != "union"
    return float(rletools.iou([a.mask], [b.mask], [int(is_crowd)])[0][0])


def _eval_sequence(
    gt_frames: dict[int, list[SegmentedObject]],
    res_frames: dict[int, list[SegmentedObject]],
    max_frame: int,
    class_id: int,
    overlap_function: Callable = mask_iou,
) -> dict:
    r = {k: 0 for k in _COUNT_FIELDS}
    r["total_num_frames"] = max_frame + 1
    trajectories: dict[int, list[int]] = defaultdict(list)
    gt_track_ids: set[int] = set()
    tr_track_ids: set[int] = set()

    for f in range(max_frame + 1):
        gts = [o for o in gt_frames.get(f, []) if o.class_id == class_id]
        ignores = [o for o in gt_frames.get(f, []) if o.class_id == IGNORE_CLASS]
        dets = [o for o in res_frames.get(f, []) if o.class_id == class_id]
        gt_track_ids.update(o.track_id for o in gts)
        tr_track_ids.update(o.track_id for o in dets)
        r["n_gt"] += len(gts)
        r["n_tr"] += len(dets)

        for g in gts:
            trajectories[g.track_id].append(-1)

        # Associate: each gt takes the (at most one, masks disjoint) detection
        # with IoU > 0.5.
        det_matched = [False] * len(dets)
        frame_tp = 0
        frame_cost = 0.0
        for g in gts:
            for col, d in enumerate(dets):
                c = overlap_function(g, d)
                if c > 0.5:
                    det_matched[col] = True
                    r["total_cost"] += c
                    frame_cost += c
                    trajectories[g.track_id][-1] = d.track_id
                    r["tp"] += 1
                    frame_tp += 1

        # Unmatched detections overlapping the ignore region don't count.
        n_ignored_tracker = 0
        if ignores:
            ignore_region = SegmentedObject(
                rletools.merge([o.mask for o in ignores]), IGNORE_CLASS, IGNORE_CLASS
            )
            for matched, d in zip(det_matched, dets):
                if not matched and overlap_function(d, ignore_region, "a") > 0.5:
                    n_ignored_tracker += 1
        r["n_itr"] += n_ignored_tracker
        frame_fn = len(gts) - frame_tp
        frame_fp = len(dets) - frame_tp - n_ignored_tracker
        r["fn"] += frame_fn
        r["fp"] += frame_fp
        assert frame_fn >= 0 and frame_fp >= 0, "inconsistent TP/FP/FN accounting"
        assert frame_tp + frame_fn == len(gts)
        assert frame_tp + frame_fp + n_ignored_tracker == len(dets)
        r["MODSP"] += frame_cost / frame_tp if frame_tp else 1.0

    r["n_gt_trajectories"] = len(gt_track_ids)
    r["n_tr_trajectories"] = len(tr_track_ids)

    # MT/PT/ML, id switches, fragments over gt trajectories.
    for g in trajectories.values():
        if all(x == -1 for x in g):
            r["ML"] += 1
            continue
        last_id = g[0]
        tracked = 1 if g[0] >= 0 else 0
        f = 0
        for f in range(1, len(g)):
            if last_id != g[f] and last_id != -1 and g[f] != -1:
                r["id_switches"] += 1
            if f < len(g) - 1 and g[f - 1] != g[f] and last_id != -1 and g[f] != -1 and g[f + 1] != -1:
                r["fragments"] += 1
            if g[f] != -1:
                tracked += 1
                last_id = g[f]
        if len(g) > 1 and g[f - 1] != g[f] and last_id != -1 and g[f] != -1:
            r["fragments"] += 1
        ratio = tracked / len(g)
        if ratio > 0.8:
            r["MT"] += 1
        elif ratio < 0.2:
            r["ML"] += 1
        else:
            r["PT"] += 1
    return r


def _derive(r: dict) -> dict:
    out = dict(r)
    tp, fp, fn = r["tp"], r["fp"], r["fn"]
    if (fp + tp) == 0 or (tp + fn) == 0:
        out["recall"] = out["precision"] = 0.0
    else:
        out["recall"] = tp / (tp + fn)
        out["precision"] = tp / (tp + fp)
    pr = out["precision"] + out["recall"]
    out["F1"] = 2 * out["precision"] * out["recall"] / pr if pr else 0.0
    out["FAR"] = fp / r["total_num_frames"] if r["total_num_frames"] else float("nan")
    n_gt = r["n_gt"]
    if n_gt == 0:
        out["MOTSA"] = out["MODSA"] = out["sMOTSA"] = out["MOTSAL"] = -float("inf")
    else:
        out["MOTSA"] = 1 - (fn + fp + r["id_switches"]) / n_gt
        out["MODSA"] = 1 - (fn + fp) / n_gt
        out["sMOTSA"] = (r["total_cost"] - fp - r["id_switches"]) / n_gt
        ids_term = math.log10(r["id_switches"]) if r["id_switches"] else r["id_switches"]
        out["MOTSAL"] = 1 - (fn + fp + ids_term) / n_gt
    out["MOTSP"] = r["total_cost"] / tp if tp else float("inf")
    out["MODSP"] = r["MODSP"] / r["total_num_frames"] if r["total_num_frames"] else float("nan")
    n_traj = r["n_gt_trajectories"]
    for k in ("MT", "PT", "ML"):
        out[k] = r[k] / n_traj if n_traj else 0.0
    return out


def compute_mots_metrics(
    gt: dict[str, dict[int, list[SegmentedObject]]],
    results: dict[str, dict[int, list[SegmentedObject]]],
    max_frames: dict[str, int],
    class_id: int,
    overlap_function: Callable = mask_iou,
) -> tuple[dict[str, dict], dict]:
    """Per-sequence + aggregate MOTS metrics for one class."""
    per_seq_counts = {
        seq: _eval_sequence(gt[seq], results.get(seq, {}), max_frames[seq], class_id, overlap_function)
        for seq in gt
    }
    total = {k: sum(c[k] for c in per_seq_counts.values()) for k in _COUNT_FIELDS}
    per_seq = {seq: _derive(c) for seq, c in per_seq_counts.items()}
    return per_seq, _derive(total)


def format_summary(per_seq: dict[str, dict], total: dict) -> str:
    names = [n for n, _ in _METRIC_ORDER]
    widths = [max(len(n), 4) + 2 for n in names]
    lines = ["".join(["    "] + [f"{n:>{w}}" for n, w in zip(names, widths)])]

    def fmt(v):
        if isinstance(v, float):
            return f"{v:.4g}" if math.isfinite(v) else "n/a"
        return str(v)

    for seq, res in list(per_seq.items()) + [("all", total)]:
        row = [f"{seq:>4}"] + [f"{fmt(res[k]):>{w}}" for (_, k), w in zip(_METRIC_ORDER, widths)]
        lines.append("".join(row))
    return "\n".join(lines)


def run_eval(results_folder: str, gt_folder: str, seqmap_path: str) -> dict[str, dict]:
    """mots_eval/eval.py equivalent: evaluate cars and pedestrians."""
    seq_names, max_frames = load_seqmap(seqmap_path)
    gt = load_sequences(gt_folder, seq_names)
    results = load_sequences(results_folder, seq_names)
    out = {}
    for name, cid in (("car", CLASS_CAR), ("pedestrian", CLASS_PEDESTRIAN)):
        print(f"Evaluate class: {name}")
        per_seq, total = compute_mots_metrics(gt, results, max_frames, cid)
        print(format_summary(per_seq, total))
        out[name] = total
    return out
