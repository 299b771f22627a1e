"""COCO-style detection/segmentation AP evaluation (pycocotools protocol).

The port's copy of the JAX reference's ``evaluation/coco_eval.py`` (numpy on
the host, the same numbers), over the port's own RLE codec.

Replaces the reference's COCOeval usage in training-time validation
(finetune_uav.py:111-154 do_test; COCO_utils.detectron2_dataset_to_coco).
Implements the standard evaluation protocol in numpy: greedy score-ordered
matching at IoU thresholds .5:.05:.95, 101-point interpolated AP, area
ranges (all/small/medium/large), maxDets (1/10/100), crowd regions as IoA.

Ground truth / detections use plain dicts:
  gt:  {"image_id", "category_id", "bbox" [x,y,w,h], "area", "iscrowd",
        optional "segmentation" RLE}
  det: {"image_id", "category_id", "bbox", "score", optional "segmentation"}
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np

from apse_uav_torch.evaluation import rle as rletools

IOU_THRS = np.round(np.arange(0.5, 1.0, 0.05), 2)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
MAX_DETS = (1, 10, 100)


def _bbox_iou(dt: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """xywh boxes: (D, 4) x (G, 4) -> (D, G); crowd gt -> IoA."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    dx1, dy1 = dt[:, 0], dt[:, 1]
    dx2, dy2 = dt[:, 0] + dt[:, 2], dt[:, 1] + dt[:, 3]
    gx1, gy1 = gt[:, 0], gt[:, 1]
    gx2, gy2 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    ix = np.maximum(
        0, np.minimum(dx2[:, None], gx2[None]) - np.maximum(dx1[:, None], gx1[None])
    )
    iy = np.maximum(
        0, np.minimum(dy2[:, None], gy2[None]) - np.maximum(dy1[:, None], gy1[None])
    )
    inter = ix * iy
    da = (dt[:, 2] * dt[:, 3])[:, None]
    ga = (gt[:, 2] * gt[:, 3])[None]
    union = np.where(iscrowd[None].astype(bool), da, da + ga - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


@dataclasses.dataclass
class CocoEvaluator:
    """Accumulates GT + detections, evaluates AP/AR summary."""

    iou_type: str = "bbox"  # or "segm"

    def __post_init__(self):
        self._gts = defaultdict(list)  # (image_id, cat) -> [gt]
        self._dts = defaultdict(list)
        self._img_cat = set()
        self._cats = set()

    def _default_area(self, obj: dict) -> float:
        # pycocotools semantics: segm eval gates area ranges on the MASK
        # area (loadRes sets dt area from the segmentation); bbox eval uses
        # w*h.  APs/APm/APl would otherwise deviate from reference numbers.
        if self.iou_type == "segm" and obj.get("segmentation") is not None:
            return float(rletools.area(obj["segmentation"]))
        return float(obj["bbox"][2] * obj["bbox"][3])

    def add_ground_truth(self, gts: list[dict]) -> None:
        for g in gts:
            if "area" not in g:
                g = {**g, "area": self._default_area(g)}
            g.setdefault("iscrowd", 0)
            key = (g["image_id"], g["category_id"])
            self._gts[key].append(g)
            self._img_cat.add(key)
            self._cats.add(g["category_id"])

    def add_detections(self, dts: list[dict]) -> None:
        for d in dts:
            if "area" not in d:
                d = {**d, "area": self._default_area(d)}
            key = (d["image_id"], d["category_id"])
            self._dts[key].append(d)
            self._img_cat.add(key)

    # -- core matching ------------------------------------------------------

    def _iou(self, dts, gts):
        if self.iou_type == "segm":
            crowd = [int(g["iscrowd"]) for g in gts]
            return rletools.iou(
                [d["segmentation"] for d in dts], [g["segmentation"] for g in gts], crowd
            )
        iscrowd = np.asarray([int(g["iscrowd"]) for g in gts])
        return _bbox_iou(
            np.asarray([d["bbox"] for d in dts], np.float64).reshape(-1, 4),
            np.asarray([g["bbox"] for g in gts], np.float64).reshape(-1, 4),
            iscrowd,
        )

    def _evaluate_img_cat(self, key, area_rng, max_det):
        gts = self._gts.get(key, [])
        dts = sorted(self._dts.get(key, []), key=lambda d: -d["score"])[:max_det]
        if not gts and not dts:
            return None
        g_ignore = np.asarray(
            [g["iscrowd"] or not (area_rng[0] <= g["area"] < area_rng[1]) for g in gts],
            bool,
        )
        # Sort gt: non-ignored first (pycocotools order).
        g_order = np.argsort(g_ignore, kind="stable")
        gts = [gts[i] for i in g_order]
        g_ignore = g_ignore[g_order]
        iou = self._iou(dts, gts)
        iou = iou[:, g_order] if len(dts) and len(gts) else iou
        t = len(IOU_THRS)
        d = len(dts)
        g = len(gts)
        dt_match = np.zeros((t, d), np.int64)  # matched gt index + 1, 0 = none
        gt_match = np.zeros((t, g), np.int64)
        dt_ignore = np.zeros((t, d), bool)
        for ti, thr in enumerate(IOU_THRS):
            for di in range(d):
                best = min(thr, 1 - 1e-10)
                m = -1
                for gi in range(g):
                    if gt_match[ti, gi] and not gts[gi]["iscrowd"]:
                        continue
                    # Stop at ignored gt if a real match was already found.
                    if m > -1 and not g_ignore[m] and g_ignore[gi]:
                        break
                    if iou[di, gi] < best:
                        continue
                    best = iou[di, gi]
                    m = gi
                if m == -1:
                    continue
                dt_match[ti, di] = m + 1
                gt_match[ti, m] = di + 1
                dt_ignore[ti, di] = g_ignore[m]
        # Unmatched detections outside the area range are ignored (mask area
        # in segm mode — see _default_area).
        d_area_out = np.asarray(
            [not (area_rng[0] <= d_["area"] < area_rng[1]) for d_ in dts],
            bool,
        )
        dt_ignore |= (dt_match == 0) & d_area_out[None]
        return {
            "scores": np.asarray([d_["score"] for d_ in dts]),
            "dt_match": dt_match,
            "dt_ignore": dt_ignore,
            "num_gt": int((~g_ignore).sum()),
        }

    def _accumulate(self, cat, area_rng, max_det):
        evals = []
        for key in self._img_cat:
            if key[1] != cat:
                continue
            e = self._evaluate_img_cat(key, area_rng, max_det)
            if e is not None:
                evals.append(e)
        if not evals:
            return None, None
        num_gt = sum(e["num_gt"] for e in evals)
        if num_gt == 0:
            return None, None
        scores = np.concatenate([e["scores"] for e in evals])
        order = np.argsort(-scores, kind="mergesort")
        t = len(IOU_THRS)
        tps = np.concatenate([(e["dt_match"] > 0) & ~e["dt_ignore"] for e in evals], axis=1)[:, order]
        fps = np.concatenate([(e["dt_match"] == 0) & ~e["dt_ignore"] for e in evals], axis=1)[:, order]
        tp_cum = np.cumsum(tps, axis=1)
        fp_cum = np.cumsum(fps, axis=1)
        precision = np.zeros((t, len(REC_THRS)))
        recall = np.zeros(t)
        for ti in range(t):
            tp, fp = tp_cum[ti], fp_cum[ti]
            rc = tp / num_gt
            pr = tp / np.maximum(tp + fp, 1e-12)
            recall[ti] = rc[-1] if len(rc) else 0.0
            # Monotone precision envelope + 101-point interpolation.
            pr = np.maximum.accumulate(pr[::-1])[::-1]
            inds = np.searchsorted(rc, REC_THRS, side="left")
            for ri, pi in enumerate(inds):
                if pi < len(pr):
                    precision[ti, ri] = pr[pi]
        return precision, recall

    def summarize(self) -> dict[str, float]:
        """COCO 12-metric summary (AP, AP50, AP75, APs/m/l, AR1/10/100, ARs/m/l)."""
        cats = sorted(self._cats)
        p_all: dict[tuple, np.ndarray] = {}
        r_all: dict[tuple, np.ndarray] = {}
        for cat in cats:
            for area in AREA_RANGES:
                for md in MAX_DETS:
                    p, r = self._accumulate(cat, AREA_RANGES[area], md)
                    if p is not None:
                        p_all[(cat, area, md)] = p
                        r_all[(cat, area, md)] = r

        def mean_p(area, md, thr=None):
            vals = []
            for cat in cats:
                p = p_all.get((cat, area, md))
                if p is None:
                    continue
                vals.append(p.mean() if thr is None else p[np.isclose(IOU_THRS, thr)].mean())
            return float(np.mean(vals)) if vals else -1.0

        def mean_r(area, md):
            vals = [r_all[(c, area, md)].mean() for c in cats if (c, area, md) in r_all]
            return float(np.mean(vals)) if vals else -1.0

        return {
            "AP": mean_p("all", 100),
            "AP50": mean_p("all", 100, 0.5),
            "AP75": mean_p("all", 100, 0.75),
            "APs": mean_p("small", 100),
            "APm": mean_p("medium", 100),
            "APl": mean_p("large", 100),
            "AR1": mean_r("all", 1),
            "AR10": mean_r("all", 10),
            "AR100": mean_r("all", 100),
            "ARs": mean_r("small", 100),
            "ARm": mean_r("medium", 100),
            "ARl": mean_r("large", 100),
        }
