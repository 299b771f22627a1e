"""PyTorch port, the COCO evaluator against the JAX package's.

The port's ``evaluation/coco_eval.py`` is a numpy copy over the port's RLE
codec: on the JAX tests' scenarios (``tests/test_coco_eval.py``) and on
random detections, box and mask IoU, its 12 summary numbers equal the
reference's exactly.
"""

import numpy as np
import pytest

from apse_uav_tpu.evaluation import rle as jrle
from apse_uav_tpu.evaluation.coco_eval import CocoEvaluator as JCocoEvaluator
from apse_uav_torch.evaluation import rle as trle
from apse_uav_torch.evaluation.coco_eval import CocoEvaluator


def _gt(img, cat, box, **kw):
    return {"image_id": img, "category_id": cat, "bbox": list(box), **kw}


def _dt(img, cat, box, score):
    return {"image_id": img, "category_id": cat, "bbox": list(box), "score": score}


SCENARIOS = {
    "perfect": ([_gt(0, 1, [10, 10, 40, 40]), _gt(1, 1, [5, 5, 50, 60])],
                [_dt(0, 1, [10, 10, 40, 40], 0.9), _dt(1, 1, [5, 5, 50, 60], 0.8)]),
    "miss": ([_gt(0, 1, [10, 10, 40, 40]), _gt(0, 1, [100, 100, 40, 40])], [_dt(0, 1, [10, 10, 40, 40], 0.9)]),
    "false_positive": ([_gt(0, 1, [10, 10, 40, 40])],
                       [_dt(0, 1, [200, 200, 40, 40], 0.95), _dt(0, 1, [10, 10, 40, 40], 0.9)]),
    "localization": ([_gt(0, 1, [0, 0, 100, 100])], [_dt(0, 1, [0, 0, 100, 60], 0.9)]),
    "crowd": ([_gt(0, 1, [10, 10, 40, 40]), _gt(0, 1, [100, 100, 200, 200], iscrowd=1)],
              [_dt(0, 1, [10, 10, 40, 40], 0.9), _dt(0, 1, [120, 120, 60, 60], 0.8)]),
    "area_ranges": ([_gt(0, 1, [0, 0, 16, 16]), _gt(0, 1, [50, 50, 200, 200])],
                    [_dt(0, 1, [0, 0, 16, 16], 0.9), _dt(0, 1, [50, 50, 200, 200], 0.8)]),
}


def _both(gts, dts, iou_type="bbox", masks=None):
    out = []
    for cls, rle in ((JCocoEvaluator, jrle), (CocoEvaluator, trle)):
        ev = cls(iou_type=iou_type)
        if masks is None:
            ev.add_ground_truth([dict(g) for g in gts])
            ev.add_detections([dict(d) for d in dts])
        else:
            gm, dm = masks
            ev.add_ground_truth([{**g, "segmentation": rle.encode(m)} for g, m in zip(gts, gm)])
            ev.add_detections([{**d, "segmentation": rle.encode(m)} for d, m in zip(dts, dm)])
        out.append(ev.summarize())
    return out


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenarios_equal_jax(name):
    want, got = _both(*SCENARIOS[name])
    assert got == want


def _random_case(seed, n_img=5, n_cat=3):
    rng = np.random.default_rng(seed)
    gts, dts = [], []
    for img in range(n_img):
        for _ in range(rng.integers(0, 6)):
            x, y = rng.uniform(0, 150, 2)
            w, h = rng.uniform(4, 120, 2)
            gts.append(_gt(img, int(rng.integers(n_cat)), [x, y, w, h], iscrowd=int(rng.uniform() < 0.1)))
            if rng.uniform() < 0.8:  # a detection near it
                j = rng.normal(0, 0.15, 4) * [w, h, w, h]
                dts.append(_dt(img, int(gts[-1]["category_id"]), [x + j[0], y + j[1], w + j[2], h + j[3]],
                               float(rng.uniform())))
        for _ in range(rng.integers(0, 4)):  # false positives
            dts.append(_dt(img, int(rng.integers(n_cat)), list(rng.uniform(0, 150, 2)) + list(rng.uniform(4, 60, 2)),
                           float(rng.uniform())))
    return gts, dts


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_boxes_equal_jax(seed):
    want, got = _both(*_random_case(seed))
    assert got == want


def test_random_masks_equal_jax():
    """segm IoU through each package's RLE codec (mask areas gate the ranges)."""
    rng = np.random.default_rng(9)
    gts, dts, gm, dm = [], [], [], []
    for img in range(3):
        for k in range(4):
            m = np.zeros((80, 120), np.uint8)
            y, x = rng.integers(0, 60), rng.integers(0, 90)
            m[y:y + rng.integers(5, 20), x:x + rng.integers(5, 30)] = 1
            d = m.copy()
            d[:, x + 2:x + 4] = 0
            gts.append(_gt(img, k % 2, [x, y, 10, 10]))
            dts.append(_dt(img, k % 2, [x, y, 10, 10], float(rng.uniform())))
            gm.append(m)
            dm.append(d if rng.uniform() < 0.7 else np.roll(d, 15, axis=1))
    want, got = _both(gts, dts, "segm", (gm, dm))
    assert got == want and want["AP"] > 0
