"""COWC ROI-feature precompute loader (the reference's dcnn/utils/cowc_utils.py).

Counterpart of the JAX reference's ``data/cowc.py``: every annotated car and
negative point of the large COWC aerial frames goes through the frozen
detector trunk once (backbone -> box pooler -> box head FC trunk), and the
loader serves balanced batches of the cached features for head-only
training.

* Boxes go to the feature function in fixed chunks of ``chunk`` (the last
  one zero-padded, its padded rows dropped), as the reference feeds its
  jitted function.
* The model hook is ``MaskRCNN.roi_features``; :func:`build_roi_feature_fn`
  runs it under ``torch.no_grad`` on the model's device.
* The annotation conventions are the reference's (cowc_utils.py:130-141,
  read there with cv2 in BGR order): car points are the saturated-red pixels
  of ``*_Annotated_Cars.png`` (BGR channel 2 == 255, RGB channel 0 here),
  negatives the saturated-blue pixels of ``*_Annotated_Negatives.png`` (BGR
  channel 0, RGB channel 2); each point becomes a box of half-width
  ``bbox_width`` clipped to its patch (:146-158); per image, floor(min(npos,
  nneg) / (batch / 2)) balanced batches (:196-200).

PIL reads the images, imported inside the loader.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from apse_uav_torch.data.datasets import _images_in


def _points_from_annotation(path: str, rgb_channel: int) -> tuple[np.ndarray, np.ndarray]:
    """(rows, cols) of the pixels whose ``rgb_channel`` is saturated (== 255)."""
    from PIL import Image

    ann = np.array(Image.open(path))
    plane = ann if ann.ndim == 2 else ann[..., rgb_channel]
    return np.nonzero(plane == 255)


def _patch_instances(cars_rc, neg_rc, patch_yx, patch_size: int, bbox_width: int):
    """Boxes (N, 4) xyxy in patch coordinates and classes (N,) {1 car, 0
    negative}: each point +- ``bbox_width``, each coordinate clipped to
    [0, patch_size - 1] (cowc_utils.get_instances:130-158)."""
    y0, x0 = patch_yx
    boxes, classes = [], []
    for (rr, cc), cls in ((cars_rc, 1), (neg_rc, 0)):
        sel = (rr >= y0) & (rr < y0 + patch_size) & (cc >= x0) & (cc < x0 + patch_size)
        for r, c in zip(rr[sel] - y0, cc[sel] - x0):
            boxes.append(np.clip([c - bbox_width, r - bbox_width, c + bbox_width, r + bbox_width], 0,
                                 patch_size - 1))
            classes.append(cls)
    if not boxes:
        return np.zeros((0, 4), np.float32), np.zeros((0,), np.int64)
    return np.asarray(boxes, np.float32), np.asarray(classes, np.int64)


class CowcRoiFeaturesLoader:
    """Precomputed (ROI features, class) batches over a COWC directory.

    ``roi_feature_fn(image (1, P, P, 3) float32, boxes (1, M, 4) float32) ->
    (1, M, D)`` (numpy in, a tensor or an array out), typically
    :func:`build_roi_feature_fn`.  Iterating yields (features (batch, D)
    float32, labels (batch,) int64: ``batch / 2`` cars then as many
    negatives), image by image.
    """

    def __init__(self, roi_feature_fn, dataset_dir: str, patch_size: int = 1024, bbox_width: int = 18,
                 batch_size: int = 100, chunk: int = 128, cars_suffix: str = "_Annotated_Cars.png",
                 neg_suffix: str = "_Annotated_Negatives.png"):
        from PIL import Image

        self.batch_size = batch_size
        self.batches_per_img: list[list[tuple[np.ndarray, np.ndarray]]] = []
        for fname in _images_in(dataset_dir):
            if "Annotated" in fname:
                continue
            stem = fname.rsplit(".", 1)[0]
            cars_path = os.path.join(dataset_dir, stem + cars_suffix)
            neg_path = os.path.join(dataset_dir, stem + neg_suffix)
            if not (os.path.exists(cars_path) and os.path.exists(neg_path)):
                continue
            img = np.array(Image.open(os.path.join(dataset_dir, fname)))[..., :3]
            cars_rc = _points_from_annotation(cars_path, 0)  # saturated red
            neg_rc = _points_from_annotation(neg_path, 2)  # saturated blue
            feats, classes = [], []
            h, w = img.shape[:2]
            for y0 in range(0, h - patch_size + 1, patch_size):
                for x0 in range(0, w - patch_size + 1, patch_size):
                    boxes, cls = _patch_instances(cars_rc, neg_rc, (y0, x0), patch_size, bbox_width)
                    if len(cls) == 0:
                        continue
                    patch = img[y0:y0 + patch_size, x0:x0 + patch_size].astype(np.float32)
                    feats.append(self._features_chunked(roi_feature_fn, patch, boxes, chunk))
                    classes.append(cls)
            if not feats:
                self.batches_per_img.append([])
                continue
            self.batches_per_img.append(self._balanced_batches(np.concatenate(feats), np.concatenate(classes)))

    @staticmethod
    def _features_chunked(roi_feature_fn, patch: np.ndarray, boxes: np.ndarray, chunk: int) -> np.ndarray:
        """Fixed-shape chunks: boxes padded to ``chunk``, padded rows dropped."""
        out = []
        for a in range(0, len(boxes), chunk):
            b = boxes[a:a + chunk]
            bp = np.zeros((chunk, 4), np.float32)
            bp[:len(b)] = b
            f = roi_feature_fn(patch[None], bp[None])
            f = f.cpu().numpy() if isinstance(f, torch.Tensor) else np.asarray(f)
            out.append(f[0][:len(b)])
        return np.concatenate(out)

    def _balanced_batches(self, feats: np.ndarray, classes: np.ndarray):
        """floor(min(npos, nneg) / (batch / 2)) balanced batches (:196-208)."""
        pos = np.nonzero(classes == 1)[0]
        neg = np.nonzero(classes == 0)[0]
        ns = self.batch_size // 2
        batches = []
        for bi in range(math.floor(min(len(pos), len(neg)) / ns)):
            idx = np.concatenate([pos[bi * ns:(bi + 1) * ns], neg[bi * ns:(bi + 1) * ns]])
            batches.append((feats[idx], np.asarray([1] * ns + [0] * ns, np.int64)))
        return batches

    def __iter__(self):
        for img_batches in self.batches_per_img:
            yield from img_batches


def build_roi_feature_fn(model):
    """The frozen-trunk ROI feature function of ``model`` (a MaskRCNN) for
    :class:`CowcRoiFeaturesLoader`: numpy (1, P, P, 3) images and (1, M, 4)
    boxes in, (1, M, fc_dim) float32 features out, on the model's device,
    under ``torch.no_grad``, in true float32 (TF32 off)."""
    from apse_uav_torch.dcnn.engines import full_fp32

    dev = model.pixel_mean.device

    @torch.no_grad()
    def fn(images, boxes):
        with full_fp32():
            return model.roi_features(torch.as_tensor(np.asarray(images, np.float32), device=dev),
                                      torch.as_tensor(np.asarray(boxes, np.float32), device=dev))

    return fn
