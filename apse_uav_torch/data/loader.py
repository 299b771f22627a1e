"""Detection data loader: dataset dicts -> fixed-shape batches.

The port's copy of the JAX reference's ``data/loader.py``: the same numpy
random draws in the same order (the shuffle of each pass, then per image the
flip, brightness, saturation, contrast and lighting) and PIL's bilinear
resize, so one seed gives the same batches in both packages.

Replaces the reference's forked detectron2 dataloaders + DatasetMapper
(UAV_utils.py:164-449): image loading, ResizeShortestEdge-style scaling to a
FIXED padded train size (static shapes), random horizontal flip, and the
reference's extra color augmentations (RandomBrightness/Saturation/Contrast
0.8-1.2, UAV_utils.py:337-341).  Ground truth is padded to a fixed box
capacity with a validity mask; masks (when present) are rasterized at a
fixed stride for the mask loss.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class LoaderConfig:
    train_size: tuple[int, int] = (768, 1344)  # padded (H, W), /32 aligned
    min_size: int = 800  # shortest-edge target before padding
    max_size: int = 1333
    max_gt: int = 128  # GT box capacity per image
    batch_size: int = 4
    flip_prob: float = 0.5
    color_aug: bool = True
    aug_range: tuple[float, float] = (0.8, 1.2)
    # RandomLighting (PCA) scale (UAV_utils.py:341, detectron2 semantics:
    # per-image constant offset eigen_vecs @ (N(0, scale) * eigen_vals) in
    # RGB order, on the 0-255 pixel scale).  0 disables.
    lighting_scale: float = 0.2
    mask_size: int = 0  # if >0, rasterize GT masks at (mask_size, mask_size)
    channel_format: str = "BGR"


# ImageNet PCA lighting basis (AlexNet fancy-PCA constants, as used by
# detectron2's T.RandomLighting): columns are RGB eigenvectors of the
# pixel-covariance, eigen_vals their eigenvalues.
LIGHTING_EIGEN_VECS = np.array(
    [[-0.5675, 0.7192, 0.4009],
     [-0.5808, -0.0045, -0.8140],
     [-0.5836, -0.6948, 0.4203]], np.float32
)
LIGHTING_EIGEN_VALS = np.array([0.2175, 0.0188, 0.0045], np.float32)


def lighting_delta(rng: np.random.Generator, scale: float) -> np.ndarray:
    """Per-image constant RGB offset of the PCA lighting augmentation."""
    w = rng.normal(scale=scale, size=3).astype(np.float32)
    return LIGHTING_EIGEN_VECS @ (w * LIGHTING_EIGEN_VALS)


def pad_gt(annotations: Sequence[dict], max_gt: int, scale: tuple[float, float], flip_w: float | None) -> dict:
    """Annotations -> fixed-size GT arrays in resized (XYXY) coords."""
    boxes = np.zeros((max_gt, 4), np.float32)
    classes = np.zeros(max_gt, np.int32)
    valid = np.zeros(max_gt, bool)
    sy, sx = scale
    for i, a in enumerate(annotations[:max_gt]):
        x, y, w, h = a["bbox"]
        x1, y1, x2, y2 = x * sx, y * sy, (x + w) * sx, (y + h) * sy
        if flip_w is not None:
            x1, x2 = flip_w - x2, flip_w - x1
        boxes[i] = (x1, y1, x2, y2)
        classes[i] = a["category_id"]
        valid[i] = True
    return {"boxes": boxes, "classes": classes, "valid": valid}


class DetectionLoader:
    """Iterates (images (B,H,W,3) float32, gt dict) batches, forever if
    ``epochs`` is None (training) or once (evaluation)."""

    def __init__(self, dataset_dicts: list[dict], cfg: LoaderConfig | None = None,
                 training: bool = True, seed: int = 0):
        self.dicts = list(dataset_dicts)
        self.cfg = cfg or LoaderConfig()
        self.training = training
        self.rng = np.random.default_rng(seed)

    def _load_image(self, d: dict) -> np.ndarray:
        from PIL import Image

        with Image.open(d["file_name"]) as im:
            im = im.convert("RGB")
            arr = np.asarray(im)
        if "crop" in d:
            x, y, w, h = d["crop"]
            arr = arr[y : y + h, x : x + w]
        if self.cfg.channel_format == "BGR":
            arr = arr[..., ::-1]
        return arr.astype(np.float32)

    def _resize(self, img: np.ndarray) -> tuple[np.ndarray, tuple[float, float]]:
        from PIL import Image

        h, w = img.shape[:2]
        scale = self.cfg.min_size / min(h, w)
        if max(h, w) * scale > self.cfg.max_size:
            scale = self.cfg.max_size / max(h, w)
        ph, pw = self.cfg.train_size
        nh, nw = min(int(round(h * scale)), ph), min(int(round(w * scale)), pw)
        res = np.asarray(
            Image.fromarray(img.astype(np.uint8)).resize((nw, nh), Image.BILINEAR),
            np.float32,
        )
        out = np.zeros((ph, pw, 3), np.float32)
        out[:nh, :nw] = res
        return out, (nh / h, nw / w)

    def _augment(self, img: np.ndarray) -> np.ndarray:
        lo, hi = self.cfg.aug_range
        # Brightness / saturation / contrast / PCA lighting, each a random
        # blend (detectron2 transform semantics: img*w + target*(1-w)),
        # applied in the reference's append order (UAV_utils.py:338-341).
        b = self.rng.uniform(lo, hi)
        img = img * b
        s = self.rng.uniform(lo, hi)
        gray = img.mean(axis=2, keepdims=True)
        img = img * s + gray * (1 - s)
        c = self.rng.uniform(lo, hi)
        img = img * c + img.mean() * (1 - c)
        if self.cfg.lighting_scale > 0:
            delta = lighting_delta(self.rng, self.cfg.lighting_scale)
            if self.cfg.channel_format == "BGR":
                delta = delta[::-1]  # basis is RGB-ordered
            img = img + delta
        return np.clip(img, 0, 255)

    def _one(self, d: dict) -> tuple[np.ndarray, dict]:
        img = self._load_image(d)
        img, scale = self._resize(img)
        flip = self.training and self.rng.uniform() < self.cfg.flip_prob
        if flip:
            img = img[:, ::-1]
        if self.training and self.cfg.color_aug:
            img = self._augment(img)
        flip_w = float(img.shape[1]) if flip else None
        gt = pad_gt(d.get("annotations", []), self.cfg.max_gt, scale, flip_w)
        if self.cfg.mask_size:
            gt["masks"] = self._gt_masks(d, flip)
        return img, gt

    def _gt_masks(self, d: dict, flip: bool) -> np.ndarray:
        from apse_uav_torch.evaluation import rle as rletools

        ms = self.cfg.mask_size
        out = np.zeros((self.cfg.max_gt, ms, ms), np.float32)
        for i, a in enumerate(d.get("annotations", [])[: self.cfg.max_gt]):
            if "segmentation" not in a:
                out[i] = 1.0  # box-filled mask fallback
                continue
            m = rletools.decode(a["segmentation"]).astype(np.float32)
            x, y, w, h = [int(round(v)) for v in a["bbox"]]
            crop = m[max(y, 0) : y + max(h, 1), max(x, 0) : x + max(w, 1)]
            if crop.size == 0:
                continue
            from PIL import Image

            out[i] = np.asarray(
                Image.fromarray((crop * 255).astype(np.uint8)).resize((ms, ms), Image.BILINEAR),
                np.float32,
            ) / 255.0
            if flip:
                out[i] = out[i][:, ::-1]
        return out

    def __iter__(self) -> Iterator[tuple[np.ndarray, dict]]:
        order = np.arange(len(self.dicts))
        while True:
            if self.training:
                self.rng.shuffle(order)
            for start in range(0, len(order) - self.cfg.batch_size + 1, self.cfg.batch_size):
                idx = order[start : start + self.cfg.batch_size]
                items = [self._one(self.dicts[i]) for i in idx]
                images = np.stack([im for im, _ in items])
                gt = {
                    k: np.stack([g[k] for _, g in items]) for k in items[0][1]
                }
                yield images, gt
            if not self.training:
                return
