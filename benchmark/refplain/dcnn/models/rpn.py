"""Region Proposal Network: anchors, head, fixed-shape proposal selection.

Counterpart of the JAX reference's ``dcnn/models/rpn.py``.  "Number of
proposals" is a fixed budget plus a validity mask; NMS is the exact fixed
point of :mod:`refplain.dcnn.ops.nms`.  Every image of a batch and every
pyramid level is selected at once: no per-image loop, and one NMS fixed point
for the whole batch.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from refplain.dcnn.config import AnchorConfig, RPNConfig
from refplain.dcnn.models.resnet import conv
from refplain.dcnn.ops import apply_deltas, clip_boxes, nonempty
from refplain.dcnn.ops.nms import descending_order, nms_mask

# The C4 backbone's RPN runs on the single res4 map (stride 16).
LEVEL_STRIDES = {"p2": 4, "p3": 8, "p4": 16, "p5": 32, "p6": 64, "res4": 16}


def cell_anchors(size, aspect_ratios: Sequence[float]) -> np.ndarray:
    """(A, 4) base anchors centred at the origin (detectron2 order: sizes
    outer, aspect ratios inner).  ``size`` is one float or a tuple of them."""
    sizes = size if isinstance(size, (tuple, list)) else (size,)
    out = []
    for s in sizes:
        area = s * s
        for r in aspect_ratios:
            w = (area / r) ** 0.5
            h = w * r
            out.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    return np.asarray(out, np.float32)


@functools.lru_cache(maxsize=64)
def _grid_anchors_np(hw: tuple[int, int], stride: int, size: float, aspect_ratios: tuple[float, ...],
                     offset: float = 0.0) -> np.ndarray:
    h, w = hw
    base = cell_anchors(size, aspect_ratios)
    xs = (np.arange(w, dtype=np.float32) + offset) * stride
    ys = (np.arange(h, dtype=np.float32) + offset) * stride
    sx, sy = np.meshgrid(xs, ys)
    shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 1, 4)
    return (shifts + base[None]).reshape(-1, 4).astype(np.float32)


@functools.lru_cache(maxsize=64)
def grid_anchors(hw: tuple[int, int], stride: int, size: float, aspect_ratios: tuple[float, ...],
                 offset: float = 0.0, device: str = "cpu") -> torch.Tensor:
    """All anchors of one level, (H*W*A, 4), shift-major / anchor-minor: a host
    constant, moved to ``device`` once and kept (callers do not modify it)."""
    return torch.from_numpy(_grid_anchors_np(hw, stride, size, aspect_ratios, offset)).to(device)


class RPNHead(nn.Module):
    """Shared 3x3 convolution + objectness / delta 1x1 convolutions, the same
    weights on every level (detectron2 StandardRPNHead names), computed in
    ``dtype`` (the head compute dtype)."""

    def __init__(self, num_anchors: int, channels: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_anchors = num_anchors
        self.dtype = dtype
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)
        self.objectness_logits = nn.Conv2d(channels, num_anchors, 1)
        self.anchor_deltas = nn.Conv2d(channels, num_anchors * 4, 1)

    def forward(self, feats: dict[str, torch.Tensor]):
        """feats[level] NHWC (B, H, W, C) -> (logits[level] (B, H*W*A),
        deltas[level] (B, H*W*A, 4)), anchor-minor as the grid anchors, in ``dtype``."""
        logits, deltas = {}, {}
        for name, x in feats.items():
            t = F.relu(conv(self.conv, x.permute(0, 3, 1, 2).to(self.dtype)))
            b, _, h, w = t.shape
            logits[name] = conv(self.objectness_logits, t).permute(0, 2, 3, 1).reshape(b, h * w * self.num_anchors)
            deltas[name] = conv(self.anchor_deltas, t).permute(0, 2, 3, 1).reshape(b, h * w * self.num_anchors, 4)
        return logits, deltas


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...) gathered along N by idx (B, K) -> (B, K, ...)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def select_proposals(logits: dict[str, torch.Tensor], deltas: dict[str, torch.Tensor],
                     level_shapes: dict[str, tuple[int, int]], image_hw: tuple[int, int],
                     anchor_cfg: AnchorConfig, rpn_cfg: RPNConfig, training: bool = False,
                     levels: tuple[str, ...] | None = None):
    """Fixed-shape find_top_rpn_proposals for a batch.

    logits[level] (B, N_l), deltas[level] (B, N_l, 4).  Returns (boxes (B, P, 4),
    scores (B, P), valid (B, P)) with P = min(post_nms_topk, all candidates),
    the ``*_topk_train`` budgets when ``training``, else ``*_topk_test``, in descending score, ties by lower index (``lax.top_k``'s
    order).  bfloat16 logits stay bfloat16 (so do the scores, ranked as they
    are); the boxes come out float32, bf16 deltas meeting float32 anchors.  Levels run together: each level's candidates are padded to the
    largest budget with invalid entries, which neither suppress nor survive.
    ``levels``, if given, are the only levels that propose; the anchors stay
    those of each level's place among all of them (the reference's
    SelectiveRPN keeps only the coarsest level's proposals).
    """
    pre_k = rpn_cfg.pre_nms_topk_train if training else rpn_cfg.pre_nms_topk_test
    post_k = rpn_cfg.post_nms_topk_train if training else rpn_cfg.post_nms_topk_test
    names = sorted(logits.keys())
    dev = logits[names[0]].device
    level_boxes, level_scores, level_valid = [], [], []
    for i, name in enumerate(names):
        if levels is not None and name not in levels:
            continue
        anchors = grid_anchors(tuple(level_shapes[name]), LEVEL_STRIDES[name], anchor_cfg.sizes[i],
                               tuple(anchor_cfg.aspect_ratios), anchor_cfg.offset, str(dev))
        k = min(pre_k, logits[name].shape[1])
        idx = descending_order(logits[name])[:, :k]
        scores = torch.gather(logits[name], 1, idx)
        boxes = clip_boxes(apply_deltas(take_rows(deltas[name], idx), anchors[idx]), image_hw)
        valid = nonempty(boxes, rpn_cfg.min_size) & torch.isfinite(boxes).all(dim=-1) & torch.isfinite(scores)
        level_boxes.append(boxes)
        level_scores.append(scores)
        level_valid.append(valid)
    kmax = max(s.shape[1] for s in level_scores)

    def padded(ts, value):
        return torch.stack([F.pad(t, (0, 0) * (t.dim() - 2) + (0, kmax - t.shape[1]), value=value) for t in ts], 1)

    keep = nms_mask(padded(level_boxes, 0.0), padded(level_scores, 0.0), rpn_cfg.nms_thresh,
                    padded(level_valid, False))
    neg_inf = torch.full((), float("-inf"), device=dev)
    boxes = torch.cat(level_boxes, dim=1)
    scores = torch.cat([torch.where(keep[:, i, :s.shape[1]], s, neg_inf) for i, s in enumerate(level_scores)], dim=1)
    k = min(post_k, boxes.shape[1])
    idx = descending_order(scores)[:, :k]
    top = torch.gather(scores, 1, idx)
    return take_rows(boxes, idx), top, torch.isfinite(top)
