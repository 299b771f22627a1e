"""Region Proposal Network: anchors, head, fixed-shape proposal selection.

Counterpart of the JAX reference's ``dcnn/models/rpn.py``.  "Number of
proposals" is a fixed budget plus a validity mask; NMS is the exact fixed
point of :mod:`apse_uav_torch.dcnn.ops.nms`.  Every image of a batch and every
pyramid level is selected at once: no per-image loop, and one NMS fixed point
for the whole batch.

The training losses (anchor labels, balanced sampling, objectness and box
regression) keep the reference's discrete choices: the first of equal
maxima, stable ranks of the sampling priorities (ties by lower index), and
priorities drawn from the reference's random stream (``jax.random`` on the
same keys, :func:`~apse_uav_torch.dcnn.flax_init.uniform_t`) on the device.
Keys are (2,) uint32 numpy arrays, one per image.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apse_uav_torch.dcnn import flax_init
from apse_uav_torch.dcnn.config import AnchorConfig, RPNConfig
from apse_uav_torch.dcnn.losses import max0
from apse_uav_torch.dcnn.models.resnet import conv
from apse_uav_torch.dcnn.ops import apply_deltas, box_iou, clip_boxes, get_deltas, nonempty
from apse_uav_torch.dcnn.ops.nms import descending_order, nms_mask

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
    """Shared 3x3 ReLU convolutions + objectness / delta 1x1 convolutions,
    the same weights on every level (detectron2 StandardRPNHead names: one
    convolution is ``conv``, ``num_conv`` > 1 are ``conv.conv0`` ...),
    computed in ``dtype`` (the head compute dtype)."""

    def __init__(self, num_anchors: int, channels: int = 256, dtype: torch.dtype = torch.float32, num_conv: int = 1):
        super().__init__()
        self.num_anchors = num_anchors
        self.dtype = dtype
        if num_conv == 1:
            self.conv = nn.Conv2d(channels, channels, 3, padding=1)
        else:
            self.conv = nn.Sequential()
            for k in range(num_conv):
                self.conv.add_module(f"conv{k}", nn.Conv2d(channels, channels, 3, padding=1))
        self.convs = (self.conv,) if num_conv == 1 else tuple(self.conv)
        self.objectness_logits = nn.Conv2d(channels, num_anchors, 1)
        self.anchor_deltas = nn.Conv2d(channels, num_anchors * 4, 1)

    def forward(self, feats: dict[str, torch.Tensor]):
        """feats[level] NHWC (B, H, W, C) -> (logits[level] (B, H*W*A),
        deltas[level] (B, H*W*A, 4)), anchor-minor as the grid anchors, in ``dtype``."""
        logits, deltas = {}, {}
        for name, x in feats.items():
            t = x.permute(0, 3, 1, 2).to(self.dtype)
            for c in self.convs:
                t = F.relu(conv(c, t))
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


def all_anchors(level_shapes: dict[str, tuple[int, int]], anchor_cfg: AnchorConfig, device) -> torch.Tensor:
    """The anchors of every level, concatenated in sorted level order: (N, 4)."""
    names = sorted(level_shapes)
    return torch.cat([grid_anchors(tuple(level_shapes[n]), LEVEL_STRIDES[n], anchor_cfg.sizes[i],
                                   tuple(anchor_cfg.aspect_ratios), anchor_cfg.offset, str(device))
                      for i, n in enumerate(names)])


def label_anchors(anchors: torch.Tensor, gt_boxes: torch.Tensor, gt_valid: torch.Tensor, fg_thresh: float,
                  bg_thresh: float) -> tuple[torch.Tensor, torch.Tensor]:
    """detectron2's Matcher with low-quality matches, for a batch.

    anchors (N, 4) or (B, N, 4), gt_boxes (B, G, 4), gt_valid (B, G) ->
    (labels (B, N): 1 fg / 0 bg / -1 ignored, matched gt index (B, N))."""
    iou = torch.where(gt_valid[..., None], box_iou(gt_boxes, anchors), -1.0)  # (B, G, N)
    matched_iou = iou.amax(dim=1)
    matched_idx = iou.argmax(dim=1)
    labels = torch.where(matched_iou >= fg_thresh, 1, torch.where(matched_iou < bg_thresh, 0, -1))
    # Low-quality matches: for each gt, the anchors that reach its best IoU are fg.
    best_per_gt = iou.amax(dim=2, keepdim=True)
    is_best = (iou == best_per_gt) & gt_valid[..., None] & (best_per_gt > 0)
    return torch.where(is_best.any(dim=1), 1, labels), matched_idx


def stable_rank(x: torch.Tensor) -> torch.Tensor:
    """Rank of each element along the last axis in ascending order, ties by
    lower index: ``argsort(argsort(x))`` with stable sorts."""
    order = torch.argsort(x, dim=-1, stable=True)
    ranks = torch.arange(x.shape[-1], device=x.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, ranks)


def subsample_labels(keys: np.ndarray, labels: torch.Tensor, num_samples: int,
                     positive_fraction: float) -> torch.Tensor:
    """detectron2's balanced random subsample as a mask, for a batch.

    keys (B, 2) uint32, one per image; labels (B, N).  Picks
    min(#pos, num_samples * fraction) positives and fills the rest with
    negatives, by the largest priorities of ``split(key)``'s two uniform
    streams; -inf priorities (other labels) are never chosen."""
    b, n = labels.shape
    subkeys = np.stack([flax_init.split(k) for k in np.asarray(keys).reshape(b, 2)])  # (B, 2, 2)
    u = flax_init.uniform_t(subkeys.reshape(-1, 2), n, labels.device).reshape(b, 2, n)
    neg_inf = torch.full((), float("-inf"), device=labels.device)
    pos = labels == 1
    neg = labels == 0
    n_pos = pos.sum(dim=1).clamp(max=int(num_samples * positive_fraction))
    pos_sel = pos & (stable_rank(-torch.where(pos, u[:, 0], neg_inf)) < n_pos[:, None])
    n_neg = torch.minimum(neg.sum(dim=1), num_samples - n_pos)
    neg_sel = neg & (stable_rank(-torch.where(neg, u[:, 1], neg_inf)) < n_neg[:, None])
    return pos_sel | neg_sel


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, beta: float) -> torch.Tensor:
    diff = torch.abs(pred - target)
    if beta <= 1e-8:
        return diff
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)


def rpn_losses(keys: np.ndarray, logits: dict[str, torch.Tensor], deltas: dict[str, torch.Tensor],
               level_shapes: dict[str, tuple[int, int]], gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
               anchor_cfg: AnchorConfig, rpn_cfg: RPNConfig) -> dict[str, torch.Tensor]:
    """Objectness and box-regression losses of each image: {name: (B,)}.
    keys (B, 2) uint32, one per image; logits[level] (B, N_l),
    deltas[level] (B, N_l, 4); gt_boxes (B, G, 4), gt_valid (B, G)."""
    names = sorted(logits)
    anchors = all_anchors(level_shapes, anchor_cfg, gt_boxes.device)
    logit_cat = torch.cat([logits[n] for n in names], dim=1)
    delta_cat = torch.cat([deltas[n] for n in names], dim=1)
    labels, matched = label_anchors(anchors, gt_boxes, gt_valid, rpn_cfg.iou_fg_thresh, rpn_cfg.iou_bg_thresh)
    sel = subsample_labels(keys, labels, rpn_cfg.batch_size_per_image, rpn_cfg.positive_fraction)
    pos = sel & (labels == 1)
    gt_deltas = get_deltas(anchors, take_rows(gt_boxes, matched))
    normalizer = float(rpn_cfg.batch_size_per_image)
    loc = torch.where(pos[..., None], smooth_l1(delta_cat, gt_deltas, rpn_cfg.smooth_l1_beta), 0.0).sum(dim=(1, 2))
    # BCE with logits against the 0/1 label.
    bce = max0(logit_cat) - logit_cat * labels.to(logit_cat.dtype) + torch.log1p(torch.exp(-torch.abs(logit_cat)))
    obj = torch.where(sel, bce, 0.0).sum(dim=1)
    return {"loss_rpn_loc": loc / normalizer, "loss_rpn_cls": obj / normalizer}
