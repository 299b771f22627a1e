"""Box math (XYXY, pixel coordinates) under the RPN and the ROI heads.

Counterpart of the JAX reference's ``dcnn/ops/boxes.py`` (detectron2's
``Boxes`` / ``Box2BoxTransform``): the same formulas, one op per rounding in
the same order, on tensors of any leading shape.
"""

from __future__ import annotations

import torch

# detectron2 Box2BoxTransform defaults: no weights, clamp on dw/dh.
_SCALE_CLAMP = 4.135166556742356  # log(1000/16)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) xyxy -> (...,) areas (0 for degenerate boxes)."""
    w = torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0)
    h = torch.clamp(boxes[..., 3] - boxes[..., 1], min=0.0)
    return w * h


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU: a (..., N, 4), b (..., M, 4) -> (..., N, M)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a)[..., :, None] + box_area(b)[..., None, :] - inter
    return torch.where(union > 0, inter / torch.clamp(union, min=1e-9), torch.zeros_like(inter))


def clip_boxes(boxes: torch.Tensor, size_hw) -> torch.Tensor:
    """Clip xyxy boxes to [0, W] x [0, H]."""
    h, w = float(size_hw[0]), float(size_hw[1])
    return torch.stack([boxes[..., 0].clamp(0.0, w), boxes[..., 1].clamp(0.0, h),
                        boxes[..., 2].clamp(0.0, w), boxes[..., 3].clamp(0.0, h)], dim=-1)


def nonempty(boxes: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    """(..., 4) -> (...,) bool: width and height strictly above threshold."""
    return ((boxes[..., 2] - boxes[..., 0]) > threshold) & ((boxes[..., 3] - boxes[..., 1]) > threshold)


def get_deltas(src: torch.Tensor, target: torch.Tensor, weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Box regression targets (dx, dy, dw, dh) from src anchors to targets."""
    sw = src[..., 2] - src[..., 0]
    sh = src[..., 3] - src[..., 1]
    sx = src[..., 0] + 0.5 * sw
    sy = src[..., 1] + 0.5 * sh
    tw = target[..., 2] - target[..., 0]
    th = target[..., 3] - target[..., 1]
    tx = target[..., 0] + 0.5 * tw
    ty = target[..., 1] + 0.5 * th
    wx, wy, ww, wh = weights
    dx = wx * (tx - sx) / sw.clamp(min=1e-6)
    dy = wy * (ty - sy) / sh.clamp(min=1e-6)
    dw = ww * torch.log(tw.clamp(min=1e-6) / sw.clamp(min=1e-6))
    dh = wh * torch.log(th.clamp(min=1e-6) / sh.clamp(min=1e-6))
    return torch.stack([dx, dy, dw, dh], dim=-1)


def apply_deltas(deltas: torch.Tensor, boxes: torch.Tensor, weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Apply (..., 4) regression deltas to (..., 4) xyxy boxes."""
    widths = boxes[..., 2] - boxes[..., 0]
    heights = boxes[..., 3] - boxes[..., 1]
    ctr_x = boxes[..., 0] + 0.5 * widths
    ctr_y = boxes[..., 1] + 0.5 * heights
    wx, wy, ww, wh = weights
    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = torch.clamp(deltas[..., 2] / ww, max=_SCALE_CLAMP)
    dh = torch.clamp(deltas[..., 3] / wh, max=_SCALE_CLAMP)
    pred_ctr_x = dx * widths + ctr_x
    pred_ctr_y = dy * heights + ctr_y
    pred_w = torch.exp(dw) * widths
    pred_h = torch.exp(dh) * heights
    return torch.stack([pred_ctr_x - 0.5 * pred_w, pred_ctr_y - 0.5 * pred_h,
                        pred_ctr_x + 0.5 * pred_w, pred_ctr_y + 0.5 * pred_h], dim=-1)
