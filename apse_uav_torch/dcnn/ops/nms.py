"""Exact greedy NMS as a fixed point, batched, with no dynamic shapes.

Counterpart of the JAX reference's ``dcnn/ops/nms.py``.  Greedy NMS is the
unique fixed point of the map

    keep[i] <- valid[i] and not OR_{j ranked above i} (keep[j] and iou[j, i] > thr)

iterated from ``keep = valid``; it converges in (longest suppression chain)
steps, each one dense (N, N) masked reduction.  The map returns its input at
the fixed point, so :func:`~apse_uav_torch.dcnn.ops.loops.run_until` tests
convergence only every few steps.  Leading dimensions are independent
problems (images, pyramid levels) iterated together.
"""

from __future__ import annotations

import torch

from apse_uav_torch.dcnn.ops.boxes import box_iou
from apse_uav_torch.dcnn.ops.loops import run_until

# Fixed-point steps between two convergence tests (host syncs on the card).
CHECK_EVERY = 8


def descending_order(x: torch.Tensor) -> torch.Tensor:
    """Indices sorting the last axis descending, ties by lower index first:
    the order of ``lax.top_k`` and of the reference's stable ``argsort`` of
    the negated values."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
             valid: torch.Tensor | None = None) -> torch.Tensor:
    """Exact greedy NMS keep-mask.

    boxes (..., N, 4) xyxy, scores (..., N), valid (..., N) bool.  Boxes need
    not be sorted; suppression follows descending score, ties by index.
    Returns (..., N) bool.
    """
    n = boxes.shape[-2]
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    if n == 0:
        return valid.clone()
    neg_inf = torch.full((), float("-inf"), dtype=scores.dtype, device=scores.device)
    order = descending_order(torch.where(valid, scores, neg_inf))
    rank = torch.empty_like(order).scatter_(-1, order, torch.arange(n, device=order.device).expand_as(order))
    iou = box_iou(boxes, boxes)
    # suppress[j, i]: an alive j would suppress i (ranked above it, overlapping).
    suppress = (iou > iou_threshold) & (rank[..., :, None] < rank[..., None, :]) & valid[..., :, None]

    def step(state):
        keep, _ = state
        return valid & ~(suppress & keep[..., :, None]).any(dim=-2), keep

    keep, _ = run_until(step, (valid, ~valid), lambda s: (s[0] == s[1]).all(), n + 1, CHECK_EVERY,
                        site="nms_converge")
    return keep


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor, idxs: torch.Tensor, iou_threshold: float,
                valid: torch.Tensor | None = None) -> torch.Tensor:
    """Class-aware NMS: boxes of different ``idxs`` never suppress each other.

    Each class is moved onto a coordinate island of its own (torchvision's
    trick), per problem of the leading dimensions, so one dense NMS suffices.
    """
    if boxes.shape[-2] == 0:
        return torch.zeros(scores.shape, dtype=torch.bool, device=scores.device)
    max_coord = boxes.abs().amax(dim=(-2, -1), keepdim=True)[..., 0] + 1.0
    offsets = idxs.to(boxes.dtype) * (2.0 * max_coord)
    return nms_mask(boxes + offsets[..., None], scores, iou_threshold, valid)
