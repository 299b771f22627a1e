"""StandardROIHeads at inference: FPN pooling, box head, mask head.

Counterpart of the JAX reference's ``dcnn/models/roi_heads.py``: detectron2's
StandardROIHeads + FastRCNNConvFCHead + MaskRCNNConvUpsampleHead with
fixed-capacity proposals and detections (validity masks) and the exact
fixed-point NMS, batched over images.  The reference's ``BoxHead`` is here
the FC trunk :class:`BoxHead` plus :class:`BoxPredictor`, named as
detectron2 names them (``roi_heads.box_head.fc1``,
``roi_heads.box_predictor.cls_score``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from refplain.dcnn.config import ROIConfig
from refplain.dcnn.models.resnet import conv
from refplain.dcnn.ops import apply_deltas, clip_boxes
from refplain.dcnn.ops.nms import batched_nms, descending_order
from refplain.dcnn.ops.roi_align import sample_grid

POOL_LEVELS = ("p2", "p3", "p4", "p5")
CANONICAL_LEVEL = 4
CANONICAL_SIZE = 224.0


def assign_boxes_to_levels(boxes: torch.Tensor) -> torch.Tensor:
    """FPN level per box (detectron2 assign_boxes_to_levels): (...,) int64 in [0, 3]."""
    area = (boxes[..., 2] - boxes[..., 0]).clamp(min=0.0) * (boxes[..., 3] - boxes[..., 1]).clamp(min=0.0)
    lvl = torch.floor(CANONICAL_LEVEL + torch.log2(torch.sqrt(area) / CANONICAL_SIZE + 1e-8))
    return (lvl.clamp(2, 5) - 2).to(torch.int64)


@functools.lru_cache(maxsize=16)
def _level_tables(level_hw: tuple, device: str):
    """Per-level height, width (f32 and int64), flat row base and scale: host
    constants moved to ``device`` once (callers do not modify them)."""
    sizes = [h * w for h, w in level_hw]
    return (torch.tensor([h for h, _ in level_hw], dtype=torch.float32, device=device),
            torch.tensor([w for _, w in level_hw], dtype=torch.float32, device=device),
            torch.tensor([w for _, w in level_hw], dtype=torch.int64, device=device),
            torch.tensor(np.cumsum([0] + sizes[:-1]), dtype=torch.int64, device=device),
            torch.tensor([1.0 / (4 * 2**i) for i in range(len(level_hw))], dtype=torch.float32, device=device))


def fpn_roi_align(feats: dict[str, torch.Tensor], boxes: torch.Tensor, resolution: int,
                  sampling_ratio: int) -> torch.Tensor:
    """Multi-level ROIAlignV2 (aligned) of a batch in one pass.

    feats[p2..p5] NHWC (B, H, W, C); boxes (B, N, 4) -> (B, N, C, R, R) float32.
    The levels are concatenated into one flat bfloat16 row buffer per image,
    and each box gathers only from its assigned level through a per-box base
    offset; the weighted combine is float32 (the reference's roundings).
    """
    nb, n = boxes.shape[:2]
    dev = boxes.device
    c = feats[POOL_LEVELS[0]].shape[-1]
    level_hw = [tuple(feats[name].shape[1:3]) for name in POOL_LEVELS]
    flat = torch.cat([feats[name].to(torch.bfloat16).reshape(nb, -1, c) for name in POOL_LEVELS], dim=1)
    total = flat.shape[1]
    flat = flat.reshape(nb * total, c)
    lvl = assign_boxes_to_levels(boxes)
    hs, ws, wis, bases, scales = (t[lvl] for t in _level_tables(tuple(level_hw), str(dev)))
    hs, ws, wis = hs[..., None], ws[..., None], wis[..., None]
    bases = bases[..., None] + torch.arange(nb, device=dev)[:, None, None] * total
    s = max(int(sampling_ratio), 1)
    r = resolution
    x1 = boxes[..., 0] * scales - 0.5
    y1 = boxes[..., 1] * scales - 0.5
    rw = (boxes[..., 2] - boxes[..., 0]) * scales
    rh = (boxes[..., 3] - boxes[..., 1]) * scales
    grid = sample_grid(r, s, dev)
    ys = y1[..., None] + grid * (rh / r)[..., None]  # (B, N, r*s)
    xs = x1[..., None] + grid * (rw / r)[..., None]
    m = r * s
    yy = ys[..., :, None].expand(nb, n, m, m).reshape(nb, n, m * m)
    xx = xs[..., None, :].expand(nb, n, m, m).reshape(nb, n, m * m)
    oor = (yy < -1.0) | (yy > hs) | (xx < -1.0) | (xx > ws)
    y = torch.minimum(yy.clamp(min=0.0), hs - 1.0)
    x = torch.minimum(xx.clamp(min=0.0), ws - 1.0)
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    y1f = torch.minimum(y0 + 1, hs - 1.0)
    x1f = torch.minimum(x0 + 1, ws - 1.0)
    ly = y - y0
    lx = x - x0
    y0i, x0i, y1i, x1i = (t.to(torch.int64) for t in (y0, x0, y1f, x1f))
    taps = ((y0i, x0i, (1 - ly) * (1 - lx)), (y0i, x1i, (1 - ly) * lx), (y1i, x0i, ly * (1 - lx)), (y1i, x1i, ly * lx))
    val = None
    for ty, tx, wt in taps:
        rows = flat.index_select(0, (bases + ty * wis + tx).reshape(-1)).to(torch.float32)
        term = rows * wt.reshape(-1, 1)
        val = term if val is None else val.add_(term)
    val = torch.where(oor.reshape(-1, 1), torch.zeros((), device=dev), val)
    vals = val.reshape(nb, n, r, s, r, s, c).mean(dim=(3, 5))
    return vals.permute(0, 1, 4, 2, 3)


class BoxHead(nn.Module):
    """FastRCNNConvFCHead: flatten (C, R, R) in channel-major order, then
    ``num_fc`` ReLU FC layers -> (N, fc_dim) float32 features.  The input is
    rounded to ``dtype`` (the head compute dtype), as the reference casts it;
    the reference's FC layers take no dtype, so they compute in float32, the
    promotion of that input with their float32 parameters."""

    def __init__(self, in_dim: int, fc_dim: int = 1024, num_fc: int = 2, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_fc = num_fc
        self.dtype = dtype
        for i in range(num_fc):
            self.add_module(f"fc{i + 1}", nn.Linear(in_dim if i == 0 else fc_dim, fc_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1).to(self.dtype).to(torch.float32)
        for i in range(self.num_fc):
            x = F.relu(getattr(self, f"fc{i + 1}")(x))
        return x


class BoxPredictor(nn.Module):
    """FastRCNNOutputLayers: class logits (N, K + 1) (background last) and
    class-specific deltas (N, K, 4)."""

    def __init__(self, fc_dim: int, num_classes: int):
        super().__init__()
        self.num_classes = num_classes
        self.cls_score = nn.Linear(fc_dim, num_classes + 1)
        self.bbox_pred = nn.Linear(fc_dim, num_classes * 4)

    def forward(self, x: torch.Tensor):
        return self.cls_score(x), self.bbox_pred(x).reshape(x.shape[0], self.num_classes, 4)


class MaskHead(nn.Module):
    """MaskRCNNConvUpsampleHead: ``num_conv`` 3x3 ReLU convolutions, a 2x2/2
    transposed convolution + ReLU, a 1x1 predictor (C4: no convolution, the
    transposed one on the 2048-channel res5 features).  (N, C, R, R) -> mask
    logits (N, K, 2R, 2R), computed and returned in ``dtype`` (the head
    compute dtype)."""

    def __init__(self, num_classes: int, in_ch: int = 256, conv_dim: int = 256, num_conv: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_conv = num_conv
        self.dtype = dtype
        for i in range(num_conv):
            self.add_module(f"mask_fcn{i + 1}", nn.Conv2d(in_ch if i == 0 else conv_dim, conv_dim, 3, padding=1))
        self.deconv = nn.ConvTranspose2d(conv_dim if num_conv else in_ch, conv_dim, 2, stride=2)
        self.predictor = nn.Conv2d(conv_dim, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for i in range(self.num_conv):
            x = F.relu(conv(getattr(self, f"mask_fcn{i + 1}"), x))
        return conv(self.predictor, F.relu(conv(self.deconv, x)))


def box_inference(scores_logits: torch.Tensor, deltas: torch.Tensor, proposals: torch.Tensor,
                  proposal_valid: torch.Tensor, image_hw: tuple[int, int], cfg: ROIConfig) -> dict[str, torch.Tensor]:
    """fast_rcnn_inference for a batch, fixed output capacity.

    scores_logits (B, N, K + 1), deltas (B, N, K, 4), proposals (B, N, 4),
    proposal_valid (B, N).  Returns boxes (B, D, 4), scores (B, D), classes
    (B, D) int64, valid (B, D) with D = min(detections_per_image, cap).
    """
    k = cfg.num_classes
    nb, n = scores_logits.shape[:2]
    dev = scores_logits.device
    probs = torch.softmax(scores_logits, dim=-1)[..., :k]
    boxes = clip_boxes(apply_deltas(deltas, proposals[:, :, None, :].expand(nb, n, k, 4), cfg.bbox_reg_weights),
                       image_hw)
    flat_scores = probs.reshape(nb, n * k)
    flat_boxes = boxes.reshape(nb, n * k, 4)
    flat_cls = torch.arange(k, device=dev).repeat(n)
    valid = (flat_scores > cfg.score_thresh_test) & proposal_valid[:, :, None].expand(nb, n, k).reshape(nb, n * k)
    # Keep the NMS problem small: pre-select the top candidates by score.
    cap = min(4 * cfg.detections_per_image, n * k)
    neg_inf = torch.full((), float("-inf"), device=dev)
    idx = descending_order(torch.where(valid, flat_scores, neg_inf))[:, :cap]
    cand_scores = torch.gather(torch.where(valid, flat_scores, neg_inf), 1, idx)
    cand_boxes = torch.gather(flat_boxes, 1, idx[..., None].expand(nb, cap, 4))
    cand_cls = flat_cls[idx]
    keep = batched_nms(cand_boxes, cand_scores, cand_cls, cfg.nms_thresh_test, torch.isfinite(cand_scores))
    kept_scores = torch.where(keep, cand_scores, neg_inf)
    d = min(cfg.detections_per_image, cap)
    fidx = descending_order(kept_scores)[:, :d]
    final = torch.gather(kept_scores, 1, fidx)
    ok = torch.isfinite(final)
    return {
        "boxes": torch.gather(cand_boxes, 1, fidx[..., None].expand(nb, d, 4)),
        "scores": torch.where(ok, final, torch.zeros((), device=dev)),
        "classes": torch.gather(cand_cls, 1, fidx),
        "valid": ok,
    }
