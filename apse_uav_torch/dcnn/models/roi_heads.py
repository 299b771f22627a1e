"""StandardROIHeads: FPN pooling, box head, mask head, matching and losses.

Counterpart of the JAX reference's ``dcnn/models/roi_heads.py``: detectron2's
StandardROIHeads + FastRCNNConvFCHead + MaskRCNNConvUpsampleHead with
fixed-capacity proposals and detections (validity masks) and the exact
fixed-point NMS, batched over images.  The reference's ``BoxHead`` is here
the FC trunk :class:`BoxHead` plus :class:`BoxPredictor`, named as
detectron2 names them (``roi_heads.box_head.fc1``,
``roi_heads.box_predictor.cls_score``).  The training functions
(``match_proposals_to_gt``, the box and mask losses, the GT mask targets)
are the reference's, batched over images: each returns one loss per image.
``paste_masks`` pastes mask probabilities into full-image masks (the
tracker pastes its own way, ``tracker.paste_mask_lowres``).
ViTDet's heads are detectron2's with ``conv_dims`` and ``conv_norm``:
:class:`ConvFCBoxHead` (convolutions before the FC trunk) and
:class:`NormMaskHead` (LayerNorm after each convolution), float32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apse_uav_torch.dcnn.config import ROIConfig
from apse_uav_torch.dcnn.losses import max0
from apse_uav_torch.dcnn.models.resnet import ConvLN, conv
from apse_uav_torch.dcnn.models.rpn import smooth_l1, subsample_labels, take_rows
from apse_uav_torch.dcnn.ops import apply_deltas, box_iou, clip_boxes, get_deltas
from apse_uav_torch.dcnn.ops.nms import batched_nms, descending_order
from apse_uav_torch.dcnn.ops.roi_align import roi_align_hwc, sample_grid

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


def fpn_roi_align_dense(feats: dict[str, torch.Tensor], boxes: torch.Tensor, resolution: int,
                        sampling_ratio: int) -> torch.Tensor:
    """The reference's formulation of :func:`fpn_roi_align`, kept as its
    oracle: every box pooled on every level from bfloat16 rows, then each
    box's assigned level selected.  feats[p2..p5] (B, H, W, C), boxes (B, N, 4)
    -> (B, N, C, R, R) float32."""
    lvl = assign_boxes_to_levels(boxes)
    out = []
    for b in range(boxes.shape[0]):
        pooled = torch.stack([
            roi_align_hwc(feats[name][b].to(torch.bfloat16), boxes[b], resolution, 1.0 / (4 * 2**i), sampling_ratio,
                          aligned=True).to(torch.float32)
            for i, name in enumerate(POOL_LEVELS)])  # (4, N, C, R, R)
        out.append(pooled[lvl[b], torch.arange(boxes.shape[1], device=boxes.device)])
    return torch.stack(out)


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


def conv_norm_layer(in_ch: int, out_ch: int, norm: str) -> nn.Conv2d:
    """A 3x3 convolution of detectron2's ``conv_norm``: with a bias for "",
    bias-free and followed by channel LayerNorm for "LN"."""
    return ConvLN(in_ch, out_ch, 3) if norm == "LN" else nn.Conv2d(in_ch, out_ch, 3, padding=1)


class ConvFCBoxHead(BoxHead):
    """FastRCNNConvFCHead with ``conv_dims``: ``num_conv`` 3x3 ReLU
    convolutions of the input's width (``conv1`` ...; ``norm`` as
    :func:`conv_norm_layer`) on each box's (C, R, R) features, then
    :class:`BoxHead`'s FC trunk on their flattened output.  Takes the pooled
    features flat, (N, C * R * R), as :class:`BoxHead` does; float32."""

    def __init__(self, channels: int, res: int, num_conv: int, fc_dim: int, num_fc: int, norm: str = ""):
        super().__init__(channels * res * res, fc_dim, num_fc)
        self.channels, self.res, self.num_conv = channels, res, num_conv
        for i in range(num_conv):
            self.add_module(f"conv{i + 1}", conv_norm_layer(channels, channels, norm))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], self.channels, self.res, self.res)
        for i in range(self.num_conv):
            x = F.relu(getattr(self, f"conv{i + 1}")(x))
        return super().forward(x)


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


class NormMaskHead(MaskHead):
    """:class:`MaskHead` with detectron2's ``conv_norm``: each 3x3
    convolution as :func:`conv_norm_layer` makes it ("LN": bias-free, then
    channel LayerNorm), then ReLU; float32."""

    def __init__(self, num_classes: int, in_ch: int = 256, conv_dim: int = 256, num_conv: int = 4, norm: str = "LN"):
        super().__init__(num_classes, in_ch, conv_dim, num_conv)
        for i in range(num_conv):
            self.add_module(f"mask_fcn{i + 1}", conv_norm_layer(in_ch if i == 0 else conv_dim, conv_dim, norm))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_conv):
            x = F.relu(getattr(self, f"mask_fcn{i + 1}")(x))
        return self.predictor(F.relu(self.deconv(x)))


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


def match_proposals_to_gt(keys: np.ndarray, proposals: torch.Tensor, proposal_valid: torch.Tensor,
                          gt_boxes: torch.Tensor, gt_classes: torch.Tensor, gt_valid: torch.Tensor,
                          cfg: ROIConfig) -> dict[str, torch.Tensor]:
    """label_and_sample_proposals for a batch (training).

    The GT boxes are appended to the proposals (detectron2), matched at
    ``iou_thresh``, and a balanced subsample of ``batch_size_per_image`` is
    taken with the keys (B, 2) uint32, one per image.  The selected rows come
    first, in their order (a stable sort), so each image gives S =
    min(batch_size_per_image, P + G) rows: boxes (B, S, 4), matched_gt,
    fg, sampled and gt_class (the background class K where not fg)."""
    all_boxes = torch.cat([proposals, gt_boxes], dim=1)
    all_valid = torch.cat([proposal_valid, gt_valid], dim=1)
    iou = torch.where(gt_valid[..., None], box_iou(gt_boxes, all_boxes), -1.0)
    matched_iou = iou.amax(dim=1)
    matched_idx = iou.argmax(dim=1)
    fg = (matched_iou >= cfg.iou_thresh) & all_valid
    bg = (matched_iou < cfg.iou_thresh) & all_valid
    labels = torch.where(fg, 1, torch.where(bg, 0, -1))
    sel = subsample_labels(keys, labels, cfg.batch_size_per_image, cfg.positive_fraction)
    take = torch.argsort((~sel).to(torch.uint8), dim=1, stable=True)[:, :cfg.batch_size_per_image]
    is_real = torch.gather(sel, 1, take)
    matched = torch.gather(matched_idx, 1, take)
    fg_take = torch.gather(fg, 1, take) & is_real
    return {
        "boxes": take_rows(all_boxes, take),
        "matched_gt": matched,
        "fg": fg_take,
        "sampled": is_real,
        "gt_class": torch.where(fg_take, torch.gather(gt_classes.to(torch.int64), 1, matched), cfg.num_classes),
    }


def box_head_losses(scores_logits: torch.Tensor, deltas: torch.Tensor, sample: dict[str, torch.Tensor],
                    gt_boxes: torch.Tensor, cfg: ROIConfig) -> dict[str, torch.Tensor]:
    """Softmax cross-entropy over the sampled rows and class-specific smooth
    L1 on the foreground ones, both over the sampled count: {name: (B,)}.
    scores_logits (B, S, K + 1), deltas (B, S, K, 4)."""
    valid = sample["sampled"]
    count = valid.sum(dim=1).clamp(min=1)
    log_probs = torch.log_softmax(scores_logits, dim=-1)
    ce = -torch.gather(log_probs, 2, sample["gt_class"][..., None])[..., 0]
    loss_cls = torch.where(valid, ce, 0.0).sum(dim=1) / count
    fg_class = sample["gt_class"].clamp(0, cfg.num_classes - 1)
    pred = torch.gather(deltas, 2, fg_class[..., None, None].expand(*fg_class.shape, 1, 4))[:, :, 0]
    target = get_deltas(sample["boxes"], take_rows(gt_boxes, sample["matched_gt"]), cfg.bbox_reg_weights)
    l1 = smooth_l1(pred, target, cfg.smooth_l1_beta).sum(dim=-1)
    loss_box = torch.where(sample["fg"], l1, 0.0).sum(dim=1) / count
    return {"loss_cls": loss_cls, "loss_box_reg": loss_box}


def mask_head_loss(mask_logits: torch.Tensor, sample: dict[str, torch.Tensor], gt_masks: torch.Tensor,
                   cfg: ROIConfig) -> torch.Tensor:
    """Per-pixel BCE of each fg row's matched class channel, over the fg
    count: (B,).  mask_logits (B, S, K, 2R, 2R), gt_masks (B, S, 2R, 2R)."""
    fg = sample["fg"]
    cls = sample["gt_class"].clamp(0, cfg.num_classes - 1)
    r2 = mask_logits.shape[-2:]
    logits = torch.gather(mask_logits, 2, cls[..., None, None, None].expand(*cls.shape, 1, *r2))[:, :, 0]
    labels = gt_masks.to(logits.dtype)
    bce = (max0(logits) - logits * labels + torch.log1p(torch.exp(-torch.abs(logits)))).mean(dim=(-2, -1))
    return torch.where(fg, bce, 0.0).sum(dim=1) / fg.sum(dim=1).clamp(min=1)


def crop_resize_masks(masks: torch.Tensor, matched: torch.Tensor, boxes: torch.Tensor, image_hw: tuple[int, int],
                      out_size: int) -> torch.Tensor:
    """Each sampled row's GT mask cropped to its box and resampled (nearest
    cell) to out_size x out_size: the reference's ``_gather_crop_resize_masks``.

    masks (B, G, Hm, Wm) bool at image resolution or a multiple of it,
    matched (B, S) gt index, boxes (B, S, 4) image coordinates ->
    (B, S, out, out) bool.  Only the sampled cells are read: no per-row copy
    of a full mask."""
    h, w = masks.shape[-2:]
    sy, sx = h / image_hw[0], w / image_hw[1]
    steps = (torch.arange(out_size, device=boxes.device) + 0.5) / out_size
    x1, y1, x2, y2 = boxes[..., 0] * sx, boxes[..., 1] * sy, boxes[..., 2] * sx, boxes[..., 3] * sy
    xs = x1[..., None] + steps * (x2 - x1).clamp(min=1e-4)[..., None]
    ys = y1[..., None] + steps * (y2 - y1).clamp(min=1e-4)[..., None]
    xi = xs.to(torch.int64).clamp(0, w - 1)
    yi = ys.to(torch.int64).clamp(0, h - 1)
    bi = torch.arange(masks.shape[0], device=masks.device)[:, None, None, None]
    return masks[bi, matched[..., None, None], yi[..., :, None], xi[..., None, :]]


def paste_masks(mask_probs: torch.Tensor, boxes: torch.Tensor, image_hw: tuple[int, int],
                threshold: float = 0.5) -> torch.Tensor:
    """(N, R, R) mask probabilities pasted into (N, H, W) boolean full-image
    masks, the reference's ``paste_masks`` (detectron2 paste_masks_in_image
    semantics: image pixel centres mapped into each box's mask cells,
    bilinear between the clamped neighbours, 0 outside the band (-1, R))."""
    h, w = image_hw
    n, r = mask_probs.shape[:2]
    dev = mask_probs.device
    x1, y1, x2, y2 = (boxes[:, i:i + 1] for i in range(4))
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5 - x1) / (x2 - x1).clamp(min=1e-4) * r - 0.5
    ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5 - y1) / (y2 - y1).clamp(min=1e-4) * r - 0.5
    x0, y0 = torch.floor(xs), torch.floor(ys)
    lx, ly = (xs - x0)[:, None, :], (ys - y0)[:, :, None]
    x0i = x0.to(torch.int64).clamp(0, r - 1)
    y0i = y0.to(torch.int64).clamp(0, r - 1)
    x1i, y1i = (x0i + 1).clamp(0, r - 1), (y0i + 1).clamp(0, r - 1)
    rows = torch.arange(n, device=dev)[:, None, None]

    def at(yi, xi):
        return mask_probs[rows, yi[:, :, None], xi[:, None, :]]

    val = (at(y0i, x0i) * (1 - lx) + at(y0i, x1i) * lx) * (1 - ly) + (at(y1i, x0i) * (1 - lx) + at(y1i, x1i) * lx) * ly
    inside = ((ys > -1.0) & (ys < r))[:, :, None] & ((xs > -1.0) & (xs < r))[:, None, :]
    return torch.where(inside, val, 0.0) >= threshold
