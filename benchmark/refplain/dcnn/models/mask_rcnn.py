"""Mask R-CNN (GeneralizedRCNN with TrackRCNN semantics): inference.

Counterpart of the JAX reference's ``dcnn/models/mask_rcnn.py``: batched
NHWC images, fixed-capacity proposals and detections with validity masks, and
an ``inference`` that also returns the backbone maps (the tracker's re-ID
head reads p2).  The module tree is detectron2's, so ``state_dict()`` keys
are a GeneralizedRCNN checkpoint's (see :mod:`refplain.dcnn.weights`).

The stages are methods of their own (``features``, ``proposals``,
``detect``) so a caller can time them apart; ``inference`` runs them in
order.  ``compute_dtype`` and ``head_compute_dtype`` work as in the
reference: parameters stay float32 and are cast at use, the backbone runs in
the compute dtype, the RPN head and mask head in the head dtype, ROIAlign
returns float32, and the box head computes in float32 on inputs rounded to
the head dtype.  Nothing is cast at the end: bf16 outputs meet float32
anchors and boxes under the reference's promotion rules, so in bfloat16 the
proposal scores and the masks come out bfloat16, the boxes float32.  Only
the R-FPN inference that the tracker cells run is kept here.
"""

from __future__ import annotations

import torch
from torch import nn

from refplain.dcnn.config import ModelConfig
from refplain.dcnn.models.resnet import ResNetFPN
from refplain.dcnn.models.roi_heads import POOL_LEVELS, BoxHead, BoxPredictor, MaskHead, box_inference, fpn_roi_align
from refplain.dcnn.models.rpn import RPNHead, select_proposals

RPN_LEVELS = ("p2", "p3", "p4", "p5", "p6")


def check_supported(cfg: ModelConfig) -> None:
    """Raise on a ModelConfig the port does not run: an unknown architecture or compute dtype."""
    if cfg.architecture != "fpn":
        raise ValueError(f"architecture={cfg.architecture!r}: the reference has only 'fpn'")
    for field in ("compute_dtype", "head_compute_dtype"):
        if getattr(cfg, field) not in ("float32", "bfloat16", ""):
            raise ValueError(f"{field}={getattr(cfg, field)!r}: use 'float32' or 'bfloat16'")


def compute_dtypes(cfg: ModelConfig) -> tuple[torch.dtype, torch.dtype]:
    """(backbone, head) compute dtypes of a config; an empty head dtype follows the backbone's."""
    return getattr(torch, cfg.compute_dtype), getattr(torch, cfg.head_compute_dtype or cfg.compute_dtype)


class ROIHeads(nn.Module):
    """The box head, box predictor and mask head (detectron2 ``roi_heads.*``)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        roi = cfg.roi
        head_dtype = compute_dtypes(cfg)[1]
        self.box_head = BoxHead(cfg.fpn_channels * roi.box_pooler_resolution**2, roi.box_fc_dim, roi.num_box_fc,
                                head_dtype)
        self.box_predictor = BoxPredictor(roi.box_fc_dim, roi.num_classes)
        if cfg.mask_on:
            self.mask_head = MaskHead(roi.num_classes, cfg.fpn_channels, roi.mask_conv_dim, roi.num_mask_conv,
                                      head_dtype)


class MaskRCNN(nn.Module):
    """Mask R-CNN R-FPN for inference.

    Example:
        model = MaskRCNN(cfg).to("cuda").eval()
        weights.load_detectron2(model, state_dict)
        dets, feats = model.inference(images)   # images (B, H, W, 3) f32 BGR
    """

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        dtype, head_dtype = compute_dtypes(cfg)
        self.backbone = ResNetFPN(cfg.depth, cfg.fpn_channels, cfg.stride_in_1x1, dtype)
        self.proposal_generator = nn.ModuleDict(
            {"rpn_head": RPNHead(len(cfg.anchors.aspect_ratios), cfg.fpn_channels, head_dtype)})
        self.roi_heads = ROIHeads(cfg)
        self.register_buffer("pixel_mean", torch.tensor(cfg.input.pixel_mean, dtype=torch.float32), persistent=False)
        self.register_buffer("pixel_std", torch.tensor(cfg.input.pixel_std, dtype=torch.float32), persistent=False)

    def features(self, images: torch.Tensor) -> dict[str, torch.Tensor]:
        """images (B, H, W, 3) float in the configured channel order -> NHWC
        res2..res5 and p2..p6 maps (the reference's ``backbone`` mode)."""
        return self.backbone((images - self.pixel_mean) / self.pixel_std)

    def proposals(self, feats: dict[str, torch.Tensor], image_hw: tuple[int, int],
                  levels: tuple[str, ...] | None = None):
        """RPN head + proposal selection -> (boxes (B, P, 4), scores (B, P),
        valid (B, P)); ``levels`` restricts the proposing levels
        (:func:`~refplain.dcnn.models.rpn.select_proposals`)."""
        logits, deltas = self.proposal_generator["rpn_head"]({n: feats[n] for n in RPN_LEVELS})
        level_shapes = {n: tuple(feats[n].shape[1:3]) for n in RPN_LEVELS}
        return select_proposals(logits, deltas, level_shapes, image_hw, self.cfg.anchors, self.cfg.rpn,
                                levels=levels)

    def detect(self, feats: dict[str, torch.Tensor], boxes: torch.Tensor, valid: torch.Tensor,
               image_hw: tuple[int, int]) -> dict[str, torch.Tensor]:
        """ROI heads on the proposals: boxes (B, D, 4), scores, classes, valid
        and (with masks) masks (B, D, 2R, 2R), the sigmoid of each
        detection's own class channel."""
        cfg = self.cfg.roi
        heads = self.roi_heads
        pool_feats = {n: feats[n] for n in POOL_LEVELS}
        nb, p = boxes.shape[:2]
        pooled = fpn_roi_align(pool_feats, boxes, cfg.box_pooler_resolution, cfg.pooler_sampling_ratio)
        cls_logits, box_deltas = heads.box_predictor(heads.box_head(pooled.reshape(nb * p, -1)))
        det = box_inference(cls_logits.reshape(nb, p, -1), box_deltas.reshape(nb, p, cfg.num_classes, 4), boxes,
                            valid, image_hw, cfg)
        if self.cfg.mask_on:
            d = det["boxes"].shape[1]
            mask_pooled = fpn_roi_align(pool_feats, det["boxes"], cfg.mask_pooler_resolution,
                                        cfg.pooler_sampling_ratio)
            logits = heads.mask_head(mask_pooled.reshape(nb * d, *mask_pooled.shape[2:]))
            cls = det["classes"].clamp(0, cfg.num_classes - 1).reshape(nb * d)
            sel = logits[torch.arange(nb * d, device=logits.device), cls]
            det["masks"] = torch.sigmoid(sel).reshape(nb, d, *sel.shape[1:])
        return det

    @torch.no_grad()
    def inference(self, images: torch.Tensor, rpn_levels: tuple[str, ...] | None = None):
        """images (B, H, W, 3) -> (detections, backbone maps); detections as
        :meth:`detect` returns them.  ``rpn_levels`` restricts the proposing
        levels (the reference's SelectiveMaskRCNN scan uses only p6)."""
        image_hw = tuple(images.shape[1:3])
        feats = self.features(images)
        boxes, _, valid = self.proposals(feats, image_hw, rpn_levels)
        return self.detect(feats, boxes, valid, image_hw), feats
