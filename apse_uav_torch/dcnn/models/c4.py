"""Mask R-CNN C4: res4 backbone, single-level RPN, res5 ROI head.

Counterpart of the JAX reference's ``dcnn/models/c4.py``, the
``mask_rcnn_R_{50,101}_C4_3x.yaml`` family: detectron2's ``Res5ROIHeads``.
The RPN runs on the one res4 map (stride 16, every anchor size on it);
ROIAlign(14, 1/16, ``aligned=False``, as the reference pools) on res4 feeds
the res5 stage (stride-2 first block), the box predictor reads the 7x7 mean
of its 2048 channels, and the mask head (a transposed convolution and a 1x1
predictor, no 3x3 convolutions) reads the same res5 features: in training
those of the sampled proposals, at inference those of the final detection
boxes, on which the res5 transform runs again.

Module names are detectron2's (``backbone.res2`` .. ``backbone.res4``,
``proposal_generator.rpn_head``, ``roi_heads.res5``,
``roi_heads.box_predictor``, ``roi_heads.mask_head``), so a zoo C4
checkpoint loads key for key.  The entry points are :class:`MaskRCNN`'s
(``features``, ``proposals``, ``detect``, ``inference`` returning
(detections, maps), ``training_proposals``, ``losses``), and so are the
compute dtypes: res5 follows the backbone's, the RPN and mask heads the
head dtype.  :func:`build_model` picks the class of a config.

Tracing (``utils/profiling.py``): at inference the res5 transform and the
box predictor on the proposals are the span ``track.res5_box``, the rerun on
the detection boxes and the mask head ``track.res5_mask``; every
:meth:`MaskRCNNC4.roi_transform` counts its B * N ROIs under the counter
``c4.res5_rois`` (from the shapes: no sync).
"""

from __future__ import annotations

import torch
from torch import nn

from apse_uav_torch.dcnn.config import ModelConfig
from apse_uav_torch.dcnn.models.mask_rcnn import MaskRCNN, check_supported, compute_dtypes, image_keys
from apse_uav_torch.dcnn.models.resnet import ResNet, Res5Stage, memory_format
from apse_uav_torch.dcnn.models.roi_heads import (BoxPredictor, MaskHead, box_head_losses, box_inference,
                                                 crop_resize_masks, mask_head_loss, match_proposals_to_gt)
from apse_uav_torch.dcnn.models.rpn import RPNHead, rpn_losses, select_proposals
from apse_uav_torch.dcnn.ops.roi_align import roi_align_hwc
from apse_uav_torch.utils import profiling

RPN_LEVELS_C4 = ("res4",)
C4_STRIDE = 16
RES5_CHANNELS = 2048


class C4Backbone(ResNet):
    """The trunk up to res4: NHWC normalised images -> NHWC res2..res4 maps
    in ``dtype`` (the compute dtype)."""

    def __init__(self, depth: int, stride_in_1x1: bool, dtype: torch.dtype):
        super().__init__(depth, stride_in_1x1, max_stage=4)
        self.dtype = dtype

    def forward(self, x_nhwc: torch.Tensor) -> dict[str, torch.Tensor]:
        x = x_nhwc.permute(0, 3, 1, 2).to(self.dtype)
        res = super().forward(x.contiguous(memory_format=memory_format(self.dtype)))
        return {k: v.permute(0, 2, 3, 1) for k, v in res.items()}


class C4BoxPredictor(BoxPredictor):
    """FastRCNNOutputLayers over the mean-pooled 2048 res5 channels (no FC
    trunk): class logits (N, K + 1) and class-specific deltas (N, K, 4)."""

    def __init__(self, num_classes: int):
        super().__init__(RES5_CHANNELS, num_classes)


class Res5ROIHeads(nn.Module):
    """res5, the box predictor over its pooled 2048 channels and (with masks)
    the mask head (detectron2 ``roi_heads.*`` of a C4 model)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        dtype, head_dtype = compute_dtypes(cfg)
        roi = cfg.roi
        self.res5 = Res5Stage(cfg.depth, cfg.stride_in_1x1, dtype)
        self.box_predictor = C4BoxPredictor(roi.num_classes)
        if cfg.mask_on:
            self.mask_head = MaskHead(roi.num_classes, RES5_CHANNELS, roi.mask_conv_dim, 0, head_dtype)


class MaskRCNNC4(nn.Module):
    """Mask R-CNN R-C4 (see the module docstring).

    Example:
        model = build_model(mask_rcnn_r101_c4(80)).to("cuda").eval()
        weights.load_detectron2(model, weights.load_torch_file("model_final.pkl"))
        dets, feats = model.inference(images)   # feats: res2..res4
    """

    keys_per_image = 2  # the reference's C4 splits a step's key into 2B

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        dtype, head_dtype = compute_dtypes(cfg)
        self.backbone = C4Backbone(cfg.depth, cfg.stride_in_1x1, dtype)
        self.proposal_generator = nn.ModuleDict(
            {"rpn_head": RPNHead(cfg.anchors.num_cell_anchors, 1024, head_dtype)})
        self.roi_heads = Res5ROIHeads(cfg)
        self.register_buffer("pixel_mean", torch.tensor(cfg.input.pixel_mean, dtype=torch.float32), persistent=False)
        self.register_buffer("pixel_std", torch.tensor(cfg.input.pixel_std, dtype=torch.float32), persistent=False)

    def features(self, images: torch.Tensor) -> dict[str, torch.Tensor]:
        """images (B, H, W, 3) float in the configured channel order -> NHWC res2..res4."""
        return self.backbone((images - self.pixel_mean) / self.pixel_std)

    def rpn_outputs(self, feats: dict[str, torch.Tensor]):
        """The RPN head on res4, its outputs in float32 (the reference casts
        them in C4 inference and training), and the level shapes."""
        logits, deltas = self.proposal_generator["rpn_head"]({n: feats[n] for n in RPN_LEVELS_C4})
        return ({k: v.float() for k, v in logits.items()}, {k: v.float() for k, v in deltas.items()},
                {n: tuple(feats[n].shape[1:3]) for n in RPN_LEVELS_C4})

    def proposals(self, feats: dict[str, torch.Tensor], image_hw: tuple[int, int],
                  levels: tuple[str, ...] | None = None):
        """RPN head + proposal selection -> (boxes (B, P, 4), scores (B, P), valid (B, P))."""
        logits, deltas, level_shapes = self.rpn_outputs(feats)
        return select_proposals(logits, deltas, level_shapes, image_hw, self.cfg.anchors, self.cfg.rpn,
                                levels=levels)

    @torch.no_grad()
    def training_proposals(self, images: torch.Tensor, features: dict | None = None):
        """The proposals :meth:`losses` samples from (the ``*_topk_train``
        budgets): (boxes (B, P, 4), valid (B, P))."""
        feats = self.features(images) if features is None else features
        logits, deltas, level_shapes = self.rpn_outputs(feats)
        boxes, _, valid = select_proposals(logits, deltas, level_shapes, tuple(images.shape[1:3]), self.cfg.anchors,
                                           self.cfg.rpn, training=True)
        return boxes, valid

    def roi_transform(self, res4: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """ROIAlign(14, 1/16, not aligned) of each image's boxes on its res4
        map, then res5: res4 (B, H, W, 1024), boxes (B, N, 4) -> (B * N,
        2048, 7, 7) in the backbone's dtype."""
        roi = self.cfg.roi
        profiling.count("c4.res5_rois", boxes.shape[0] * boxes.shape[1])
        pooled = torch.cat([roi_align_hwc(res4[i], boxes[i], roi.box_pooler_resolution, 1.0 / C4_STRIDE,
                                          roi.pooler_sampling_ratio, aligned=False)
                            for i in range(boxes.shape[0])])
        return self.roi_heads.res5(pooled)

    def box_outputs(self, x5: torch.Tensor, nb: int, n: int):
        """The box predictor on the 7x7 mean of res5 (float32): (B, N, K + 1), (B, N, K, 4)."""
        cls_logits, box_deltas = self.roi_heads.box_predictor(x5.mean(dim=(2, 3)).float())
        return cls_logits.float().reshape(nb, n, -1), box_deltas.float().reshape(nb, n, self.cfg.roi.num_classes, 4)

    def detect(self, feats: dict[str, torch.Tensor], boxes: torch.Tensor, valid: torch.Tensor,
               image_hw: tuple[int, int]) -> dict[str, torch.Tensor]:
        """ROI heads on the proposals: boxes (B, D, 4), scores, classes, valid
        and (with masks) masks (B, D, 14, 14) float32, the sigmoid of each
        detection's own class channel, from res5 rerun on the detection boxes."""
        cfg = self.cfg.roi
        nb, p = boxes.shape[:2]
        with profiling.span("track.res5_box"):
            cls_logits, box_deltas = self.box_outputs(self.roi_transform(feats["res4"], boxes), nb, p)
        det = box_inference(cls_logits, box_deltas, boxes, valid, image_hw, cfg)
        if self.cfg.mask_on:
            d = det["boxes"].shape[1]
            with profiling.span("track.res5_mask"):
                logits = self.roi_heads.mask_head(self.roi_transform(feats["res4"], det["boxes"])).float()
                cls = det["classes"].clamp(0, cfg.num_classes - 1).reshape(nb * d)
                sel = logits[torch.arange(nb * d, device=logits.device), cls]
                det["masks"] = torch.sigmoid(sel).reshape(nb, d, *sel.shape[1:])
        return det

    @torch.no_grad()
    def inference(self, images: torch.Tensor, rpn_levels: tuple[str, ...] | None = None):
        """images (B, H, W, 3) -> (detections, backbone maps res2..res4)."""
        image_hw = tuple(images.shape[1:3])
        feats = self.features(images)
        boxes, _, valid = self.proposals(feats, image_hw, rpn_levels)
        return self.detect(feats, boxes, valid, image_hw), feats

    def losses(self, images: torch.Tensor, gt: dict[str, torch.Tensor], key, gt_proposals: bool = False,
               freeze_backbone: bool = False, mark=None, proposals=None,
               features: dict | None = None) -> dict[str, torch.Tensor]:
        """The training losses of a batch, with :meth:`MaskRCNN.losses`'
        arguments and results; the key is split into 2B keys (the first B
        sample the anchors, the next B the proposals), and the mask head
        reads the res5 features of the sampled proposals, the box
        predictor's own."""
        cfg = self.cfg
        mark = mark or (lambda stage: None)
        if features is not None:
            if not freeze_backbone:
                raise ValueError("features are given: the backbone takes no gradient (freeze_backbone=True)")
            feats = features
        elif freeze_backbone:
            with torch.no_grad():
                feats = self.features(images)
        else:
            feats = self.features(images)
        mark("features")
        image_hw = tuple(images.shape[1:3])
        b = images.shape[0]
        keys = image_keys(key, b, self.keys_per_image)
        if gt_proposals:
            losses = {}
            boxes, valid = gt["boxes"], gt["valid"]
        else:
            logits, deltas, level_shapes = self.rpn_outputs(feats)
            losses = rpn_losses(keys[:b], logits, deltas, level_shapes, gt["boxes"], gt["valid"], cfg.anchors,
                                cfg.rpn)
            if proposals is not None:
                boxes, valid = proposals
            else:
                with torch.no_grad():
                    boxes, _, valid = select_proposals({k: v.detach() for k, v in logits.items()},
                                                       {k: v.detach() for k, v in deltas.items()}, level_shapes,
                                                       image_hw, cfg.anchors, cfg.rpn, training=True)
        mark("rpn")
        roi = cfg.roi
        sample = match_proposals_to_gt(keys[b:2 * b], boxes, valid, gt["boxes"], gt["classes"], gt["valid"], roi)
        s = sample["boxes"].shape[1]
        x5 = self.roi_transform(feats["res4"], sample["boxes"])
        cls_logits, box_deltas = self.box_outputs(x5, b, s)
        losses.update(box_head_losses(cls_logits, box_deltas, sample, gt["boxes"], roi))
        if cfg.mask_on and "masks" in gt:
            mask_logits = self.roi_heads.mask_head(x5).float()
            target = crop_resize_masks(gt["masks"] > 0.5, sample["matched_gt"], sample["boxes"], image_hw,
                                       2 * roi.mask_pooler_resolution)
            losses["loss_mask"] = mask_head_loss(mask_logits.reshape(b, s, *mask_logits.shape[1:]), sample, target,
                                                 roi)
        losses = {k: v.mean() for k, v in losses.items()}
        mark("roi")
        return losses


def build_model(cfg: ModelConfig) -> MaskRCNN | MaskRCNNC4:
    """The model of ``cfg.architecture``: 'fpn' and 'vitdet' -> MaskRCNN, 'c4' -> MaskRCNNC4."""
    check_supported(cfg)
    return MaskRCNNC4(cfg) if cfg.architecture == "c4" else MaskRCNN(cfg)
