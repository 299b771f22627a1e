"""Mask R-CNN (GeneralizedRCNN with TrackRCNN semantics): inference and training losses.

Counterpart of the JAX reference's ``dcnn/models/mask_rcnn.py``: batched
NHWC images, fixed-capacity proposals and detections with validity masks, and
an ``inference`` that also returns the backbone maps (the tracker's re-ID
head reads p2).  The module tree is detectron2's, so ``state_dict()`` keys
are a GeneralizedRCNN checkpoint's (see :mod:`apse_uav_torch.dcnn.weights`).

The stages are methods of their own (``features``, ``proposals``,
``detect``) so a caller can time them apart; ``inference`` runs them in
order.  ``compute_dtype`` and ``head_compute_dtype`` work as in the
reference: parameters stay float32 and are cast at use, the backbone runs in
the compute dtype, the RPN head and mask head in the head dtype, ROIAlign
returns float32, and the box head computes in float32 on inputs rounded to
the head dtype.  Nothing is cast at the end: bf16 outputs meet float32
anchors and boxes under the reference's promotion rules, so in bfloat16 the
proposal scores and the masks come out bfloat16, the boxes float32.  The C4
architecture is :class:`~apse_uav_torch.dcnn.models.c4.MaskRCNNC4`;
``c4.build_model`` picks the class of a config.

``losses`` is the reference's training mode: every head output that a loss
reads is cast to float32 first, and each loss is the mean over the images of
the per-image losses.  This is also the reference's shipped bf16 training
regime (``compute_dtype="bfloat16"``, ``head_compute_dtype="float32"``):
float32 parameters, a bfloat16 backbone, float32 heads and float32 at the
loss boundary.  ``roi_features`` is the COWC ROI-feature mode (backbone,
box pooler and the box head's FC trunk on given boxes).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from apse_uav_torch.dcnn import flax_init
from apse_uav_torch.dcnn.config import ModelConfig
from apse_uav_torch.dcnn.models.resnet import ResNetFPN
from apse_uav_torch.dcnn.models.roi_heads import (POOL_LEVELS, BoxHead, BoxPredictor, ConvFCBoxHead, MaskHead,
                                                 NormMaskHead, box_head_losses, box_inference, crop_resize_masks,
                                                 fpn_roi_align, mask_head_loss, match_proposals_to_gt)
from apse_uav_torch.dcnn.models.rpn import RPNHead, rpn_losses, select_proposals
from apse_uav_torch.dcnn.models.vit import ViTFeaturePyramid
from apse_uav_torch.device import resolve_device

RPN_LEVELS = ("p2", "p3", "p4", "p5", "p6")


def check_supported(cfg: ModelConfig) -> None:
    """Raise on a ModelConfig the port does not run: an unknown architecture,
    compute dtype or head norm, a grouped (ResNeXt) C4, which detectron2's
    zoo does not have, or a ViTDet in bfloat16 or off its square input."""
    if cfg.architecture not in ("fpn", "c4", "vitdet"):
        raise ValueError(f"architecture={cfg.architecture!r}: use 'fpn', 'c4' or 'vitdet'")
    if cfg.architecture == "c4" and (cfg.num_groups, cfg.width_per_group) != (1, 64):
        raise ValueError(f"num_groups={cfg.num_groups}, width_per_group={cfg.width_per_group} with "
                         "architecture='c4': ResNeXt bottlenecks run only in 'fpn'")
    for field in ("compute_dtype", "head_compute_dtype"):
        if getattr(cfg, field) not in ("float32", "bfloat16", ""):
            raise ValueError(f"{field}={getattr(cfg, field)!r}: use 'float32' or 'bfloat16'")
    if cfg.roi.conv_norm not in ("", "LN"):
        raise ValueError(f"roi.conv_norm={cfg.roi.conv_norm!r}: use '' or 'LN'")
    if cfg.architecture == "vitdet":
        if compute_dtypes(cfg) != (torch.float32, torch.float32):
            raise ValueError("architecture='vitdet' runs in float32 only")
        if cfg.input.square_size != cfg.vit.img_size:
            raise ValueError(f"architecture='vitdet' takes img_size squares: input.square_size="
                             f"{cfg.input.square_size}, vit.img_size={cfg.vit.img_size}")


def image_keys(key, b: int, per_image: int) -> np.ndarray:
    """The training keys of a batch of ``b`` images: ``split(key, per_image * b)``
    of a (2,) uint32 key, whose first b sample the anchors and next b the
    proposals; a (k, 2) ``key`` is taken as that split already (a
    data-parallel rank's rows of the whole batch's split)."""
    key = np.asarray(key, np.uint32)
    return key if key.ndim == 2 else flax_init.split(key, per_image * b)


def compute_dtypes(cfg: ModelConfig) -> tuple[torch.dtype, torch.dtype]:
    """(backbone, head) compute dtypes of a config; an empty head dtype follows the backbone's."""
    return getattr(torch, cfg.compute_dtype), getattr(torch, cfg.head_compute_dtype or cfg.compute_dtype)


class ROIHeads(nn.Module):
    """The box head, box predictor and mask head (detectron2 ``roi_heads.*``)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        roi = cfg.roi
        head_dtype = compute_dtypes(cfg)[1]
        if roi.num_box_conv:
            self.box_head = ConvFCBoxHead(cfg.fpn_channels, roi.box_pooler_resolution, roi.num_box_conv,
                                          roi.box_fc_dim, roi.num_box_fc, roi.conv_norm)
        else:
            self.box_head = BoxHead(cfg.fpn_channels * roi.box_pooler_resolution**2, roi.box_fc_dim, roi.num_box_fc,
                                    head_dtype)
        self.box_predictor = BoxPredictor(roi.box_fc_dim, roi.num_classes)
        if cfg.mask_on and roi.conv_norm:
            self.mask_head = NormMaskHead(roi.num_classes, cfg.fpn_channels, roi.mask_conv_dim, roi.num_mask_conv,
                                          roi.conv_norm)
        elif cfg.mask_on:
            self.mask_head = MaskHead(roi.num_classes, cfg.fpn_channels, roi.mask_conv_dim, roi.num_mask_conv,
                                      head_dtype)


class MaskRCNN(nn.Module):
    """Mask R-CNN R-FPN for inference; for ``architecture="vitdet"`` ViTDet
    (:class:`~apse_uav_torch.dcnn.models.vit.ViTFeaturePyramid` in place of
    ResNet + FPN, maps p2..p6 only).

    Example:
        model = MaskRCNN(uav_tracker_config()).to("cuda").eval()
        weights.load_detectron2(model, weights.load_torch_file("model_final.pth"))
        dets, feats = model.inference(images)   # images (B, H, W, 3) f32 BGR
    """

    keys_per_image = 3  # the reference splits a step's key into 3B

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        check_supported(cfg)
        if cfg.architecture == "c4":
            raise ValueError(f"architecture={cfg.architecture!r} is not MaskRCNN's: build it with c4.build_model")
        self.cfg = cfg
        dtype, head_dtype = compute_dtypes(cfg)
        if cfg.architecture == "vitdet":
            self.backbone = ViTFeaturePyramid(cfg.vit, cfg.fpn_channels)
        else:
            self.backbone = ResNetFPN(cfg.depth, cfg.fpn_channels, cfg.stride_in_1x1, dtype, cfg.num_groups,
                                      cfg.width_per_group)
        self.proposal_generator = nn.ModuleDict(
            {"rpn_head": RPNHead(len(cfg.anchors.aspect_ratios), cfg.fpn_channels, head_dtype, cfg.rpn.num_conv)})
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
        (:func:`~apse_uav_torch.dcnn.models.rpn.select_proposals`)."""
        logits, deltas = self.proposal_generator["rpn_head"]({n: feats[n] for n in RPN_LEVELS})
        level_shapes = {n: tuple(feats[n].shape[1:3]) for n in RPN_LEVELS}
        return select_proposals(logits, deltas, level_shapes, image_hw, self.cfg.anchors, self.cfg.rpn,
                                levels=levels)

    @torch.no_grad()
    def training_proposals(self, images: torch.Tensor, features: dict | None = None):
        """The proposals :meth:`losses` samples from (the ``*_topk_train``
        budgets), from the images or their ``features``: (boxes (B, P, 4), valid (B, P))."""
        feats = self.features(images) if features is None else features
        logits, deltas = self.proposal_generator["rpn_head"]({n: feats[n] for n in RPN_LEVELS})
        level_shapes = {n: tuple(feats[n].shape[1:3]) for n in RPN_LEVELS}
        boxes, _, valid = select_proposals({k: v.float() for k, v in logits.items()},
                                           {k: v.float() for k, v in deltas.items()}, level_shapes,
                                           tuple(images.shape[1:3]), self.cfg.anchors, self.cfg.rpn, training=True)
        return boxes, valid

    def losses(self, images: torch.Tensor, gt: dict[str, torch.Tensor], key: np.ndarray, gt_proposals: bool = False,
               freeze_backbone: bool = False, mark=None, proposals=None,
               features: dict | None = None) -> dict[str, torch.Tensor]:
        """The training losses of a batch (the reference's ``losses`` mode).

        images (B, H, W, 3); gt: boxes (B, G, 4), classes (B, G), valid
        (B, G) and, with masks, masks (B, G, Hm, Wm) (full-image masks at
        image resolution or a multiple of it); key (2,) uint32, split into
        3B keys: the first B sample each image's anchors, the next B its
        proposals (or that split itself, :func:`image_keys`).  ``gt_proposals`` feeds the GT boxes to the ROI heads in
        place of the RPN's proposals (no RPN losses).  ``freeze_backbone``
        computes the features under ``no_grad``: the reference's
        ``stop_gradient``, with no convolution or ROIAlign backward.  Returns
        {name: scalar}: loss_rpn_loc, loss_rpn_cls (without
        ``gt_proposals``), loss_cls, loss_box_reg and, with masks, loss_mask.
        ``mark(stage)``, if given, is called as each stage ends ("features",
        "rpn", "roi"), e.g. to record a CUDA event.  ``proposals`` (boxes,
        valid), if given, replace the selected proposals (the RPN losses
        still run): top-k and NMS are discontinuous in the logits, so two
        devices compare a step on the same proposals
        (:meth:`training_proposals`).  ``features`` (the backbone's maps,
        without autograd) likewise replace the backbone's forward under
        ``freeze_backbone``: ROIAlign gathers from a bfloat16 copy of the
        maps, where a last-bit difference of a float32 value can move it by
        a whole bfloat16 step.
        """
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
            logits, deltas = self.proposal_generator["rpn_head"]({n: feats[n] for n in RPN_LEVELS})
            logits = {k: v.float() for k, v in logits.items()}
            deltas = {k: v.float() for k, v in deltas.items()}
            level_shapes = {n: tuple(feats[n].shape[1:3]) for n in RPN_LEVELS}
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
        heads = self.roi_heads
        pool_feats = {n: feats[n] for n in POOL_LEVELS}
        s = sample["boxes"].shape[1]
        pooled = fpn_roi_align(pool_feats, sample["boxes"], roi.box_pooler_resolution, roi.pooler_sampling_ratio)
        cls_logits, box_deltas = heads.box_predictor(heads.box_head(pooled.reshape(b * s, -1)))
        losses.update(box_head_losses(cls_logits.float().reshape(b, s, -1),
                                      box_deltas.float().reshape(b, s, roi.num_classes, 4), sample, gt["boxes"], roi))
        if cfg.mask_on and "masks" in gt:
            r2 = 2 * roi.mask_pooler_resolution
            mask_pooled = fpn_roi_align(pool_feats, sample["boxes"], roi.mask_pooler_resolution,
                                        roi.pooler_sampling_ratio)
            mask_logits = heads.mask_head(mask_pooled.reshape(b * s, *mask_pooled.shape[2:])).float()
            target = crop_resize_masks(gt["masks"] > 0.5, sample["matched_gt"], sample["boxes"], image_hw, r2)
            losses["loss_mask"] = mask_head_loss(mask_logits.reshape(b, s, *mask_logits.shape[1:]), sample, target,
                                                 roi)
        losses = {k: v.mean() for k, v in losses.items()}
        mark("roi")
        return losses

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

    @torch.no_grad()
    def roi_features(self, images: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """The COWC ROI-feature precompute (the reference's ``roi_features``
        mode): backbone, box pooler and the box head's FC trunk on the given
        boxes (B, N, 4) xyxy, no RPN and no predictors -> (B, N, fc_dim) float32."""
        feats = self.features(images)
        nb, n = boxes.shape[:2]
        roi = self.cfg.roi
        pooled = fpn_roi_align({k: feats[k] for k in POOL_LEVELS}, boxes, roi.box_pooler_resolution,
                               roi.pooler_sampling_ratio)
        return self.roi_heads.box_head(pooled.reshape(nb * n, -1)).reshape(nb, n, -1)


def build_mask_rcnn(cfg: ModelConfig, device="cuda") -> MaskRCNN:
    """The R-FPN model of ``cfg`` on ``device``, in eval mode (load its
    weights with :func:`apse_uav_torch.dcnn.weights.load_detectron2`)."""
    return MaskRCNN(cfg).to(resolve_device(device)).eval()


def run_inference(model: MaskRCNN, images: torch.Tensor):
    """The inference entry: images (B, H, W, 3) float32 BGR on the model's
    device -> (detections, backbone maps), without autograd."""
    with torch.no_grad():
        return model.inference(images)
