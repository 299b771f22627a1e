"""Typed configuration of the DCNN method (Mask R-CNN detector + tracker).

The port's own copy of the JAX reference's ``dcnn/config.py``: the same
frozen dataclasses, fields, defaults and presets, so a configuration built in
either package reads the same.  Presets mirror the reference's detectron2
YAML configs (Base-RCNN-FPN.yaml and its R50/R101 variants).  The port adds
the ResNeXt fields and the X101-32x8d-FPN preset, and the ViTDet fields
(:class:`ViTConfig`, the head convolution counts and norms, the square pad)
and the ViTDet-B preset, which the reference lacks; their defaults are the
reference's R-FPN.  Configurations carry across packages
through ``apse_uav_torch.convert.model_config`` and ``tracker_config``
(``dataclasses.asdict`` of the JAX ones).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AnchorConfig:
    """Anchor generation (Base-RCNN-FPN.yaml:9-12)."""

    # One entry per RPN level.  FPN: one float per pyramid level; C4: a
    # single entry that is itself a tuple (all sizes on the res4 level).
    sizes: tuple = (32.0, 64.0, 128.0, 256.0, 512.0)
    aspect_ratios: tuple[float, ...] = (0.5, 1.0, 2.0)
    offset: float = 0.0

    @property
    def num_cell_anchors(self) -> int:
        per_level = self.sizes[0]
        n_sizes = len(per_level) if isinstance(per_level, tuple) else 1
        return n_sizes * len(self.aspect_ratios)


@dataclasses.dataclass(frozen=True)
class RPNConfig:
    """RPN head + proposal selection (Base-RCNN-FPN.yaml:13-21)."""

    pre_nms_topk_train: int = 2000  # per level
    pre_nms_topk_test: int = 1000
    post_nms_topk_train: int = 1000  # total
    post_nms_topk_test: int = 1000
    nms_thresh: float = 0.7
    min_size: float = 0.0
    loss_weight: float = 1.0
    batch_size_per_image: int = 256
    positive_fraction: float = 0.5
    iou_fg_thresh: float = 0.7
    iou_bg_thresh: float = 0.3
    smooth_l1_beta: float = 0.0
    # 3x3 ReLU convolutions of the head before its 1x1s (detectron2
    # StandardRPNHead conv_dims: [-1] one, named ``conv``; [-1, -1] two,
    # named ``conv.conv0``, ``conv.conv1``).
    num_conv: int = 1


@dataclasses.dataclass(frozen=True)
class ROIConfig:
    """StandardROIHeads + box/mask heads (Base-RCNN-FPN.yaml:22-31)."""

    num_classes: int = 80
    score_thresh_test: float = 0.05
    nms_thresh_test: float = 0.5
    detections_per_image: int = 100
    box_pooler_resolution: int = 7
    mask_pooler_resolution: int = 14
    # detectron2 uses adaptive sampling (ceil of bin size): with FPN level
    # assignment bins are ~1-2 px, so ratio 1 is the closest static choice
    # and costs 4x less gather traffic than 2.
    pooler_sampling_ratio: int = 1
    box_fc_dim: int = 1024
    num_box_fc: int = 2
    mask_conv_dim: int = 256
    num_mask_conv: int = 4
    # FastRCNNConvFCHead conv_dims: 3x3 ReLU convolutions of the pooled
    # channels' width before the FCs (``box_head.conv1`` ...); 0 = FCs only.
    num_box_conv: int = 0
    # conv_norm of the box and mask heads' 3x3 convolutions: "" (with a
    # bias) or "LN" (bias-free, then detectron2's channel LayerNorm).
    conv_norm: str = ""
    bbox_reg_weights: tuple[float, float, float, float] = (10.0, 10.0, 5.0, 5.0)
    batch_size_per_image: int = 512
    positive_fraction: float = 0.25
    iou_thresh: float = 0.5
    smooth_l1_beta: float = 0.0


@dataclasses.dataclass(frozen=True)
class InputConfig:
    """Image preprocessing (detectron2 INPUT.* + MODEL.PIXEL_*).

    The pipeline is static-shape: images are resized (shortest edge,
    capped at max_size) then padded to ``pad_divisibility``-aligned fixed
    dims derived from (min_size_test, max_size_test).
    """

    min_size_test: int = 800
    max_size_test: int = 1333
    pad_divisibility: int = 32
    # Channel order the model takes: frames arrive BGR (cv2), and "RGB"
    # flips them before the resize (detectron2's read_image(format="RGB")).
    format: str = "BGR"
    pixel_mean: tuple[float, float, float] = (103.530, 116.280, 123.675)
    pixel_std: tuple[float, float, float] = (1.0, 1.0, 1.0)
    # detectron2's square_pad: 0 = the reference's pad of the raw pixels with
    # 0 to pad_divisibility, boxes clipped to that padded extent; > 0 = the
    # image normalised, then zero-padded to square_size x square_size, and
    # boxes clipped to the resized image (ImageList.from_tensors' order).
    square_size: int = 0


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """A plain ViT trunk under its simple feature pyramid (detectron2 ``ViT``
    and ``SimpleFeaturePyramid``, mask_rcnn_vitdet.py); ViT-B by default.
    The rest is ViTDet's own and fixed in ``models/vit.py``: qkv with a bias,
    LayerNorm eps 1e-6, decomposed relative positions in every block, the
    position table of the 224 / 16 pre-training grid with a cls slot, the
    pyramid's scales 4, 2, 1 and 1/2 with LayerNorm."""

    img_size: int = 1024  # the square input; global blocks see img_size / patch_size tokens a side
    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    # Blocks that attend inside window_size x window_size windows; the others attend globally.
    window_size: int = 14
    window_block_indexes: tuple[int, ...] = (0, 1, 3, 4, 6, 7, 9, 10)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Full Mask R-CNN model config (mirrors one merged detectron2 cfg)."""

    depth: int = 50  # ResNet depth: 50 or 101
    mask_on: bool = True
    stride_in_1x1: bool = True  # caffe-style bottlenecks (model-zoo weights)
    # ResNeXt (detectron2 RESNETS.NUM_GROUPS, WIDTH_PER_GROUP): each
    # bottleneck's 3x3 convolution in num_groups groups, the bottleneck
    # num_groups * width_per_group * 2**stage wide.  1 and 64: plain ResNet.
    num_groups: int = 1
    width_per_group: int = 64
    # "fpn" (Base-RCNN-FPN.yaml), "c4" (Base-RCNN-C4.yaml: res4 backbone,
    # single-level RPN, res5 ROI head) or "vitdet" (mask_rcnn_vitdet.py: the
    # ViT of ``vit`` and its simple feature pyramid in place of ResNet +
    # FPN).  models.build_model dispatches.
    architecture: str = "fpn"
    fpn_channels: int = 256
    anchors: AnchorConfig = AnchorConfig()
    rpn: RPNConfig = RPNConfig()
    roi: ROIConfig = ROIConfig()
    input: InputConfig = InputConfig()
    vit: ViTConfig = ViTConfig()  # read only by architecture="vitdet"
    # Numerics: convs/matmuls run in this dtype (params stay f32).
    compute_dtype: str = "float32"
    # Head (RPN/box/mask) compute dtype; "" = follow compute_dtype.  The
    # FLOP mass is the backbone, so "bfloat16" compute with
    # head_compute_dtype="float32" keeps nearly all of the bf16 speed while
    # the small, numerically sensitive heads train in f32 (the all-bf16
    # regime missed the scratch-training AP50 bar; see
    # tests/test_learning_regression.py).
    head_compute_dtype: str = ""

    @property
    def num_levels(self) -> int:
        return len(self.anchors.sizes)


def mask_rcnn_r50_fpn(num_classes: int = 80, **overrides) -> ModelConfig:
    """mask_rcnn_R_50_FPN_3x.yaml equivalent."""
    cfg = ModelConfig(depth=50)
    cfg = dataclasses.replace(cfg, roi=dataclasses.replace(cfg.roi, num_classes=num_classes))
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def mask_rcnn_r101_fpn(num_classes: int = 80, **overrides) -> ModelConfig:
    """mask_rcnn_R_101_FPN_3x.yaml equivalent."""
    cfg = ModelConfig(depth=101)
    cfg = dataclasses.replace(cfg, roi=dataclasses.replace(cfg.roi, num_classes=num_classes))
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def mask_rcnn_x101_32x8d_fpn(num_classes: int = 80, **overrides) -> ModelConfig:
    """mask_rcnn_X_101_32x8d_FPN_3x.yaml equivalent: R101-FPN with 32 groups
    of 8 channels in res2's 3x3 (256 wide, 2048 in res5), the stride on the
    3x3 (a C2 model) and the ImageNet pixel std of the FAIR weights."""
    cfg = mask_rcnn_r101_fpn(num_classes, stride_in_1x1=False, num_groups=32, width_per_group=8)
    cfg = dataclasses.replace(cfg, input=dataclasses.replace(cfg.input, pixel_std=(57.375, 57.120, 58.395)))
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def mask_rcnn_vitdet_b(num_classes: int = 80, **overrides) -> ModelConfig:
    """ViTDet's mask_rcnn_vitdet_b_100ep.py over mask_rcnn_vitdet.py: ViT-B
    (12 blocks of width 768, 12 heads, global attention in blocks 2, 5, 8
    and 11, 14x14 windows elsewhere, decomposed relative positions) on
    1024x1024 RGB squares, its simple feature pyramid with LN, a two-conv
    RPN head, a 4conv1fc box head and a mask head, both with LN."""
    cfg = ModelConfig(architecture="vitdet")
    cfg = dataclasses.replace(
        cfg,
        rpn=dataclasses.replace(cfg.rpn, num_conv=2),
        roi=dataclasses.replace(cfg.roi, num_classes=num_classes, num_box_conv=4, num_box_fc=1, conv_norm="LN"),
        input=InputConfig(min_size_test=1024, max_size_test=1024, format="RGB", pixel_mean=(123.675, 116.28, 103.53),
                          pixel_std=(58.395, 57.12, 57.375), square_size=1024),
    )
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def _c4_config(depth: int, num_classes: int, **overrides) -> ModelConfig:
    """Base-RCNN-C4.yaml + mask_rcnn_R_{50,101}_C4_3x.yaml equivalents.

    detectron2 C4 defaults: single-level RPN on res4 with all five anchor
    sizes, PRE_NMS 12000/6000, POST 2000/1000 (Base-RCNN-C4.yaml:4-5 sets
    the test pair), Res5ROIHeads with a 14x14 pooler and 14x14 masks."""
    cfg = ModelConfig(depth=depth, architecture="c4")
    cfg = dataclasses.replace(
        cfg,
        anchors=dataclasses.replace(cfg.anchors, sizes=((32.0, 64.0, 128.0, 256.0, 512.0),)),
        rpn=dataclasses.replace(
            cfg.rpn,
            pre_nms_topk_train=12000,
            pre_nms_topk_test=6000,
            post_nms_topk_train=2000,
            post_nms_topk_test=1000,
        ),
        roi=dataclasses.replace(
            cfg.roi,
            num_classes=num_classes,
            box_pooler_resolution=14,
            mask_pooler_resolution=7,  # C4 masks are 14x14 = 2 * 7
        ),
    )
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def mask_rcnn_r50_c4(num_classes: int = 80, **overrides) -> ModelConfig:
    """mask_rcnn_R_50_C4_3x.yaml equivalent."""
    return _c4_config(50, num_classes, **overrides)


def mask_rcnn_r101_c4(num_classes: int = 80, **overrides) -> ModelConfig:
    """mask_rcnn_R_101_C4_3x.yaml equivalent."""
    return _c4_config(101, num_classes, **overrides)


def uav_tracker_config(num_classes: int = 4) -> ModelConfig:
    """The fine-tuned 4-class vehicle detector used by the tracker
    (reference: visualize_uav.py:24-53 — confidence 0.5, 4 classes)."""
    cfg = mask_rcnn_r101_fpn(num_classes=num_classes)
    return dataclasses.replace(
        cfg, roi=dataclasses.replace(cfg.roi, score_thresh_test=0.5)
    )


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """RcnnTracker thresholds (reference: dcnn/engines/rcnn_tracker.py:32-47)."""

    # Fixed capacities: sized for the UAV scenario (a handful of vehicles,
    # tracks persisting 100 undetected frames).  The Hungarian assignment is
    # O(capacity^2) sequential device work — keep these tight.
    max_tracks: int = 32
    max_detections: int = 32
    roi_size: int = 10
    association_metric: str = "embeddings"  # bbox_center_dist | mask_iou | embeddings
    embedding_dim: int = 128
    center_dist_threshold: float = 100.0
    mask_iou_threshold: float = 0.7
    embedding_dist_threshold: float = 0.6
    delete_after_undetected: int = 100
