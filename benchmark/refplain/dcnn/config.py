"""Typed configuration of the DCNN method (Mask R-CNN detector + tracker).

The port's own copy of the JAX reference's ``dcnn/config.py``: the same
frozen dataclasses, fields, defaults and presets, so a configuration built in
either package reads the same.  Presets mirror the reference's detectron2
YAML configs (Base-RCNN-FPN.yaml and its R50/R101 variants).  Configurations
carry across packages through ``refplain.convert.model_config`` and
``tracker_config`` (``dataclasses.asdict`` of the JAX ones).
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
    format: str = "BGR"
    pixel_mean: tuple[float, float, float] = (103.530, 116.280, 123.675)
    pixel_std: tuple[float, float, float] = (1.0, 1.0, 1.0)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Full Mask R-CNN model config (mirrors one merged detectron2 cfg)."""

    depth: int = 50  # ResNet depth: 50 or 101
    mask_on: bool = True
    stride_in_1x1: bool = True  # caffe-style bottlenecks (model-zoo weights)
    # "fpn" (Base-RCNN-FPN.yaml) or "c4" (Base-RCNN-C4.yaml: res4 backbone,
    # single-level RPN, res5 ROI head).  models.build_model dispatches.
    architecture: str = "fpn"
    fpn_channels: int = 256
    anchors: AnchorConfig = AnchorConfig()
    rpn: RPNConfig = RPNConfig()
    roi: ROIConfig = ROIConfig()
    input: InputConfig = InputConfig()
    # Numerics: convs/matmuls run in this dtype (params stay f32).
    compute_dtype: str = "float32"
    # Head (RPN/box/mask) compute dtype; "" = follow compute_dtype.  The
    # FLOP mass is the backbone, so "bfloat16" compute with
    # head_compute_dtype="float32" keeps nearly all of the bf16 speed while
    # the small, numerically sensitive heads train in f32 (the all-bf16
    # regime missed the scratch-training AP50 bar; see
    # tests/test_learning_regression.py).
    head_compute_dtype: str = ""

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
