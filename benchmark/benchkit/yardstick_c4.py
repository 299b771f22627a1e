"""The FLOPs of the C4 tracker's model: 2 x the multiply-adds of every
convolution and product (``benchkit.yardstick``'s rule), for Mask R-CNN R-C4.

A frame: the trunk to res4 on the padded input; the RPN head on res4 (a
3 x 3 convolution of 1024 channels, 1 x 1 objectness and deltas for every
anchor); res5 and the box predictor on every post-NMS proposal; res5 again
and the mask head (the 2 x 2 transposed convolution 2048 -> 256 and the
1 x 1 predictor) on the detections kept; the re-ID head on the capped ones.
The resize to the network's input is left out, as in the R-FPN count.
"""

from __future__ import annotations

from benchkit.yardstick import _conv

RPN_CHANNELS, RES5_CHANNELS, RES4_STRIDE = 1024, 2048, 16


def stage_macs(depth: int, stage: int, h: int, w: int, cin: int, stride_in_1x1: bool = True):
    """ResNet stage ``stage`` (0 = res2 ... 3 = res5) on an (h, w, cin) input:
    (multiply-adds, output h, output w, output channels)."""
    from refplain.dcnn.models.resnet import STAGE_BLOCKS

    out, mid = 256 * 2 ** stage, 64 * 2 ** stage
    s = 1 if stage == 0 else 2
    ho, wo = h // s, w // s
    macs = 0
    for b in range(STAGE_BLOCKS[depth][stage]):
        c = cin if b == 0 else out
        h1, w1 = (ho, wo) if b > 0 or stride_in_1x1 else (h, w)
        macs += _conv(h1, w1, c, mid, 1) + _conv(ho, wo, mid, mid, 3) + _conv(ho, wo, mid, out, 1)
        if b == 0:
            macs += _conv(ho, wo, c, out, 1)  # the shortcut
    return macs, ho, wo, out


def trunk_macs(depth: int, h: int, w: int, stride_in_1x1: bool = True) -> int:
    """The stem and res2-res4 on an (h, w) padded input."""
    h, w = h // 2, w // 2
    macs = _conv(h, w, 3, 64, 7)
    h, w, c = h // 2, w // 2, 64  # the stem's 3x3/2 max pool
    for stage in range(3):
        m, h, w, c = stage_macs(depth, stage, h, w, c, stride_in_1x1)
        macs += m
    return macs


def rpn_macs(h: int, w: int, anchors: int = 15) -> int:
    """The RPN head on res4 (stride 16) of an (h, w) padded input."""
    rh, rw = h // RES4_STRIDE, w // RES4_STRIDE
    return _conv(rh, rw, RPN_CHANNELS, RPN_CHANNELS, 3) + _conv(rh, rw, RPN_CHANNELS, 5 * anchors, 1)


def res5_macs(depth: int, res: int = 14, stride_in_1x1: bool = True) -> int:
    """res5 on one ROI pooled to (res, res, 1024)."""
    return stage_macs(depth, 3, res, res, 1024, stride_in_1x1)[0]


def predictor_macs(classes: int) -> int:
    """The box predictor on one ROI's 2048 channels: classes + 1 scores, 4 deltas a class."""
    return RES5_CHANNELS * (classes + 1) + RES5_CHANNELS * 4 * classes


def mask_head_macs(classes: int, res: int = 7, dim: int = 256) -> int:
    """The 2 x 2 transposed convolution on res5's (res, res, 2048) and the 1 x 1 predictor at 2 res, one ROI."""
    return _conv(res, res, RES5_CHANNELS, dim, 2) + _conv(2 * res, 2 * res, dim, classes, 1)


def res5_box_flops(cfg: dict, rois: int) -> float:
    """FLOPs of res5 and the box predictor on ``rois`` ROIs (``cfg``: the configuration file)."""
    m = cfg["model"]
    return 2.0 * rois * (res5_macs(m["depth"], m["roi"]["box_pooler_resolution"], m["stride_in_1x1"])
                         + predictor_macs(m["roi"]["num_classes"]))


def tracker_flops(cfg: dict, pad_hw, detections: int, capped: int, reid_channels: int = 256) -> float:
    """FLOPs of the C4 tracker's model for one frame at ``pad_hw`` with
    ``detections`` kept and ``capped`` embedded (see the module docstring)."""
    m, t = cfg["model"], cfg["tracker"]
    roi = m["roi"]
    h, w = pad_hw
    anchors = len(m["anchors"]["sizes"][0]) * len(m["anchors"]["aspect_ratios"])
    res = roi["box_pooler_resolution"]
    res5 = res5_macs(m["depth"], res, m["stride_in_1x1"])
    macs = (trunk_macs(m["depth"], h, w, m["stride_in_1x1"]) + rpn_macs(h, w, anchors)
            + detections * (res5 + mask_head_macs(roi["num_classes"], res // 2, roi["mask_conv_dim"]))
            + capped * reid_channels * t["roi_size"] ** 2 * t["embedding_dim"])
    return 2.0 * macs + res5_box_flops(cfg, m["rpn"]["post_nms_topk_test"])
