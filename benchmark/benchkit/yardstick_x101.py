"""The FLOPs of the X101 tracker's model, and the work of its grouped
convolutions: 2 x the multiply-adds of every convolution and product
(``benchkit.yardstick``'s rule), for Mask R-CNN X-FPN.

A frame: the ResNeXt trunk on the padded input (a grouped 3 x 3 takes
``width / groups`` inputs to each output), then R-FPN's FPN, RPN head, box
head on every post-NMS proposal, mask head on the detections kept and re-ID
head on the capped ones.  The resize to the network's input is left out,
as in the R-FPN count.

The grouped convolutions' work, for their roofline: each call's FLOPs, and
its bytes in float32 (the input map read once, the output map written once,
the weights read once a call).
"""

from __future__ import annotations

from benchkit.yardstick import (PEAK_BYTES, PEAK_F32, _conv, box_head_macs, fpn_macs, mask_head_macs,
                                rpn_macs)

BYTES = 4  # float32


def grouped_convs(depth: int, num_groups: int, width_per_group: int, h: int, w: int,
                  stride_in_1x1: bool = False) -> list[dict]:
    """Each bottleneck's 3 x 3 convolution on one (h, w) padded input, in
    order: its input (h, w), output (h, w) and width."""
    from refplain.dcnn.models.resnet import STAGE_BLOCKS

    h, w = h // 4, w // 4  # the stem's 7 x 7 / 2 and its 3 x 3 / 2 max pool
    out = []
    for stage, n in enumerate(STAGE_BLOCKS[depth]):
        width = num_groups * width_per_group * 2 ** stage
        s = 1 if stage == 0 else 2
        ho, wo = h // s, w // s
        for b in range(n):
            stride = s if b == 0 and not stride_in_1x1 else 1  # else conv1 took the stride
            out.append({"in_hw": (h, w) if stride > 1 else (ho, wo), "out_hw": (ho, wo), "width": width})
        h, w = ho, wo
    return out


def trunk_macs(depth: int, num_groups: int, width_per_group: int, h: int, w: int,
               stride_in_1x1: bool = False) -> int:
    """The stem and res2-res5 on an (h, w) padded input."""
    from refplain.dcnn.models.resnet import STAGE_BLOCKS

    h, w = h // 2, w // 2
    macs = _conv(h, w, 3, 64, 7)
    h, w = h // 2, w // 2  # the stem's 3x3/2 max pool
    cin = 64
    for stage, n in enumerate(STAGE_BLOCKS[depth]):
        out, mid = 256 * 2 ** stage, num_groups * width_per_group * 2 ** stage
        s = 1 if stage == 0 else 2
        ho, wo = h // s, w // s
        for b in range(n):
            c = cin if b == 0 else out
            h1, w1 = (ho, wo) if b > 0 or stride_in_1x1 else (h, w)
            macs += _conv(h1, w1, c, mid, 1) + _conv(ho, wo, mid, mid // num_groups, 3) + _conv(ho, wo, mid, out, 1)
            if b == 0:
                macs += _conv(ho, wo, c, out, 1)  # the shortcut
        h, w, cin = ho, wo, out
    return macs


def tracker_flops(cfg: dict, pad_hw, detections: int, capped: int) -> float:
    """FLOPs of the X101 tracker's model for one frame at ``pad_hw`` with
    ``detections`` kept and ``capped`` embedded (see the module docstring)."""
    m, t = cfg["model"], cfg["tracker"]
    roi = m["roi"]
    h, w = pad_hw
    ch = m["fpn_channels"]
    macs = (trunk_macs(m["depth"], m["num_groups"], m["width_per_group"], h, w, m["stride_in_1x1"])
            + fpn_macs(h, w, ch) + rpn_macs(h, w, ch, len(m["anchors"]["aspect_ratios"]))
            + box_head_macs(m["rpn"]["post_nms_topk_test"], ch, roi["box_pooler_resolution"], roi["box_fc_dim"],
                            roi["num_classes"])
            + mask_head_macs(detections, roi["mask_conv_dim"], roi["mask_pooler_resolution"], roi["num_mask_conv"],
                             roi["num_classes"])
            + capped * ch * t["roi_size"] ** 2 * t["embedding_dim"])
    return 2.0 * macs


def gconv_work(cfg: dict, pad_hw, batch: int) -> list[tuple[float, float]]:
    """(FLOPs, bytes) of each grouped convolution of one forward of ``batch``
    frames at ``pad_hw``, from the configuration file's shapes."""
    m = cfg["model"]
    out = []
    for c in grouped_convs(m["depth"], m["num_groups"], m["width_per_group"], *pad_hw, m["stride_in_1x1"]):
        (hi, wi), (ho, wo), width = c["in_hw"], c["out_hw"], c["width"]
        flops = 2.0 * batch * _conv(ho, wo, width, width // m["num_groups"], 3)
        nbytes = BYTES * (batch * width * (hi * wi + ho * wo) + width * (width // m["num_groups"]) * 9)
        out.append((flops, nbytes))
    return out


def gconv_bound_s(cfg: dict, pad_hw, batch: int, batches: int) -> float:
    """The least seconds the card needs for the grouped convolutions of
    ``batches`` forwards of ``batch`` frames: each call's larger of its
    FLOPs over the float32 peak and its bytes over the HBM peak, summed."""
    return batches * sum(max(f / PEAK_F32, b / PEAK_BYTES) for f, b in gconv_work(cfg, pad_hw, batch))
