"""The FLOPs of the ViTDet tracker's model, and the work of its attention
cores: 2 x the multiply-adds of every convolution and product
(``benchkit.yardstick``'s rule), for Mask R-CNN ViTDet.

A frame: the ViT on the square input (the patch embedding; in each block
the qkv and output projections on its tokens, a windowed block's tokens
padded to whole windows, the attention core, the MLP on the unpadded
grid), the simple feature pyramid (a transposed 2 x 2 / 2 convolution
costs its input pixels times its weights), the RPN head's convolutions on
p2-p6, the box head's convolutions and FC on every post-NMS proposal, the
mask head on the detections kept and the re-ID head on the capped ones.
LayerNorm, GELU, the softmax, the position table's resize and the image
resize are left out, as ``FlopCounterMode`` leaves them out.

The attention cores' work, for their roofline: each call's FLOPs (the two
products, 2 N_q N_k d each, and the two relative-position products, 2 N_q k
d each, a head of each image or window) and its bytes in float32, the fused
ideal: q, k, v and the output once each and the two relative-position
tables.
"""

from __future__ import annotations

from benchkit.yardstick import PEAK_BYTES, PEAK_F32, _conv, mask_head_macs

BYTES = 4  # float32


def attention_calls(vit: dict, batch: int) -> list[dict]:
    """Each block's attention core on ``batch`` square images, in order:
    ``global``, the problems (images or windows), heads, tokens a side, head
    dim and table rows."""
    grid = vit["img_size"] // vit["patch_size"]
    heads, d = vit["num_heads"], vit["embed_dim"] // vit["num_heads"]
    out = []
    for i in range(vit["depth"]):
        if i in vit["window_block_indexes"]:
            s = vit["window_size"]
            n = -(-grid // s)
            out.append({"global": False, "problems": batch * n * n, "heads": heads, "side": s, "d": d})
        else:
            out.append({"global": True, "problems": batch, "heads": heads, "side": grid, "d": d})
    return out


def attention_work(vit: dict, batch: int) -> list[tuple[float, float, bool]]:
    """(FLOPs, bytes, global) of each attention core of one forward of
    ``batch`` images, from the configuration's shapes."""
    out = []
    for c in attention_calls(vit, batch):
        n, rows, s = c["problems"] * c["heads"], c["side"] ** 2, c["side"]
        flops = n * (4 * rows * rows * c["d"] + 2 * rows * (2 * s) * c["d"])
        nbytes = BYTES * (4 * n * rows * c["d"] + 2 * (2 * s - 1) * c["d"])
        out.append((float(flops), float(nbytes), c["global"]))
    return out


def attention_bound_s(cfg: dict, batch: int, batches: int) -> float:
    """The least seconds the card needs for the attention cores of
    ``batches`` forwards of ``batch`` frames: each call's larger of its
    FLOPs over the float32 peak and its bytes over the HBM peak, summed."""
    return batches * sum(max(f / PEAK_F32, b / PEAK_BYTES) for f, b, _ in attention_work(cfg["model"]["vit"], batch))


def vit_macs(vit: dict) -> int:
    """The ViT on one square image, its attention cores included."""
    d, p = vit["embed_dim"], vit["patch_size"]
    grid = vit["img_size"] // p
    tokens = grid * grid
    macs = tokens * d * 3 * p * p
    for c in attention_calls(vit, 1):
        padded = c["problems"] * c["side"] ** 2  # a windowed block projects its padded windows
        macs += padded * d * 4 * d + tokens * 2 * d * int(d * vit["mlp_ratio"])
    return macs + sum(int(f) for f, _, _ in attention_work(vit, 1)) // 2


def pyramid_macs(vit: dict, channels: int) -> int:
    """The simple feature pyramid on one image's last map."""
    d = vit["embed_dim"]
    g = vit["img_size"] // vit["patch_size"]
    macs = 0
    for scale in (4.0, 2.0, 1.0, 0.5):
        side = int(g * scale)
        if scale == 4.0:
            macs += g * g * d * (d // 2) * 4 + (2 * g) ** 2 * (d // 2) * (d // 4) * 4
            width = d // 4
        elif scale == 2.0:
            macs += g * g * d * (d // 2) * 4
            width = d // 2
        else:
            width = d
        macs += _conv(side, side, width, channels, 1) + _conv(side, side, channels, channels, 3)
    return macs


def tracker_flops(cfg: dict, pad_hw, detections: int, capped: int) -> float:
    """FLOPs of the ViTDet tracker's model for one frame at the square
    ``pad_hw`` with ``detections`` kept and ``capped`` embedded (see the
    module docstring)."""
    m, t = cfg["model"], cfg["tracker"]
    vit, roi, rpn = m["vit"], m["roi"], m["rpn"]
    ch, a = m["fpn_channels"], len(m["anchors"]["aspect_ratios"])
    h, w = pad_hw
    levels = [(h // 2 ** s, w // 2 ** s) for s in range(2, 7)]
    rpn_macs = sum(rpn["num_conv"] * _conv(lh, lw, ch, ch, 3) + _conv(lh, lw, ch, 5 * a, 1) for lh, lw in levels)
    res, fc, k = roi["box_pooler_resolution"], roi["box_fc_dim"], roi["num_classes"]
    box = roi["num_box_conv"] * _conv(res, res, ch, ch, 3) + ch * res * res * fc + fc * (k + 1) + fc * 4 * k
    macs = (vit_macs(vit) + pyramid_macs(vit, ch) + rpn_macs + rpn["post_nms_topk_test"] * box
            + mask_head_macs(detections, roi["mask_conv_dim"], roi["mask_pooler_resolution"], roi["num_mask_conv"], k)
            + capped * ch * t["roi_size"] ** 2 * t["embedding_dim"])
    return 2.0 * macs
