"""The ViTDet tracker's weights, made on the device from the seed, and their
calibration.

The leaves are those of a detectron2 Mask R-CNN ViTDet checkpoint
(``backbone.net.*``, ``backbone.simfp_*``, the two-conv RPN head, the
4conv1fc box head and the LN mask head) and the re-ID head.  Their
statistics: linear layers and convolutions normal over their own fan-in
(gain 1 in the trunk, where LayerNorm fixes the scale of every input; He's
gain 2 before a ReLU; the output projections and fc2 at gain 0.5, so the
residual stream grows slowly over the 12 blocks), the position table and
every bias at 0.02, LayerNorm scales at 1 +- 10 %, the relative-position
tables at 0.1, so that they move the scores by about a logit; the RPN's
and the predictors' leaves are R-FPN's (:mod:`benchkit.weights`).  One
``torch.Generator`` on the device draws every leaf in one call of normals.
The class biases are then calibrated on the plain reference
(:func:`calibrate_background`, X101's rule).
"""

from __future__ import annotations

import math

import torch

from benchkit import weights, weights_x101

NET = "backbone.net."


def plan(model: dict, embed_in: int, embed_dim: int):
    """(name, shape, rule, argument) of every leaf, in drawing order, for
    the configuration file's ``model``; rules as :mod:`benchkit.weights`'."""
    vit, roi, ch = model["vit"], model["roi"], model["fpn_channels"]
    d, p = vit["embed_dim"], vit["patch_size"]
    hidden, dh = int(d * vit["mlp_ratio"]), d // vit["num_heads"]
    grid = vit["img_size"] // p
    out = []

    def linear(name, o, i, gain=1.0):
        out.append((f"{name}.weight", (o, i), "normal", math.sqrt(gain / i)))
        out.append((f"{name}.bias", (o,), "normal", 0.02))

    def conv(name, o, i, k, gain=2.0, bias=True):
        out.append((f"{name}.weight", (o, i, k, k), "normal", math.sqrt(gain / (i * k * k))))
        if bias:
            out.append((f"{name}.bias", (o,), "normal", 0.02))

    def deconv(name, i, o):
        out.append((f"{name}.weight", (i, o, 2, 2), "normal", math.sqrt(1.0 / i)))
        out.append((f"{name}.bias", (o,), "normal", 0.02))

    def ln(name, c):
        out.append((f"{name}.weight", (c,), "bn_scale", 1.0))
        out.append((f"{name}.bias", (c,), "normal", 0.02))

    def conv_ln(name, o, i, k):
        conv(name, o, i, k, gain=1.0, bias=False)
        ln(f"{name}.norm", o)

    conv(f"{NET}patch_embed.proj", d, 3, p, gain=1.0)
    out.append((f"{NET}pos_embed", (1, 1 + (224 // 16) ** 2, d), "normal", 0.02))  # the 224 / 16 grid, a cls slot
    for i in range(vit["depth"]):
        b = f"{NET}blocks.{i}"
        rel = vit["window_size"] if i in vit["window_block_indexes"] else grid
        ln(f"{b}.norm1", d)
        out.append((f"{b}.attn.rel_pos_h", (2 * rel - 1, dh), "normal", 0.1))
        out.append((f"{b}.attn.rel_pos_w", (2 * rel - 1, dh), "normal", 0.1))
        linear(f"{b}.attn.qkv", 3 * d, d)
        linear(f"{b}.attn.proj", d, d, gain=0.5)
        ln(f"{b}.norm2", d)
        linear(f"{b}.mlp.fc1", hidden, d, gain=2.0)
        linear(f"{b}.mlp.fc2", d, hidden, gain=0.5)
    for scale in (4.0, 2.0, 1.0, 0.5):
        s = f"backbone.simfp_{int(math.log2(p / scale))}"
        if scale == 4.0:
            deconv(f"{s}.0", d, d // 2)
            ln(f"{s}.1", d // 2)
            deconv(f"{s}.3", d // 2, d // 4)
            width, first = d // 4, 4
        elif scale == 2.0:
            deconv(f"{s}.0", d, d // 2)
            width, first = d // 2, 1
        else:
            width, first = d, 0 if scale == 1.0 else 1
        conv_ln(f"{s}.{first}", ch, width, 1)
        conv_ln(f"{s}.{first + 1}", ch, ch, 3)
    rpn = "proposal_generator.rpn_head"
    for k in range(model["rpn"]["num_conv"]):
        conv(f"{rpn}.conv.conv{k}", ch, ch, 3)
    box = "roi_heads.box_head"
    res = roi["box_pooler_resolution"]
    for k in range(roi["num_box_conv"]):
        conv_ln(f"{box}.conv{k + 1}", ch, ch, 3)
    linear(f"{box}.fc1", roi["box_fc_dim"], ch * res * res, gain=2.0)
    for k in range(roi["num_mask_conv"]):
        conv_ln(f"roi_heads.mask_head.mask_fcn{k + 1}", roi["mask_conv_dim"], ch if k == 0 else roi["mask_conv_dim"],
                3)
    # R-FPN's leaves of the RPN's 1x1s, the predictors, the mask head's deconv and predictor, and the re-ID head.
    keep = (f"{rpn}.objectness_logits", f"{rpn}.anchor_deltas", "roi_heads.box_predictor", "roi_heads.mask_head.deconv",
            "roi_heads.mask_head.predictor", "assoc.")
    return out + [leaf for leaf in weights._plan(50, roi["num_classes"], embed_in, embed_dim)
                  if leaf[0].startswith(keep)]


def seeded_weights(seed: int, model: dict, embed_in: int, embed_dim: int, device):
    """(detectron2 ViTDet state dict, re-ID head state dict) of float32
    tensors on ``device``, drawn from ``seed`` by one generator."""
    leaves = plan(model, embed_in, embed_dim)
    n_normal = sum(math.prod(s) for _, s, rule, _ in leaves if rule in ("normal", "centred", "bn_scale"))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    normals = torch.randn(n_normal, generator=gen, device=device)
    out, i = {}, 0
    for name, shape, rule, arg in leaves:
        n = math.prod(shape)
        if rule in ("normal", "centred", "bn_scale"):
            v = normals[i:i + n].reshape(shape)
            i += n
            if rule == "normal":
                v = v * arg
            elif rule == "centred":
                v = v * arg
                v = v - v.mean(dim=1, keepdim=True)
            else:
                v = arg * (1.0 + 0.1 * v)
        elif rule == "cls_bias":
            v = torch.zeros(shape, device=device)
            v[-1] = arg
        else:
            v = torch.full(shape, float(arg), device=device)
        out[name] = v.contiguous()
    assoc = {k[len("assoc."):]: out.pop(k) for k in [k for k in out if k.startswith("assoc.")]}
    return out, assoc


def calibrate_background(ckpt: dict, ref, frames, per_frame: int = 10, batch: int = 4) -> dict:
    """The class biases of ``ckpt`` set (in place) from ``frames`` through the
    ViTDet reference tracker ``ref`` by X101's rule
    (:func:`benchkit.weights_x101.calibrate_background`): the lead class
    lifted as far as it takes for ``per_frame`` proposals a frame to clear
    the threshold, then R-FPN's background rule.  Raises where a frame keeps
    fewer than ``per_frame`` candidates."""
    return weights_x101.calibrate_background(ckpt, ref, frames, per_frame, batch)
