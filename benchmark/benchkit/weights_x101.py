"""The X101 tracker's weights, made on the device from the seed, and their
calibration.

The leaves are those of a detectron2 Mask R-CNN X-FPN checkpoint: the
ResNeXt trunk (``backbone.bottom_up.*``, each bottleneck's ``conv2`` of
shape (width, width / groups, 3, 3)), then R-FPN's FPN, RPN, heads and
re-ID head, whose leaves and statistics are :mod:`benchkit.weights`'. The
trunk is drawn as R-FPN's is (He-normal convolutions over each one's own
fan-in, frozen BN with random statistics, 0.2 scale on each block's last
BN), except the stem's BN variance: the zoo's X101 divides the pixels by
their ImageNet std (~57 levels), so the stem sees unit-scale inputs where
R-FPN's sees levels, and its variance is drawn at 1 where R-FPN's is at
64 ** 2.  One ``torch.Generator`` on the device draws every leaf in two
calls (normals, uniforms).  The class biases are then calibrated on the
plain reference (:func:`calibrate_background`): the lead class's as C4's
are, then the background's by R-FPN's rule.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchkit import weights
from refplain.dcnn.models.resnet import STAGE_BLOCKS

TRUNK = "backbone.bottom_up."


def plan(depth: int, num_groups: int, width_per_group: int, num_classes: int, embed_in: int, embed_dim: int):
    """(name, shape, rule, argument) of every leaf, in drawing order: the
    ResNeXt trunk, then R-FPN's leaves after its trunk."""
    out = []

    def conv(name, o, i, k, gain=2.0):
        out.append((name, (o, i, k, k), "normal", math.sqrt(gain / (i * k * k))))

    def bn(prefix, ch, scale=1.0):
        out.append((f"{prefix}.weight", (ch,), "bn_scale", scale))
        out.append((f"{prefix}.bias", (ch,), "normal", 0.1))
        out.append((f"{prefix}.running_mean", (ch,), "normal", 0.1))
        out.append((f"{prefix}.running_var", (ch,), "uniform", 1.0))

    conv(f"{TRUNK}stem.conv1.weight", 64, 3, 7)
    bn(f"{TRUNK}stem.conv1.norm", 64)
    cin = 64
    for stage, n in enumerate(STAGE_BLOCKS[depth]):
        co, mid = 256 * 2 ** stage, num_groups * width_per_group * 2 ** stage
        for b in range(n):
            p = f"{TRUNK}res{stage + 2}.{b}"
            c = cin if b == 0 else co
            for name, (o, i, k) in (("conv1", (mid, c, 1)), ("conv2", (mid, mid // num_groups, 3)),
                                    ("conv3", (co, mid, 1))):
                conv(f"{p}.{name}.weight", o, i, k)
                bn(f"{p}.{name}.norm", o, scale=0.2 if name == "conv3" else 1.0)
            if b == 0:
                conv(f"{p}.shortcut.weight", co, c, 1, gain=1.0)
                bn(f"{p}.shortcut.norm", co)
        cin = co
    return out + [leaf for leaf in weights._plan(depth, num_classes, embed_in, embed_dim)
                  if not leaf[0].startswith(TRUNK)]


def seeded_weights(seed: int, model: dict, embed_in: int, embed_dim: int, device):
    """(detectron2 X-FPN state dict, re-ID head state dict) of float32 tensors
    on ``device``, drawn from ``seed`` in two calls of one generator;
    ``model`` is the configuration file's ``model``."""
    leaves = plan(model["depth"], model["num_groups"], model["width_per_group"], model["roi"]["num_classes"],
                  embed_in, embed_dim)
    n_normal = sum(math.prod(s) for _, s, rule, _ in leaves if rule in ("normal", "centred", "bn_scale"))
    n_uniform = sum(math.prod(s) for _, s, rule, _ in leaves if rule == "uniform")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    normals = torch.randn(n_normal, generator=gen, device=device)
    uniforms = torch.rand(n_uniform, generator=gen, device=device)
    out, i, j = {}, 0, 0
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
        elif rule == "uniform":
            v = arg * (0.5 + uniforms[j:j + n].reshape(shape))
            j += n
        elif rule == "cls_bias":
            v = torch.zeros(shape, device=device)
            v[-1] = arg
        else:
            v = torch.full(shape, float(arg), device=device)
        out[name] = v.contiguous()
    assoc = {k[len("assoc."):]: out.pop(k) for k in [k for k in out if k.startswith("assoc.")]}
    return out, assoc


@torch.no_grad()
def calibrate_background(ckpt: dict, ref, frames: list[np.ndarray], per_frame: int = 10, batch: int = 4) -> dict:
    """Set the class biases of ``ckpt`` (in place) from ``frames`` through the
    X-FPN reference tracker ``ref`` (its model loaded from ``ckpt``).

    As in :func:`benchkit.weights_c4.calibrate_background`, the lead class
    (the largest mean logit over the proposals) is first raised, by no more
    than it takes, so that in every frame ``per_frame`` proposals could
    clear the threshold with a margin of 1 in logit: the seeded ResNeXt
    trunk's pyramid is quieter than R101's, and for some seeds too few
    proposals have a dominant class.  Then R-FPN's rule
    (:func:`benchkit.weights.calibrate_background`) sets the background
    bias.  Raises where a frame keeps fewer than ``per_frame`` candidates."""
    from refplain.dcnn.models.roi_heads import POOL_LEVELS, fpn_roi_align

    model, heads, roi = ref.model, ref.model.roi_heads, ref.cfg.roi
    fgs = []
    for b in range(0, len(frames), batch):
        x = torch.from_numpy(np.stack(frames[b:b + batch])).to(ref.device)
        x, _ = ref.pre(x, with_gray=False)
        feats = model.features(ref.resize(x))
        boxes, _, valid = model.proposals(feats, ref.pad_hw)
        pooled = fpn_roi_align({n: feats[n] for n in POOL_LEVELS}, boxes, roi.box_pooler_resolution,
                               roi.pooler_sampling_ratio)
        logits, _ = heads.box_predictor(heads.box_head(pooled.reshape(-1, pooled[0, 0].numel())))
        lg = logits.reshape(*boxes.shape[:2], -1)[..., :-1].double().cpu()
        fgs += [f[v] for f, v in zip(lg, valid.cpu())]
    odds = math.log(1.0 / roi.score_thresh_test - 1.0)  # a class clears t when it leads the others' logsumexp by more
    lead = int(torch.cat(fgs).mean(dim=0).argmax())

    def short(fg):  # how far the lead class falls short of clearing t, a proposal
        return torch.logsumexp(torch.cat([fg[:, :lead], fg[:, lead + 1:]], dim=1), dim=1) - odds - fg[:, lead]

    lift = max(0.0, max(float(torch.sort(short(f)).values[per_frame - 1]) for f in fgs) + 1.0)
    key = "roi_heads.box_predictor.cls_score.bias"
    ckpt[key] = ckpt[key].clone()
    ckpt[key][lead] += lift
    param = dict(model.named_parameters())[key]
    param.copy_(ckpt[key].to(param.device))
    out = weights.calibrate_background(ckpt, ref, frames, per_frame, batch)
    if min(out["candidates_per_frame"]) < per_frame:
        raise RuntimeError(f"a calibration frame keeps fewer than {per_frame} candidates: "
                           f"{out['candidates_per_frame']}")
    return {**out, "lead_class": lead, "lead_lift": lift}
