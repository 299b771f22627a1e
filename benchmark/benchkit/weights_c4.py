"""The C4 tracker's weights, made on the device from the seed, and their
calibration.

The leaves are those of a detectron2 Mask R-CNN R-C4 checkpoint: the trunk
to res4 (``backbone.*``), a 1024-channel RPN with 15 anchors a cell, res5
in the ROI heads (``roi_heads.res5.*``), the box predictor on 2048 channels
and a mask head of one transposed convolution.  Their statistics are those
of the measured package's seeded C4 checkpoint (``utils/synthetic.py``
``detectron2_checkpoint(..., architecture="c4")``) and of the R-FPN leaves
in :mod:`benchkit.weights`, drawn the same way: one ``torch.Generator`` on
the device, two large calls (normals, uniforms), cut into the leaves.  The
class biases are then calibrated on the plain reference: the lead class's
where the draw leaves no class dominant, then the background's by the R-FPN
cells' rule (:func:`calibrate_background`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchkit.weights import CLS_BG_BIAS, MASK_BIAS
from refplain.dcnn.models.resnet import STAGE_BLOCKS

RPN_CHANNELS, RES5_CHANNELS, ANCHORS, MASK_DIM = 1024, 2048, 15, 256


def plan(depth: int, num_classes: int, embed_in: int, embed_dim: int):
    """(name, shape, rule, argument) of every leaf, in drawing order."""
    out = []

    def conv(name, o, i, k, gain=2.0):
        out.append((name, (o, i, k, k), "normal", math.sqrt(gain / (i * k * k))))

    def bn(prefix, ch, scale=1.0, var_scale=1.0):
        out.append((f"{prefix}.weight", (ch,), "bn_scale", scale))
        out.append((f"{prefix}.bias", (ch,), "normal", 0.1))
        out.append((f"{prefix}.running_mean", (ch,), "normal", 0.1 * math.sqrt(var_scale)))
        out.append((f"{prefix}.running_var", (ch,), "uniform", var_scale))

    conv("backbone.stem.conv1.weight", 64, 3, 7)
    bn("backbone.stem.conv1.norm", 64, var_scale=64.0 ** 2)
    cin = 64
    for stage, n in enumerate(STAGE_BLOCKS[depth]):
        co, mid = 256 * 2 ** stage, 64 * 2 ** stage
        owner = "roi_heads" if stage == 3 else "backbone"  # res5 is the ROI heads' transform
        for b in range(n):
            p = f"{owner}.res{stage + 2}.{b}"
            c = cin if b == 0 else co
            for name, (o, i, k) in (("conv1", (mid, c, 1)), ("conv2", (mid, mid, 3)), ("conv3", (co, mid, 1))):
                conv(f"{p}.{name}.weight", o, i, k)
                bn(f"{p}.{name}.norm", o, scale=0.2 if name == "conv3" else 1.0)
            if b == 0:
                conv(f"{p}.shortcut.weight", co, c, 1, gain=1.0)
                bn(f"{p}.shortcut.norm", co)
        cin = co
    rpn, ch = "proposal_generator.rpn_head", RPN_CHANNELS
    conv(f"{rpn}.conv.weight", ch, ch, 3)
    out.append((f"{rpn}.conv.bias", (ch,), "const", 0.0))
    out.append((f"{rpn}.objectness_logits.weight", (ANCHORS, ch, 1, 1), "normal", 3.0 / math.sqrt(ch)))
    out.append((f"{rpn}.objectness_logits.bias", (ANCHORS,), "const", 0.0))
    out.append((f"{rpn}.anchor_deltas.weight", (4 * ANCHORS, ch, 1, 1), "normal", 0.02 / math.sqrt(ch)))
    out.append((f"{rpn}.anchor_deltas.bias", (4 * ANCHORS,), "const", 0.0))
    fc = RES5_CHANNELS
    out.append(("roi_heads.box_predictor.cls_score.weight", (num_classes + 1, fc), "centred", 2.0 / math.sqrt(fc)))
    out.append(("roi_heads.box_predictor.cls_score.bias", (num_classes + 1,), "cls_bias", CLS_BG_BIAS))
    out.append(("roi_heads.box_predictor.bbox_pred.weight", (4 * num_classes, fc), "normal", 0.1 / math.sqrt(fc)))
    out.append(("roi_heads.box_predictor.bbox_pred.bias", (4 * num_classes,), "const", 0.0))
    mh = "roi_heads.mask_head"
    out.append((f"{mh}.deconv.weight", (fc, MASK_DIM, 2, 2), "normal", math.sqrt(2.0 / fc)))
    out.append((f"{mh}.deconv.bias", (MASK_DIM,), "const", 0.0))
    out.append((f"{mh}.predictor.weight", (num_classes, MASK_DIM, 1, 1), "centred", 1 / math.sqrt(MASK_DIM)))
    out.append((f"{mh}.predictor.bias", (num_classes,), "const", MASK_BIAS))
    out.append(("assoc.fc.weight", (embed_dim, embed_in), "normal", 1 / math.sqrt(embed_in)))
    out.append(("assoc.fc.bias", (embed_dim,), "const", 0.0))
    return out


def seeded_weights(seed: int, depth: int, num_classes: int, embed_in: int, embed_dim: int, device):
    """(detectron2 C4 state dict, re-ID head state dict) of float32 tensors on
    ``device``, drawn from ``seed`` in two calls of one generator."""
    leaves = plan(depth, num_classes, embed_in, embed_dim)
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
    C4 reference tracker ``ref`` (its model loaded from ``ckpt``).

    C4's predictor reads the mean of res5's 2048 channels over 7 x 7, which
    differs little from proposal to proposal, so the logits' pattern common
    to all proposals can leave no class dominant enough to clear the
    threshold.  First the lead class (the largest mean logit over the
    proposals) is raised, by no more than it takes, so that in every frame
    ``per_frame`` proposals could clear the threshold with a margin of 1 in
    logit; for most seeds of the R101 trunk that is no change.  Then the
    background bias is set by the rule of
    :func:`benchkit.weights.calibrate_background`: for each proposal the
    largest shift of the bias that still lets its best class clear the
    threshold; the bias goes to the middle of the widest gap between those
    shifts just below the ``per_frame``-th largest of the frame that has
    fewest, so each frame keeps >= ``per_frame`` candidates before NMS and
    none sits near the threshold.  Here that gap is sought no lower than
    keeps fewer than 2 ``per_frame`` candidates in the frame that has most,
    and where no bias does that it is the gap just below the target, so a
    frame keeps tens of candidates and not hundreds."""
    model = ref.model
    t = ref.cfg.roi.score_thresh_test
    fgs, bgs, valids = [], [], []
    for b in range(0, len(frames), batch):
        x = torch.from_numpy(np.stack(frames[b:b + batch])).to(ref.device)
        x, _ = ref.pre(x, with_gray=False)
        feats = model.features(ref.resize(x))
        boxes, _, valid = model.proposals(feats, ref.pad_hw)
        logits, _ = model.box_outputs(model.roi_transform(feats["res4"], boxes), *boxes.shape[:2])
        lg = logits.double().cpu()
        fgs += list(lg[..., :-1])
        bgs += list(lg[..., -1])
        valids += list(valid.cpu())
    odds = math.log(1.0 / t - 1.0)  # a class clears t when it leads the other classes' logsumexp by more
    lead = int(torch.cat([f[v] for f, v in zip(fgs, valids)]).mean(dim=0).argmax())

    def short(fg):  # how far the lead class falls short of clearing t, a proposal
        return torch.logsumexp(torch.cat([fg[:, :lead], fg[:, lead + 1:]], dim=1), dim=1) - odds - fg[:, lead]

    lift = max(0.0, max(float(torch.sort(short(f[v])).values[per_frame - 1]) for f, v in zip(fgs, valids)) + 1.0)
    shifts = []
    for fg, bg, valid in zip(fgs, bgs, valids):
        fg = fg.clone()
        fg[:, lead] += lift
        k = fg.argmax(-1, keepdim=True)
        best = fg.gather(-1, k)[..., 0]
        rest = torch.logsumexp(fg.scatter(-1, k, float("-inf")), -1)
        room = torch.exp(best) * (1.0 / t - 1.0) - torch.exp(rest)
        shift = torch.log(torch.clamp(room, min=1e-300)) - bg
        shifts.append(torch.where(valid & (room > 0), shift, torch.full_like(shift, float("-inf"))))
    ranked = [torch.sort(s, descending=True).values for s in shifts]
    target = min(float(s[per_frame - 1]) for s in ranked)
    if not math.isfinite(target):
        raise RuntimeError(f"a calibration frame has fewer than {per_frame} proposals that can clear {t}")
    # C4's shifts lie close together, often hundreds of them within a logit of
    # the target.  The gap is sought no lower than keeps < 2 per_frame
    # candidates in the frame that has most; where no bias does that, it is the
    # gap just below the target, which keeps fewest.
    crowd = max(float(s[2 * per_frame - 1]) if len(s) >= 2 * per_frame else float("-inf") for s in ranked)
    below = [float(s[s < target].max()) for s in ranked if bool((s < target).any())]
    floor = max(target - 1.0, crowd) if crowd < target else max(below, default=target - 1.0)
    near = np.sort(np.concatenate([s[(s < target) & (s >= floor)].numpy() for s in ranked] + [[target]]))
    gaps = np.diff(near)
    i = int(np.argmax(gaps)) if len(gaps) else 0
    delta = float((near[i] + near[i + 1]) / 2) if len(gaps) else target - 0.5
    key = "roi_heads.box_predictor.cls_score.bias"
    ckpt[key] = ckpt[key].clone()
    ckpt[key][lead] += lift
    ckpt[key][-1] += delta
    param = dict(model.named_parameters())[key]
    param.copy_(ckpt[key].to(param.device))
    return {"background_bias": float(ckpt[key][-1]), "lead_class": lead, "lead_lift": lift,
            "margin": float(gaps[i] / 2) if len(gaps) else 0.5,
            "candidates_per_frame": [int((s > delta).sum()) for s in ranked]}
