"""The tracker's weights, made on the device from the seed, and the
background calibration that keeps its detections decisive.

The statistics are those of the measured package's seeded detectron2
checkpoint (``utils/synthetic.py`` ``detectron2_checkpoint``): He-normal
convolutions, frozen BN with random statistics (0.2 scale on each block's
last BN), objectness and class logits spread wide, small box deltas, a
background bias and a mask bias.  They are drawn here with one
``torch.Generator`` on the device in two large calls (normals and uniforms)
and cut into the leaves, so no value crosses the host.  The re-ID head is a
LeCun-normal linear map drawn in the same calls.

The background bias is then calibrated with the plain reference model
(:func:`calibrate_background`, a copy of the measured package's smoke
run's rule), so the inputs owe nothing to the measured program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from refplain.dcnn.models.resnet import STAGE_BLOCKS

CLS_BG_BIAS = 4.0
MASK_BIAS = 5.0


def _plan(depth: int, num_classes: int, embed_in: int, embed_dim: int):
    """(name, shape, rule, argument) of every leaf, in drawing order: the
    model zoo's R-FPN widths (256 FPN channels, 3 anchors a cell, 7x7 box
    pooling, a 1024-d box head)."""
    fpn, fc, anchors, box_res = 256, 1024, 3, 7
    out = []

    def conv(name, o, i, k, gain=2.0):
        out.append((name, (o, i, k, k), "normal", math.sqrt(gain / (i * k * k))))

    def bn(prefix, ch, scale=1.0, var_scale=1.0):
        out.append((f"{prefix}.weight", (ch,), "bn_scale", scale))
        out.append((f"{prefix}.bias", (ch,), "normal", 0.1))
        out.append((f"{prefix}.running_mean", (ch,), "normal", 0.1 * math.sqrt(var_scale)))
        out.append((f"{prefix}.running_var", (ch,), "uniform", var_scale))

    bb = "backbone.bottom_up"
    conv(f"{bb}.stem.conv1.weight", 64, 3, 7)
    bn(f"{bb}.stem.conv1.norm", 64, var_scale=64.0 ** 2)
    cin = 64
    for stage, n in enumerate(STAGE_BLOCKS[depth]):
        co, mid = 256 * 2 ** stage, 64 * 2 ** stage
        for b in range(n):
            p = f"{bb}.res{stage + 2}.{b}"
            c = cin if b == 0 else co
            for name, (o, i, k) in (("conv1", (mid, c, 1)), ("conv2", (mid, mid, 3)), ("conv3", (co, mid, 1))):
                conv(f"{p}.{name}.weight", o, i, k)
                bn(f"{p}.{name}.norm", o, scale=0.2 if name == "conv3" else 1.0)
            if b == 0:
                conv(f"{p}.shortcut.weight", co, c, 1, gain=1.0)
                bn(f"{p}.shortcut.norm", co)
        cin = co
    for i, c in enumerate((256, 512, 1024, 2048)):
        conv(f"backbone.fpn_lateral{i + 2}.weight", fpn, c, 1, gain=1.0)
        out.append((f"backbone.fpn_lateral{i + 2}.bias", (fpn,), "normal", 0.1))
        conv(f"backbone.fpn_output{i + 2}.weight", fpn, fpn, 3, gain=0.25)
        out.append((f"backbone.fpn_output{i + 2}.bias", (fpn,), "normal", 0.1))
    rpn = "proposal_generator.rpn_head"
    conv(f"{rpn}.conv.weight", fpn, fpn, 3)
    out.append((f"{rpn}.conv.bias", (fpn,), "const", 0.0))
    out.append((f"{rpn}.objectness_logits.weight", (anchors, fpn, 1, 1), "normal", 3.0 / math.sqrt(fpn)))
    out.append((f"{rpn}.objectness_logits.bias", (anchors,), "const", 0.0))
    out.append((f"{rpn}.anchor_deltas.weight", (4 * anchors, fpn, 1, 1), "normal", 0.02 / math.sqrt(fpn)))
    out.append((f"{rpn}.anchor_deltas.bias", (4 * anchors,), "const", 0.0))
    in_dim = fpn * box_res * box_res
    out.append(("roi_heads.box_head.fc1.weight", (fc, in_dim), "normal", math.sqrt(2.0 / in_dim)))
    out.append(("roi_heads.box_head.fc1.bias", (fc,), "const", 0.0))
    out.append(("roi_heads.box_head.fc2.weight", (fc, fc), "normal", math.sqrt(2.0 / fc)))
    out.append(("roi_heads.box_head.fc2.bias", (fc,), "const", 0.0))
    out.append(("roi_heads.box_predictor.cls_score.weight", (num_classes + 1, fc), "centred", 2.0 / math.sqrt(fc)))
    out.append(("roi_heads.box_predictor.cls_score.bias", (num_classes + 1,), "cls_bias", CLS_BG_BIAS))
    out.append(("roi_heads.box_predictor.bbox_pred.weight", (4 * num_classes, fc), "normal", 0.1 / math.sqrt(fc)))
    out.append(("roi_heads.box_predictor.bbox_pred.bias", (4 * num_classes,), "const", 0.0))
    mh, dim = "roi_heads.mask_head", 256
    for i in range(1, 5):
        conv(f"{mh}.mask_fcn{i}.weight", dim, dim, 3)
        out.append((f"{mh}.mask_fcn{i}.bias", (dim,), "const", 0.0))
    out.append((f"{mh}.deconv.weight", (dim, dim, 2, 2), "normal", math.sqrt(2.0 / dim)))
    out.append((f"{mh}.deconv.bias", (dim,), "const", 0.0))
    out.append((f"{mh}.predictor.weight", (num_classes, dim, 1, 1), "centred", 1 / math.sqrt(dim)))
    out.append((f"{mh}.predictor.bias", (num_classes,), "const", MASK_BIAS))
    out.append(("assoc.fc.weight", (embed_dim, embed_in), "normal", 1 / math.sqrt(embed_in)))
    out.append(("assoc.fc.bias", (embed_dim,), "const", 0.0))
    return out


def seeded_weights(seed: int, depth: int, num_classes: int, embed_in: int, embed_dim: int, device):
    """(detectron2 state dict, re-ID head state dict) of float32 tensors on
    ``device``, drawn from ``seed`` in two calls of one generator."""
    plan = _plan(depth, num_classes, embed_in, embed_dim)
    n_normal = sum(math.prod(s) for _, s, rule, _ in plan if rule in ("normal", "centred", "bn_scale"))
    n_uniform = sum(math.prod(s) for _, s, rule, _ in plan if rule == "uniform")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    normals = torch.randn(n_normal, generator=gen, device=device)
    uniforms = torch.rand(n_uniform, generator=gen, device=device)
    out, i, j = {}, 0, 0
    for name, shape, rule, arg in plan:
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
    """Set the background logit bias of ``ckpt`` (in place) from ``frames``
    through the reference tracker ``ref`` (its model loaded from ``ckpt``).

    For each proposal of each frame: the largest shift of the background
    bias that still lets its best class clear the score threshold (softmax,
    float64).  The bias goes to the middle of the widest gap between those
    shifts just below the ``per_frame``-th largest of the frame that has
    fewest, so each frame keeps >= ``per_frame`` candidates before NMS and
    none sits near the threshold.  Returns the calibration."""
    from refplain.dcnn.models.roi_heads import POOL_LEVELS, fpn_roi_align

    model, heads, roi = ref.model, ref.model.roi_heads, ref.cfg.roi
    t = roi.score_thresh_test
    shifts = []
    for b in range(0, len(frames), batch):
        x = torch.from_numpy(np.stack(frames[b:b + batch])).to(ref.device)
        x, _ = ref.pre(x, with_gray=False)
        with torch.no_grad():
            feats = model.features(ref.resize(x))
            boxes, _, valid = model.proposals(feats, ref.pad_hw)
            pooled = fpn_roi_align({n: feats[n] for n in POOL_LEVELS}, boxes, roi.box_pooler_resolution,
                                   roi.pooler_sampling_ratio)
            logits, _ = heads.box_predictor(heads.box_head(pooled.reshape(-1, pooled[0, 0].numel())))
        lg = logits.reshape(*boxes.shape[:2], -1).double()
        fg, bg = lg[..., :-1], lg[..., -1]
        k = fg.argmax(-1, keepdim=True)
        best = fg.gather(-1, k)[..., 0]
        rest = torch.logsumexp(fg.scatter(-1, k, float("-inf")), -1)
        room = torch.exp(best) * (1.0 / t - 1.0) - torch.exp(rest)
        shift = torch.log(torch.clamp(room, min=1e-300)) - bg
        shifts += list(torch.where(valid & (room > 0), shift, torch.full_like(shift, float("-inf"))).cpu())
    ranked = [torch.sort(s, descending=True).values for s in shifts]
    target = min(float(s[per_frame - 1]) for s in ranked)
    near = np.sort(np.concatenate([s[(s < target) & (s > target - 1.0)].numpy() for s in ranked] + [[target]]))
    gaps = np.diff(near)
    i = int(np.argmax(gaps)) if len(gaps) else 0
    delta = float((near[i] + near[i + 1]) / 2) if len(gaps) else target - 0.5
    key = "roi_heads.box_predictor.cls_score.bias"
    ckpt[key] = ckpt[key].clone()
    ckpt[key][-1] += delta
    load_key = dict(ref.model.named_parameters())[key]
    load_key.copy_(ckpt[key].to(load_key.device))
    return {"background_bias": float(ckpt[key][-1]), "margin": float(gaps[i] / 2) if len(gaps) else 0.5,
            "candidates_per_frame": [int((s > delta).sum()) for s in ranked]}
