"""Checkpoint import and weight surgery on detectron2 names.

Counterpart of the JAX reference's ``dcnn/weights.py``: ``load_torch_file``,
the detectron2 import (``map_detectron2_weights`` and, for C4,
``map_detectron2_weights_c4``) and the surgery of the reference's scripts
(:func:`strip_backbone_prefix`, :func:`merge_mask_head`,
:func:`slice_predictor_classes`).  The port's models are named as
detectron2's GeneralizedRCNN (R-FPN: ``backbone.bottom_up.*``; C4:
``backbone.res2`` .. ``res4`` and ``roi_heads.res5``), so loading is a
key-for-key copy: no layout change (convolutions stay OIHW, Linear stays
(out, in), ConvTranspose2d stays (in, out, kh, kw), unflipped), and the
surgery works on those names too.  The keys taken are the reference's: the
trunk of the configured depth, the FPN, the RPN head, the box head and
predictor and, with masks, the mask head (:func:`reference_subset`).
Weights from the JAX package's parameter trees come in through
``apse_uav_torch.convert``.
"""

from __future__ import annotations

import pickle
import re

import numpy as np
import torch

# Checkpoint entries that are not parameters of the model (detectron2's
# normalisation buffers; the port takes them from the config).
_NOT_PARAMS = ("pixel_mean", "pixel_std")


def load_torch_file(path: str) -> dict[str, np.ndarray]:
    """A detectron2 ``.pkl`` (pickled dict of numpy arrays, model-zoo format)
    or torch ``.pth`` checkpoint as {name: ndarray}.  Only load files you
    trust: a ``.pkl`` is unpickled as it is."""
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            data = pickle.load(f, encoding="latin1")
        blobs = data.get("model", data)
        return {k: np.asarray(v) for k, v in blobs.items() if isinstance(v, np.ndarray)}
    data = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(data, dict) and "model" in data:
        data = data["model"]
    if isinstance(data, dict) and "state_dict" in data:
        data = data["state_dict"]
    return {k: v.numpy() for k, v in data.items() if isinstance(v, torch.Tensor)}


def _with_backbone_prefix(src: dict, trunk: str = "backbone.bottom_up.") -> dict:
    """Some zoo pickles name the ResNet without its wrapper
    (``stem.conv1.weight``): put those keys under ``trunk``
    (``backbone.bottom_up.`` in R-FPN, ``backbone.`` in C4, as the reference
    strips a bare prefix for C4)."""
    if "stem.conv1.weight" not in src or f"{trunk}stem.conv1.weight" in src:
        return src
    stages = ("stem.", "res2.", "res3.", "res4.", "res5.")
    return {(f"{trunk}{k}" if k.startswith(stages) else k): v for k, v in src.items()}


def load_detectron2(model: torch.nn.Module, src: dict) -> tuple[list[str], list[str]]:
    """Copy a detectron2 GeneralizedRCNN state dict (arrays or tensors) into
    the port's MaskRCNN or MaskRCNNC4 (or any module named as detectron2
    names it).

    Returns (missing: model keys the checkpoint lacks, left as they were;
    unused: checkpoint keys the model has no place for).  A shape mismatch
    raises (it means a wrong config, e.g. the class count).
    """
    own = model.state_dict()
    src = _with_backbone_prefix(dict(src), "backbone.bottom_up." if any(
        k.startswith("backbone.bottom_up.") for k in own) else "backbone.")
    missing = [k for k in own if k not in src]
    unused = [k for k in src if k not in own and k not in _NOT_PARAMS]
    merged = dict(own)
    for k, v in src.items():
        if k not in own:
            continue
        t = torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
        if tuple(t.shape) != tuple(own[k].shape):
            raise ValueError(f"shape mismatch at {k}: model {tuple(own[k].shape)} vs checkpoint {tuple(t.shape)}")
        merged[k] = t.to(dtype=own[k].dtype)
    model.load_state_dict(merged, strict=True)
    return missing, unused


_BN_LEAVES = r"(weight|norm\.(weight|bias|running_mean|running_var))"
_HEAD_PATTERNS = (r"backbone\.fpn_(lateral|output)[2-5]\.(weight|bias)",
                  r"proposal_generator\.rpn_head\.(conv|objectness_logits|anchor_deltas)\.(weight|bias)",
                  r"roi_heads\.box_head\.fc[12]\.(weight|bias)",
                  r"roi_heads\.box_predictor\.(cls_score|bbox_pred)\.(weight|bias)")
_MASK_PATTERN = r"roi_heads\.mask_head\.(mask_fcn[1-4]|deconv|predictor)\.(weight|bias)"


def reference_subset(src: dict, depth: int, mask_on: bool = True) -> dict:
    """The entries of a detectron2 R-FPN checkpoint that the reference's
    ``map_detectron2_weights(src, depth, mask_on)`` takes, under the port's
    names: the stem and the blocks of a ResNet of ``depth`` (a bare-named
    trunk moved under ``backbone.bottom_up``), the FPN, the RPN head, the box
    head and predictor and, with ``mask_on``, the mask head.  (The reference
    writes what it took as flax paths; the port keeps detectron2's names.)"""
    from apse_uav_torch.dcnn.models.resnet import STAGE_BLOCKS

    src = _with_backbone_prefix(dict(src))
    trunk = re.compile(rf"backbone\.bottom_up\.(stem\.conv1\.{_BN_LEAVES}|res(?P<stage>[2-5])\.(?P<block>\d+)\."
                       rf"(conv[123]|shortcut)\.{_BN_LEAVES})")
    heads = re.compile("|".join(_HEAD_PATTERNS + ((_MASK_PATTERN,) if mask_on else ())))

    def taken(k: str) -> bool:
        m = trunk.fullmatch(k)
        if m:
            return m["stage"] is None or int(m["block"]) < STAGE_BLOCKS[depth][int(m["stage"]) - 2]
        return heads.fullmatch(k) is not None

    return {k: v for k, v in src.items() if taken(k)}


def strip_backbone_prefix(flat: dict) -> dict:
    """PartialCheckpointer: the ``backbone.*`` entries of a whole-model state
    dict, without that prefix, to load into a bare backbone (the reference's
    ``strip_backbone_prefix``; partial_checkpointer.py:11-20)."""
    return {k[len("backbone."):]: v for k, v in flat.items() if k.startswith("backbone.")}


def merge_mask_head(detector: dict, mask_source: dict) -> dict:
    """``detector`` with the mask-head entries of ``mask_source`` grafted in
    (finetune_segmentation.py merge_full_mask_rcnn:53-61)."""
    return {**detector, **{k: v for k, v in mask_source.items() if k.startswith("roi_heads.mask_head.")}}


def slice_predictor_classes(flat: dict, class_rows: list[int], num_src_classes: int) -> dict:
    """Class-specific predictor weights cut down to ``class_rows`` of a
    ``num_src_classes`` set (add_mask_head_to_frcnn.py:62-73): the class
    scores' (K + 1, D) rows ``class_rows`` and the background row (last),
    the box deltas' (4K, D) rows 4c..4c+3 of each class, the mask
    predictor's (K, C, 1, 1) channels ``class_rows``; biases alike.  The
    same rows the reference selects on its transposed flax kernels."""
    out = dict(flat)
    rows = list(class_rows)
    cuts = {"roi_heads.box_predictor.cls_score": rows + [num_src_classes],
            "roi_heads.box_predictor.bbox_pred": [4 * c + j for c in rows for j in range(4)],
            "roi_heads.mask_head.predictor": rows}
    for name, sel in cuts.items():
        if f"{name}.weight" in flat:
            for leaf in ("weight", "bias"):
                out[f"{name}.{leaf}"] = flat[f"{name}.{leaf}"][sel]
    return out
