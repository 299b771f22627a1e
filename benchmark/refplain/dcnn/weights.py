"""Loading a detectron2 state dict into the plain model.

Counterpart of the JAX reference's ``dcnn/weights.py`` detectron2 import.
The models are named as detectron2's GeneralizedRCNN (R-FPN:
``backbone.bottom_up.*``), so loading is a key-for-key copy: no layout
change (convolutions stay OIHW, Linear stays (out, in), ConvTranspose2d
stays (in, out, kh, kw), unflipped).
"""

from __future__ import annotations

import numpy as np
import torch

# Checkpoint entries that are not parameters of the model (detectron2's
# normalisation buffers; the port takes them from the config).
_NOT_PARAMS = ("pixel_mean", "pixel_std")


def _with_backbone_prefix(src: dict, trunk: str = "backbone.bottom_up.") -> dict:
    """Some zoo pickles name the ResNet without its wrapper
    (``stem.conv1.weight``): put those keys under ``trunk``
    (``backbone.bottom_up.`` in R-FPN)."""
    if "stem.conv1.weight" not in src or f"{trunk}stem.conv1.weight" in src:
        return src
    stages = ("stem.", "res2.", "res3.", "res4.", "res5.")
    return {(f"{trunk}{k}" if k.startswith(stages) else k): v for k, v in src.items()}


def load_detectron2(model: torch.nn.Module, src: dict) -> tuple[list[str], list[str]]:
    """Copy a detectron2 GeneralizedRCNN state dict (arrays or tensors) into
    the plain MaskRCNN (or any module named as detectron2 names it).

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
