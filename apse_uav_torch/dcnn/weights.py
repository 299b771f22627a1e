"""Checkpoint import: detectron2 ``.pkl`` / ``.pth`` files into the port's models.

Counterpart of ``load_torch_file`` and ``map_detectron2_weights`` in the JAX
reference's ``dcnn/weights.py``.  The port's :class:`MaskRCNN` is named as
detectron2's GeneralizedRCNN, so loading is a key-for-key copy: no layout
change (convolutions stay OIHW, Linear stays (out, in), ConvTranspose2d
stays (in, out, kh, kw), unflipped).  The keys taken are the reference's:
the trunk of the configured depth, the FPN, the RPN head, the box head and
predictor and, with masks, the mask head.  Weights from the JAX package's
parameter trees come in through ``apse_uav_torch.convert``.
"""

from __future__ import annotations

import pickle

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


def _with_backbone_prefix(src: dict) -> dict:
    """Some zoo pickles name the ResNet without the FPN wrapper
    (``stem.conv1.weight``): put those keys under ``backbone.bottom_up``."""
    if "backbone.bottom_up.stem.conv1.weight" in src or "stem.conv1.weight" not in src:
        return src
    trunk = ("stem.", "res2.", "res3.", "res4.", "res5.")
    return {(f"backbone.bottom_up.{k}" if k.startswith(trunk) else k): v for k, v in src.items()}


def load_detectron2(model: torch.nn.Module, src: dict) -> tuple[list[str], list[str]]:
    """Copy a detectron2 GeneralizedRCNN state dict (arrays or tensors) into
    the port's MaskRCNN (or any module named as detectron2 names it).

    Returns (missing: model keys the checkpoint lacks, left as they were;
    unused: checkpoint keys the model has no place for).  A shape mismatch
    raises (it means a wrong config, e.g. the class count).
    """
    src = _with_backbone_prefix(dict(src))
    own = model.state_dict()
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
