"""Carry state across packages: configs, camera arrays and the temporal carry.

The JAX package's dataclasses are read through ``dataclasses.asdict`` and its
carry as a dict of numpy arrays, so this module needs nothing of that
package.  Fields that only steer the reference's TPU kernels are dropped;
any other unknown field raises, so a new option is never silently lost.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from apse_uav_torch.aruco.detector import DetectorParams
from apse_uav_torch.aruco.pipeline import ArucoPipelineConfig
from apse_uav_torch.core import camera
from apse_uav_torch.device import resolve_device

# Reference fields that choose TPU kernels or their tuning; the port picks
# its kernels by device.
_TPU_DETECTOR_FIELDS = {"pallas_proposals", "pallas_interpret", "pallas_labeling"}
_TPU_PIPELINE_FIELDS = {"use_pallas_preproc", "preproc_frames_per_step", "pallas_pool", "scan_unroll"}


def _from_dict(cls, d: dict, tpu_only: set):
    d = {k: v for k, v in d.items() if k not in tpu_only}
    known = {f for f in cls.__dataclass_fields__}
    unknown = set(d) - known
    if unknown:
        raise ValueError(f"{cls.__name__} has no field(s) {sorted(unknown)}")
    return cls(**{k: _tuples(v) for k, v in d.items()})


def _tuples(v):
    """Lists (nested ones too, e.g. C4's anchor sizes) as tuples."""
    return tuple(_tuples(x) for x in v) if isinstance(v, (list, tuple)) else v


def detector_params(d: dict) -> DetectorParams:
    """Port DetectorParams from ``dataclasses.asdict`` of the JAX one."""
    return _from_dict(DetectorParams, d, _TPU_DETECTOR_FIELDS)


def pipeline_config(d: dict) -> ArucoPipelineConfig:
    """Port ArucoPipelineConfig from ``dataclasses.asdict`` of the JAX one."""
    return _from_dict(ArucoPipelineConfig, d, _TPU_PIPELINE_FIELDS)


def camera_tensors(mtx, dist, device="cuda"):
    """(mtx (3, 3) f32, dist (14,) f32) tensors on ``device``."""
    dev = resolve_device(device)
    return (torch.as_tensor(np.asarray(mtx, np.float64), dtype=torch.float32, device=dev),
            camera.pad_dist_coeffs(np.asarray(dist, np.float64), device=dev))


def carry_to_torch(carry: dict, device="cuda") -> dict[str, torch.Tensor]:
    """The temporal carry as numpy arrays (or array-likes) -> port tensors,
    dtypes kept (int32 / float32)."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.asarray(v), device=dev) for k, v in carry.items()}


def carry_to_numpy(carry: dict) -> dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in carry.items()}


# -- DCNN: configs and parameter trees ---------------------------------------


def model_config(d: dict):
    """Port a dcnn ModelConfig from ``dataclasses.asdict`` of the JAX one
    (nested configs included); unknown fields raise."""
    from apse_uav_torch.dcnn import config as dc

    d = dict(d)
    subs = {"anchors": dc.AnchorConfig, "rpn": dc.RPNConfig, "roi": dc.ROIConfig, "input": dc.InputConfig}
    for key, cls in subs.items():
        if key in d:
            d[key] = _from_dict(cls, d[key], set())
    return _from_dict(dc.ModelConfig, d, set())


def tracker_config(d: dict):
    """Port a TrackerConfig from ``dataclasses.asdict`` of the JAX one."""
    from apse_uav_torch.dcnn.config import TrackerConfig

    return _from_dict(TrackerConfig, d, set())


def _flax_conv(k) -> np.ndarray:
    """flax Conv kernel (kh, kw, I, O) -> torch (O, I, kh, kw)."""
    return np.ascontiguousarray(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def _flax_deconv(k) -> np.ndarray:
    """flax ConvTranspose kernel (kh, kw, I, O) -> torch ConvTranspose2d (I, O, kh, kw).
    flax applies the kernel unmirrored, torch's transposed convolution
    mirrored: the spatial axes flip back."""
    return np.ascontiguousarray(np.transpose(np.asarray(k), (2, 3, 0, 1))[:, :, ::-1, ::-1])


def _flax_dense(k) -> np.ndarray:
    """flax Dense kernel (I, O) -> torch Linear (O, I)."""
    return np.ascontiguousarray(np.asarray(k).T)


_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def _resnet_key(bb: str, parts: list[str]):
    """A path inside a JAX ResNet (``stem_conv``, ``res3_1/bn2/scale``, ...)
    under the detectron2 prefix ``bb`` -> (detectron2 key, layout function)."""
    leaf = parts[-1]
    if parts[0] == "stem_conv":
        return f"{bb}.stem.conv1.weight", _flax_conv
    if parts[0] == "stem_bn":
        return f"{bb}.stem.conv1.norm.{_BN[leaf]}", np.asarray
    stage, idx = parts[0][3:].split("_")  # res{stage}_{idx}
    base, layer = f"{bb}.res{stage}.{idx}", parts[1]
    if layer in ("conv1", "conv2", "conv3", "shortcut"):
        return f"{base}.{layer}.weight", _flax_conv
    conv = "shortcut" if layer == "shortcut_bn" else f"conv{layer[2:]}"
    return f"{base}.{conv}.norm.{_BN[leaf]}", np.asarray


def _mask_rcnn_key(path: str):
    """A JAX MaskRCNN or MaskRCNNC4 parameter path -> (detectron2 key, layout function)."""
    parts = path.split("/")
    leaf = parts[-1]
    ident = np.asarray
    trunk = re.fullmatch(r"stem_(conv|bn)|res[2-5]_\d+", parts[1]) if len(parts) > 2 else None
    if parts[:2] == ["backbone", "resnet"]:
        return _resnet_key("backbone.bottom_up", parts[2:])
    if parts[0] == "backbone" and trunk:  # C4: the trunk is the backbone
        return _resnet_key("backbone", parts[1:])
    if parts[0] == "res5" and trunk:  # C4: res5 lives in the ROI heads
        return _resnet_key("roi_heads", parts[1:])
    suffix, conv_fn = ("weight", _flax_conv) if leaf == "kernel" else ("bias", ident)
    if parts[0] == "box_predictor":  # C4's predictor, no FC trunk
        return f"roi_heads.box_predictor.{parts[1]}.{suffix}", _flax_dense if leaf == "kernel" else ident
    if parts[:2] == ["backbone", "fpn"]:
        kind = "lateral" if parts[2].startswith("lateral") else "output"
        return f"backbone.fpn_{kind}{parts[2][len(kind):]}.{suffix}", conv_fn
    rpn = {"conv": "conv", "objectness": "objectness_logits", "deltas": "anchor_deltas"}
    if parts[0] == "rpn_head" and parts[1] in rpn:
        return f"proposal_generator.rpn_head.{rpn[parts[1]]}.{suffix}", conv_fn
    if parts[0] == "box_head":
        owner = "box_head" if parts[1].startswith("fc") else "box_predictor"
        return f"roi_heads.{owner}.{parts[1]}.{suffix}", _flax_dense if leaf == "kernel" else ident
    if parts[0] == "mask_head":
        deconv = parts[1] == "deconv" and leaf == "kernel"
        return f"roi_heads.mask_head.{parts[1]}.{suffix}", _flax_deconv if deconv else conv_fn
    raise ValueError(f"no port parameter for JAX MaskRCNN parameter {path!r}")


def mask_rcnn_state_dict(flat: dict) -> dict[str, np.ndarray]:
    """The JAX MaskRCNN or MaskRCNNC4 parameters ({'/'-joined flax path:
    array}, e.g. ``weights.flatten`` of the tree) -> the port's state dict
    (detectron2 names): convolutions HWIO -> OIHW, Dense kernels transposed,
    the ConvTranspose kernel flipped back.  An unknown path raises."""
    out = {}
    for path, v in flat.items():
        key, fn = _mask_rcnn_key(path)
        out[key] = np.array(fn(v), np.float32)  # an owned, writable copy
    return out


def association_state_dict(flat: dict) -> dict[str, np.ndarray]:
    """The JAX AssociationHead parameters ({"fc/kernel", "fc/bias"}) -> the
    port's AssociationHead state dict."""
    unknown = set(flat) - {"fc/kernel", "fc/bias"}
    if unknown:
        raise ValueError(f"no port parameter for JAX AssociationHead parameter(s) {sorted(unknown)}")
    return {"fc.weight": np.array(_flax_dense(flat["fc/kernel"]), np.float32),
            "fc.bias": np.array(flat["fc/bias"], np.float32)}


def _flatten_tree(tree, prefix: str = "") -> dict:
    """A nested dict of arrays -> {'/'-joined path: array}."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten_tree(v, path))
        else:
            out[path] = v
    return out


def _params_state_dict(tree: dict) -> dict[str, np.ndarray]:
    """A JAX parameter tree (or a tree laid out like one) -> the port's
    state dict, MaskRCNN or AssociationHead by its paths."""
    flat = _flatten_tree(tree)
    is_head = set(flat) <= {"fc/kernel", "fc/bias"}
    return association_state_dict(flat) if is_head else mask_rcnn_state_dict(flat)


def _child(tree: dict, i: int):
    """A chain's i-th state (orbax restores tuple positions as string keys)."""
    return tree[str(i)] if str(i) in tree else tree[i]


def optimizer_state(opt_state: dict) -> dict:
    """An optax state the JAX package saved -> the port's
    :class:`~apse_uav_torch.train.optim.SGD` state.

    ``build_finetune_optimizer``'s state (multi_transform -> masked
    apply_if_finite -> chain(clip, decay, chain(trace, schedule))) gives the
    momentum traces of the trainable parameters (the frozen ones are masked
    out, empty), the schedule count and the finite-check counters; plain
    ``optax.sgd``'s (chain(trace, scale)) gives the traces alone.  The traces
    take the parameters' layouts and names."""
    if "inner_states" not in opt_state:
        return {"trace": _params_state_dict(_child(opt_state, 0)["trace"])}
    finite = opt_state["inner_states"]["train"]["inner_state"]
    sgd = _child(finite["inner_state"], 2)
    return {"trace": _params_state_dict(_child(sgd, 0)["trace"]), "count": int(_child(sgd, 1)["count"]),
            "notfinite_count": int(finite["notfinite_count"]), "last_finite": bool(finite["last_finite"]),
            "total_notfinite": int(finite["total_notfinite"])}


def checkpoint_state(state: dict) -> dict:
    """A training state the JAX package saved (``train.checkpoint.save_state``;
    orbax restores it as nested arrays) -> the port's checkpoint state
    (``apse_uav_torch.train.checkpoint``): ``params`` of a MaskRCNN through
    :func:`mask_rcnn_state_dict`, of an AssociationHead through
    :func:`association_state_dict`; ``opt_state`` through
    :func:`optimizer_state`; numbers as Python numbers.  A state saved in
    the middle of a JAX fine-tune resumes in the port on the same
    trajectory."""
    out = {}
    for key, value in state.items():
        if key == "params":
            value = _params_state_dict(value)
        elif key == "opt_state":
            value = optimizer_state(value)
        elif np.ndim(value) == 0 and hasattr(value, "dtype"):
            value = np.asarray(value).item()
        out[key] = value
    return out
