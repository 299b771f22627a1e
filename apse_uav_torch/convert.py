"""Carry state across packages: configs, camera arrays and the temporal carry.

The JAX package's dataclasses are read through ``dataclasses.asdict`` and its
carry as a dict of numpy arrays, so this module needs nothing of that
package.  Fields that only steer the reference's TPU kernels are dropped;
any other unknown field raises, so a new option is never silently lost.
"""

from __future__ import annotations

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
    return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})


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
