"""Rotation math in PyTorch: Rodrigues vectors, matrices, zxy Euler angles.

Counterpart of the JAX reference's ``core/rotation.py``.  Every function takes any
number of leading batch dimensions (``rvec (..., 3)``, ``r_mat (..., 3, 3)``);
the JAX ``lax.cond`` branches become ``torch.where`` over both branches.
"""

from __future__ import annotations

import math

import torch


def _skew(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [torch.stack([zero, -z, y], -1), torch.stack([z, zero, -x], -1), torch.stack([-y, x, zero], -1)], -2
    )


def rodrigues_to_matrix(rvec: torch.Tensor) -> torch.Tensor:
    """Rotation vector (..., 3) -> rotation matrix (..., 3, 3)."""
    theta2 = torch.sum(rvec * rvec, dim=-1)
    theta = torch.sqrt(theta2 + 1e-30)
    small = theta2 < 1e-12
    sinc = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    cosc = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    k = _skew(rvec)
    kk = k @ k
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    return eye + sinc[..., None, None] * k + cosc[..., None, None] * kk


def matrix_to_rodrigues(r_mat: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> rotation vector (..., 3)."""
    trace = torch.clamp(r_mat[..., 0, 0] + r_mat[..., 1, 1] + r_mat[..., 2, 2], -1.0, 3.0)
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    axis_sin = 0.5 * torch.stack(
        [r_mat[..., 2, 1] - r_mat[..., 1, 2], r_mat[..., 0, 2] - r_mat[..., 2, 0],
         r_mat[..., 1, 0] - r_mat[..., 0, 1]], -1
    )
    sin_t = torch.sin(theta)
    generic = axis_sin * (theta / torch.where(torch.abs(sin_t) < 1e-12, torch.ones_like(sin_t), sin_t))[..., None]

    # theta ~ pi: axis from the diagonal of (R + I)/2 = a a^T, signs from
    # the off-diagonal terms anchored on the largest component.
    diag = torch.clamp((torch.diagonal(r_mat, dim1=-2, dim2=-1) + 1.0) * 0.5, min=0.0)
    axis = torch.sqrt(diag)
    i = torch.argmax(axis, dim=-1)
    s01 = torch.sign(r_mat[..., 0, 1])
    s02 = torch.sign(r_mat[..., 0, 2])
    s12 = torch.sign(r_mat[..., 1, 2])
    one = torch.ones_like(s01)
    signs_by_anchor = torch.stack(
        [torch.stack([one, s01, s02], -1), torch.stack([s01, one, s12], -1), torch.stack([s02, s12, one], -1)], -2
    )
    signs = torch.gather(signs_by_anchor, -2, i[..., None, None].expand(*i.shape, 1, 3))[..., 0, :]
    signs = torch.where(signs == 0.0, torch.ones_like(signs), signs)
    near_pi = axis * signs * theta[..., None]

    small = (theta < 1e-7)[..., None]
    return torch.where(small, axis_sin, torch.where((torch.abs(sin_t) < 1e-6)[..., None], near_pi, generic))


def matrix_to_euler_zxy(r_mat: torch.Tensor, degrees: bool = True) -> torch.Tensor:
    """scipy ``Rotation.as_euler('zxy')`` equivalent (extrinsic z-x-y), (..., 3)."""
    sb = -r_mat[..., 1, 2]
    b = torch.arcsin(torch.clamp(sb, -1.0, 1.0))
    gimbal = torch.abs(sb) > 1.0 - 1e-9
    a = torch.where(gimbal, torch.atan2(-r_mat[..., 0, 1], r_mat[..., 0, 0]), torch.atan2(r_mat[..., 1, 0], r_mat[..., 1, 1]))
    c = torch.where(gimbal, torch.zeros_like(b), torch.atan2(r_mat[..., 0, 2], r_mat[..., 2, 2]))
    angles = torch.stack([a, b, c], -1)
    return angles * (180.0 / math.pi) if degrees else angles


def rotvec_to_euler_zxy(rvec: torch.Tensor, degrees: bool = True) -> torch.Tensor:
    return matrix_to_euler_zxy(rodrigues_to_matrix(rvec), degrees=degrees)
