"""Pinhole camera with OpenCV's 14-coefficient distortion, in PyTorch.

Counterpart of the JAX reference's ``core/camera.py``.  Distortion vectors follow
OpenCV ordering ``(k1, k2, p1, p2, k3, k4, k5, k6, s1, s2, s3, s4, tau_x,
tau_y)``; shorter vectors are zero-padded.  All math is float32 on whatever
device the inputs live on, with any leading batch dimensions.

The tilted-sensor terms (tau) are applied only when one of them is non-zero
(JAX: ``lax.cond``).  Callers that know the camera pass ``tilt`` explicitly so
that no device value is read back on the hot path.
"""

from __future__ import annotations

import numpy as np
import torch

from refplain.core import rotation as rot

_N_DIST = 14


def pad_dist_coeffs(dist, device=None, dtype=torch.float32) -> torch.Tensor:
    """Flatten + zero-pad a distortion vector to 14 entries."""
    d = torch.as_tensor(np.asarray(dist) if not torch.is_tensor(dist) else dist, dtype=dtype, device=device).reshape(-1)
    if d.shape[0] > _N_DIST:
        raise ValueError(f"at most {_N_DIST} distortion coefficients supported, got {d.shape[0]}")
    return torch.cat([d, torch.zeros(_N_DIST - d.shape[0], dtype=d.dtype, device=d.device)])


def has_tilt(dist) -> bool:
    """True when the tilted-sensor coefficients (tau_x, tau_y) are non-zero."""
    d = np.zeros(_N_DIST)
    src = dist.detach().cpu().numpy() if torch.is_tensor(dist) else np.asarray(dist, np.float64)
    d[: src.size] = src.reshape(-1)
    return bool(d[12] != 0.0 or d[13] != 0.0)


def _tilt_matrix(tau_x: torch.Tensor, tau_y: torch.Tensor) -> torch.Tensor:
    """OpenCV tilted-sensor (Scheimpflug) projection matrix (3, 3)."""
    cx, sx = torch.cos(tau_x), torch.sin(tau_x)
    cy, sy = torch.cos(tau_y), torch.sin(tau_y)
    zero, one = torch.zeros_like(cx), torch.ones_like(cx)
    r = torch.stack([
        torch.stack([cy, sy * sx, -sy * cx]),
        torch.stack([zero, cx, sx]),
        torch.stack([sy, -cy * sx, cy * cx]),
    ])
    proj = torch.stack([
        torch.stack([r[2, 2], zero, -r[0, 2]]),
        torch.stack([zero, r[2, 2], -r[1, 2]]),
        torch.stack([zero, zero, one]),
    ])
    return proj @ r.T


def distort_normalized(xy: torch.Tensor, dist: torch.Tensor, tilt: bool | None = None) -> torch.Tensor:
    """Apply the 14-coefficient distortion to normalized coords (..., 2)."""
    k1, k2, p1, p2, k3, k4, k5, k6, s1, s2, s3, s4, tx, ty = [dist[i] for i in range(_N_DIST)]
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    r4 = r2 * r2
    r6 = r4 * r2
    num = 1.0 + k1 * r2 + k2 * r4 + k3 * r6
    den = 1.0 + k4 * r2 + k5 * r4 + k6 * r6
    radial = num / den
    xy2 = 2.0 * x * y
    xd = x * radial + p1 * xy2 + p2 * (r2 + 2.0 * x * x) + s1 * r2 + s2 * r4
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + p2 * xy2 + s3 * r2 + s4 * r4
    if tilt is None:
        tilt = has_tilt(dist)
    if tilt:
        m = _tilt_matrix(tx, ty)
        w = m[2, 0] * xd + m[2, 1] * yd + m[2, 2]
        xd, yd = (m[0, 0] * xd + m[0, 1] * yd + m[0, 2]) / w, (m[1, 0] * xd + m[1, 1] * yd + m[1, 2]) / w
    return torch.stack([xd, yd], dim=-1)


def undistort_normalized(xy_dist: torch.Tensor, dist: torch.Tensor, num_iters: int = 5,
                         tilt: bool | None = None) -> torch.Tensor:
    """Invert :func:`distort_normalized` by ``num_iters`` fixed-point steps
    (cv::undistortPoints' loop; OpenCV runs exactly 5)."""
    k1, k2, p1, p2, k3, k4, k5, k6, s1, s2, s3, s4, tx, ty = [dist[i] for i in range(_N_DIST)]
    if tilt is None:
        tilt = has_tilt(dist)
    xy0 = xy_dist
    if tilt:
        m = torch.linalg.inv(_tilt_matrix(tx, ty))
        x, y = xy_dist[..., 0], xy_dist[..., 1]
        w = m[2, 0] * x + m[2, 1] * y + m[2, 2]
        xy0 = torch.stack([(m[0, 0] * x + m[0, 1] * y + m[0, 2]) / w, (m[1, 0] * x + m[1, 1] * y + m[1, 2]) / w], -1)
    xy = xy0
    for _ in range(num_iters):
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        r4 = r2 * r2
        r6 = r4 * r2
        icdist = (1.0 + k4 * r2 + k5 * r4 + k6 * r6) / (1.0 + k1 * r2 + k2 * r4 + k3 * r6)
        xy2 = 2.0 * x * y
        dx = p1 * xy2 + p2 * (r2 + 2.0 * x * x) + s1 * r2 + s2 * r4
        dy = p1 * (r2 + 2.0 * y * y) + p2 * xy2 + s3 * r2 + s4 * r4
        xy = torch.stack([(xy0[..., 0] - dx) * icdist, (xy0[..., 1] - dy) * icdist], dim=-1)
    return xy


def pixels_to_normalized(uv: torch.Tensor, mtx: torch.Tensor) -> torch.Tensor:
    fx, fy, cx, cy = mtx[0, 0], mtx[1, 1], mtx[0, 2], mtx[1, 2]
    return torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], dim=-1)


def normalized_to_pixels(xy: torch.Tensor, mtx: torch.Tensor) -> torch.Tensor:
    fx, fy, cx, cy = mtx[0, 0], mtx[1, 1], mtx[0, 2], mtx[1, 2]
    return torch.stack([xy[..., 0] * fx + cx, xy[..., 1] * fy + cy], dim=-1)


def undistort_points(uv: torch.Tensor, mtx: torch.Tensor, dist: torch.Tensor, num_iters: int = 5,
                     tilt: bool | None = None) -> torch.Tensor:
    """cv2.undistortPoints equivalent: distorted pixels -> ideal normalized."""
    return undistort_normalized(pixels_to_normalized(uv, mtx), dist, num_iters, tilt=tilt)


def project_points(obj_pts: torch.Tensor, rvec: torch.Tensor, tvec: torch.Tensor, mtx: torch.Tensor,
                   dist: torch.Tensor, tilt: bool | None = None) -> torch.Tensor:
    """cv2.projectPoints equivalent.

    obj_pts (..., N, 3), rvec/tvec (..., 3), 14-entry dist -> (..., N, 2) px.
    """
    r_mat = rot.rodrigues_to_matrix(rvec)
    cam = obj_pts @ r_mat.transpose(-1, -2) + tvec[..., None, :]
    xy = cam[..., :2] / cam[..., 2:3]
    return normalized_to_pixels(distort_normalized(xy, dist, tilt=tilt), mtx)


def undistort_rectify_map(mtx: torch.Tensor, dist: torch.Tensor, size_wh: tuple[int, int],
                          tilt: bool | None = None) -> torch.Tensor:
    """cv2.initUndistortRectifyMap equivalent: (H, W, 2) float32 source (x, y)
    per destination pixel, evaluated in float32 on ``mtx``'s device."""
    w, h = size_wh
    u = torch.arange(w, dtype=torch.float32, device=mtx.device)
    v = torch.arange(h, dtype=torch.float32, device=mtx.device)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    xy = pixels_to_normalized(torch.stack([uu, vv], dim=-1), mtx)
    return normalized_to_pixels(distort_normalized(xy, dist, tilt=tilt), mtx)
