"""Marker measurement math from the reference algorithm, in PyTorch.

Counterpart of the JAX reference's ``aruco/geometry.py``; the reference's int()
truncations and np.int32 casts are kept on purpose.  Functions take leading
batch dimensions where the JAX versions were vmapped.
"""

from __future__ import annotations

import torch

from apse_uav_torch.core import camera, rotation
from apse_uav_torch.utils import profiling

MARKER_LENGTH_ORG = 0.55
MARKER_DIV = 1.2
DIV = 1.013
FRAME_W, FRAME_H = 3840, 2160

VEH4_LIDAR = ((-0.05, -0.80, 0.0),)
VEH_COORDS = ((0.0, 0.42, 0.0), (0.0, 0.59, 0.0), (0.0, 0.58, 0.0), (0.0, 0.07, 0.0))
# Vehicle dims [back, front, left, right]; order veh1..veh3, veh4.
VEH_DIMS = (
    (-1.95, 2.8, -0.9, 0.9),
    (-1.68, 2.86, -0.87, 0.87),
    (-1.32, 2.48, -0.86, 0.86),
    (-2.35, 2.49, -0.86, 0.86),
)
LED_POINTS = (
    (-0.419, -0.42, 0.0), (-0.414, -0.305, 0.0), (-0.409, -0.19, 0.0),
    (-0.404, -0.07, 0.0), (-0.399, 0.065, 0.0), (-0.393, 0.19, 0.0),
    (-0.388, 0.315, 0.0), (-0.382, 0.435, 0.0),
)


def const(values, device) -> torch.Tensor:
    """``values`` as a float32 tensor on ``device``: a copy from the host, one sync on the card."""
    with profiling.sync("const"):
        return torch.tensor(values, dtype=torch.float32, device=device)


def marker_center_and_size(corners: torch.Tensor):
    """getMarkerData's centre/size math: corners (..., 4, 2) x,y -> cx, cy, msp.
    cx = |int(sum of x) / 4| (truncation of the SUM, then division)."""
    cx = torch.abs(torch.trunc(corners[..., 0].sum(-1)) / 4.0)
    cy = torch.abs(torch.trunc(corners[..., 1].sum(-1)) / 4.0)
    sides = torch.linalg.vector_norm(corners - torch.roll(corners, -1, dims=-2), dim=-1)
    return cx, cy, sides.mean(-1)


def displacement_metres(cx, cy, cx_prev, cy_prev, marker_length, msp):
    return torch.sqrt((cx_prev - cx) ** 2 + (cy_prev - cy) ** 2) * marker_length / msp


def marker_length_correction(altitude):
    return MARKER_LENGTH_ORG * (1.0 - 0.00057 * altitude / MARKER_DIV) / DIV


def average_marker_size(msp_ring: torch.Tensor, msp: torch.Tensor):
    """Ring buffer (..., N_avg) + new size (...,) -> (new_ring, size_corr, msp_avg)."""
    new_ring = torch.cat([msp_ring[..., 1:], msp[..., None]], dim=-1)
    nonzero = torch.clamp((new_ring != 0.0).sum(-1), min=1)
    size_corr = new_ring.sum(-1) / (msp * nonzero)
    return new_ring, size_corr, msp * size_corr


def project_int(points, rvec, tvec, mtx, dist, bias: torch.Tensor | None = None, tilt: bool | None = None):
    """projectPoints + np.maximum(0, np.int32(...)): truncate, clamp at 0;
    ``bias`` (2,) x, y pixels is added before the truncation."""
    proj = camera.project_points(points, rvec, tvec, mtx, dist, tilt=tilt)
    if bias is not None:
        proj = proj + bias
    return torch.clamp(torch.trunc(proj), min=0.0)


def bbox_dims_update(tvec, rvec, veh_dim):
    """drawBoundingBox's perspective dim modification; (..., 3), (..., 3), (..., 4)."""
    alpha_h = torch.atan(tvec[..., 0] / tvec[..., 2])
    alpha_v = torch.atan(tvec[..., 1] / tvec[..., 2])
    yaw_deg = rotation.rotvec_to_euler_zxy(rvec, degrees=True)[..., 0]
    yaw = torch.round(yaw_deg * 100.0) / 100.0
    alpha_h = torch.where(yaw < 0, alpha_h, -alpha_h)
    alpha_v = torch.where(yaw < 0, alpha_v, -alpha_v)
    return veh_dim * torch.stack([1 - alpha_h / 2.0, 1 + alpha_h / 2.0, 1 - alpha_v / 2.0, 1 + alpha_v / 2.0], -1)


def _linspace(a, b, n):
    """jnp.linspace(a, b, n) for batched endpoints (..., ) -> (..., n):
    a*(1 - t) + b*t with t = i/(n-1), the endpoint appended exactly."""
    t = torch.arange(n - 1, dtype=a.dtype, device=a.device)
    t = t / torch.full((), n - 1, dtype=a.dtype, device=a.device)
    out = a[..., None] * (1 - t) + b[..., None] * t
    return torch.cat([out, b[..., None]], dim=-1)


def bbox_perimeter_points(veh_dim: torch.Tensor) -> torch.Tensor:
    """generatePointsBoundingBox: (..., 4) dims -> (..., 56, 3) object points."""
    points_l, points_w = 20, 8
    o1 = _linspace(veh_dim[..., 0], veh_dim[..., 1], points_l)
    o2 = _linspace(veh_dim[..., 2], veh_dim[..., 3], points_w)
    full = lambda v, n: v[..., None].expand(*v.shape, n)
    obj1 = torch.stack([o1, full(veh_dim[..., 2], points_l)], -1)
    obj2 = torch.stack([o1, full(veh_dim[..., 3], points_l)], -1)
    obj3 = torch.stack([full(veh_dim[..., 0], points_w), o2], -1)
    obj4 = torch.stack([full(veh_dim[..., 1], points_w), o2], -1)
    obj = torch.cat([obj1, obj2, obj3, obj4], dim=-2)  # (..., 56, 2) [len, wid]
    return torch.stack([obj[..., 1], obj[..., 0], torch.zeros_like(obj[..., 0])], -1)


def min_distance_bbox_point(source_xy, bbox_pts, rvec, tvec, mtx, dist, tilt: bool | None = None):
    """findMinimumDistanceBoundingBox: the projected (truncated) bbox point
    closest to source_xy (..., 2); first minimum on ties."""
    imgpts = project_int(bbox_pts, rvec, tvec, mtx, dist, tilt=tilt)  # (..., 56, 2)
    d = torch.sqrt(((imgpts - source_xy[..., None, :]) ** 2).sum(-1))
    i = torch.argmin(d, dim=-1)
    return torch.gather(imgpts, -2, i[..., None, None].expand(*i.shape, 1, 2))[..., 0, :]


def pixel_distance_to_metres(src_xy, dst_xy, marker_length, msp4, msp):
    d = torch.sqrt(((src_xy - dst_xy) ** 2).sum(-1))
    return d * marker_length / ((msp4 + msp) / 2.0)
