"""Synthetic UAV test-track scenes rendered through the real camera model.

Counterpart of ``render_scene`` in the JAX reference's ``utils/synthetic.py``, in
float64 PyTorch on any device, so a 4K scene renders on the card in well
under a second.  ArUco markers (DICT_4X4_50) on vehicle roofs are seen from
altitude through the inverse of the 14-coefficient lens model, supersampled
and box-filtered; the host car carries the 8-LED panel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from apse_uav_torch.aruco.dictionary import marker_image
from apse_uav_torch.device import resolve_device

MARKER_LEN = 0.55
LED_OFFSETS = (
    (-0.419, -0.42), (-0.414, -0.305), (-0.409, -0.19), (-0.404, -0.07),
    (-0.399, 0.065), (-0.393, 0.19), (-0.388, 0.315), (-0.382, 0.435),
)

ASPHALT = 96.0
ROOF = 235.0
MARKER_BLACK = 25.0
MARKER_WHITE = 245.0
LED_ON = 255.0
LED_OFF = 35.0


@dataclasses.dataclass
class MarkerSpec:
    """One marker on the ground plane."""

    marker_id: int
    center_xy: tuple[float, float]  # world metres
    yaw_deg: float = 0.0
    roof_halfsize: tuple[float, float] = (1.1, 2.0)  # white roof region (w/2, l/2)
    leds: int | None = None  # 8-bit LED panel value (host car only)


def _undistort(xd: torch.Tensor, yd: torch.Tensor, dist, num_iters: int = 25):
    """Fixed-point lens inversion, bounded so far corners stay finite."""
    d = np.zeros(14)
    d[: np.asarray(dist).size] = np.asarray(dist, np.float64).reshape(-1)
    k1, k2, p1, p2, k3, k4, k5, k6, s1, s2, s3, s4 = (float(v) for v in d[:12])
    x, y = xd.clone(), yd.clone()
    lim = float(2.0 * max(xd.abs().max().item(), yd.abs().max().item()) + 1.0)
    for _ in range(num_iters):
        r2 = x * x + y * y
        r4 = r2 * r2
        r6 = r4 * r2
        icdist = (1 + k4 * r2 + k5 * r4 + k6 * r6) / (1 + k1 * r2 + k2 * r4 + k3 * r6)
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x) + s1 * r2 + s2 * r4
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y + s3 * r2 + s4 * r4
        x = torch.clamp((xd - dx) * icdist, -lim, lim)
        y = torch.clamp((yd - dy) * icdist, -lim, lim)
    return x, y


def render_scene(mtx, dist, size_wh: tuple[int, int], markers: list[MarkerSpec], altitude: float = 40.0,
                 cam_yaw_deg: float = 0.0, supersample: int = 2, distorted: bool = True,
                 device="cuda") -> torch.Tensor:
    """Render a (H, W, 3) uint8 capture of markers on the ground plane, on
    ``device`` (cuda unless the caller asks for cpu).

    The camera sits at (0, 0, altitude) looking straight down with yaw
    ``cam_yaw_deg``; with ``distorted`` the image is the raw capture (the
    input that preprocessing undistorts).
    """
    device = resolve_device(device)
    w, h = size_wh
    ss = supersample
    f64 = dict(dtype=torch.float64, device=device)
    mtx = np.asarray(mtx, np.float64)
    fx, fy, cx, cy = mtx[0, 0], mtx[1, 1], mtx[0, 2], mtx[1, 2]
    u = (torch.arange(w * ss, **f64) + 0.5) / ss - 0.5
    v = (torch.arange(h * ss, **f64) + 0.5) / ss - 0.5
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    if distorted:
        x_n, y_n = _undistort((uu - cx) / fx, (vv - cy) / fy, dist)
    else:
        x_n, y_n = (uu - cx) / fx, (vv - cy) / fy
    c_r, s_r = float(np.cos(np.radians(cam_yaw_deg))), float(np.sin(np.radians(cam_yaw_deg)))
    xw = altitude * (c_r * x_n - s_r * y_n)
    yw = altitude * (s_r * x_n + c_r * y_n)
    del x_n, y_n, uu, vv

    img = torch.full(xw.shape, ASPHALT, **f64)
    img += 8.0 * torch.sin(xw * 1.7) * torch.cos(yw * 2.3)
    half = MARKER_LEN / 2.0
    for spec in markers:
        mx0, my0 = spec.center_xy
        yaw = np.radians(spec.yaw_deg)
        c, s = float(np.cos(yaw)), float(np.sin(yaw))
        lx = c * (xw - mx0) + s * (yw - my0)
        ly = -s * (xw - mx0) + c * (yw - my0)
        rw_, rl = spec.roof_halfsize
        img = torch.where((lx.abs() <= rw_) & (ly.abs() <= rl), torch.full_like(img, ROOF), img)
        inside = (lx.abs() <= half) & (ly.abs() <= half)
        gx = torch.clamp(torch.nan_to_num((lx + half) / MARKER_LEN * 6).to(torch.int64), 0, 5)
        gy = torch.clamp(torch.nan_to_num((ly + half) / MARKER_LEN * 6).to(torch.int64), 0, 5)
        pattern = torch.as_tensor(marker_image(spec.marker_id), device=device)
        vals = torch.where(pattern[gy, gx] > 127, torch.full_like(img, MARKER_WHITE), torch.full_like(img, MARKER_BLACK))
        img = torch.where(inside, vals, img)
        if spec.leds is not None:
            for j, (ox, oy) in enumerate(LED_OFFSETS):
                on = (spec.leds >> (7 - j)) & 1
                led = (lx - ox) ** 2 + (ly + oy) ** 2 <= 0.06**2
                img = torch.where(led, torch.full_like(img, LED_ON if on else LED_OFF), img)
    img = img.reshape(h, ss, w, ss).mean(dim=(1, 3))
    img = torch.clamp(torch.round(img), 0, 255).to(torch.uint8)
    return img[..., None].expand(h, w, 3).contiguous()
