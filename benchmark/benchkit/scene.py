"""The recorded video the traffic replays: four vehicles with ArUco roofs
(DICT_4X4_50) on a test track, seen from a drone through the configuration's
lens, rendered on the card.

A frozen copy of the measured package's ``render_scene`` (float64, its
25-step lens inversion, box filter of ``supersample``), split so that the
world grids are computed once and each frame only paints its vehicles.
Markers and LEDs follow the JAX package's bench scene: the host car (id 4)
carries the 8-LED panel.
"""

from __future__ import annotations

import numpy as np

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
ROOF_HALF = (1.1, 2.0)


def _dist12(dist) -> list[float]:
    d = np.zeros(14)
    d[: np.asarray(dist).size] = np.asarray(dist, np.float64).reshape(-1)
    return [float(v) for v in d[:12]]


def world_grids(mtx, dist, size_wh, altitude: float, device, supersample: int = 1):
    """World (x, y) in metres of every (supersampled) pixel on the ground plane."""
    import torch

    w, h = size_wh
    ss = supersample
    f64 = dict(dtype=torch.float64, device=device)
    mtx = np.asarray(mtx, np.float64)
    fx, fy, cx, cy = mtx[0, 0], mtx[1, 1], mtx[0, 2], mtx[1, 2]
    u = (torch.arange(w * ss, **f64) + 0.5) / ss - 0.5
    v = (torch.arange(h * ss, **f64) + 0.5) / ss - 0.5
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    xd, yd = (uu - cx) / fx, (vv - cy) / fy
    k1, k2, p1, p2, k3, k4, k5, k6, s1, s2, s3, s4 = _dist12(dist)
    x, y = xd.clone(), yd.clone()
    lim = float(2.0 * max(xd.abs().max().item(), yd.abs().max().item()) + 1.0)
    for _ in range(25):
        r2 = x * x + y * y
        r4 = r2 * r2
        r6 = r4 * r2
        icdist = (1 + k4 * r2 + k5 * r4 + k6 * r6) / (1 + k1 * r2 + k2 * r4 + k3 * r6)
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x) + s1 * r2 + s2 * r4
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y + s3 * r2 + s4 * r4
        x = torch.clamp((xd - dx) * icdist, -lim, lim)
        y = torch.clamp((yd - dy) * icdist, -lim, lim)
    return altitude * x, altitude * y


def paint(xw, yw, markers, size_wh, supersample: int = 1):
    """One (H, W, 3) u8 frame: asphalt, then each marker's roof, cells and LEDs.
    ``markers``: dicts with ``id``, ``xy`` (m), ``yaw_deg`` and optional ``leds``."""
    import torch

    from refplain.aruco.dictionary import marker_image

    w, h = size_wh
    img = torch.full(xw.shape, ASPHALT, dtype=torch.float64, device=xw.device)
    img += 8.0 * torch.sin(xw * 1.7) * torch.cos(yw * 2.3)
    half = MARKER_LEN / 2.0
    for spec in markers:
        mx0, my0 = spec["xy"]
        yaw = np.radians(spec["yaw_deg"])
        c, s = float(np.cos(yaw)), float(np.sin(yaw))
        lx = c * (xw - mx0) + s * (yw - my0)
        ly = -s * (xw - mx0) + c * (yw - my0)
        img = torch.where((lx.abs() <= ROOF_HALF[0]) & (ly.abs() <= ROOF_HALF[1]), torch.full_like(img, ROOF), img)
        inside = (lx.abs() <= half) & (ly.abs() <= half)
        gx = torch.clamp(torch.nan_to_num((lx + half) / MARKER_LEN * 6).to(torch.int64), 0, 5)
        gy = torch.clamp(torch.nan_to_num((ly + half) / MARKER_LEN * 6).to(torch.int64), 0, 5)
        pattern = torch.as_tensor(marker_image(spec["id"]), device=xw.device)
        vals = torch.where(pattern[gy, gx] > 127, torch.full_like(img, MARKER_WHITE),
                           torch.full_like(img, MARKER_BLACK))
        img = torch.where(inside, vals, img)
        leds = spec.get("leds")
        if leds is not None:
            for j, (ox, oy) in enumerate(LED_OFFSETS):
                on = (leds >> (7 - j)) & 1
                led = (lx - ox) ** 2 + (ly + oy) ** 2 <= 0.06 ** 2
                img = torch.where(led, torch.full_like(img, LED_ON if on else LED_OFF), img)
    ss = supersample
    img = img.reshape(h, ss, w, ss).mean(dim=(1, 3))
    img = torch.clamp(torch.round(img), 0, 255).to(torch.uint8)
    return img[..., None].expand(h, w, 3).contiguous()


def frame_markers(traffic: dict, i: int, offsets) -> list[dict]:
    """The markers of frame ``i``: each vehicle's yaw advances by its step a
    frame; ``offsets`` (per vehicle: yaw degrees, x m, y m) shift them all."""
    out = []
    for (dyaw, dx, dy), m in zip(offsets, traffic["markers"]):
        spec = {"id": m["id"], "xy": (m["xy"][0] + dx, m["xy"][1] + dy),
                "yaw_deg": m["yaw_deg"] + m["yaw_step_deg"] * i + dyaw}
        if "leds" in m:
            spec["leds"] = m["leds"]
        out.append(spec)
    return out


def seeded_offsets(traffic: dict, rng: np.random.Generator) -> list[tuple[float, float, float]]:
    """Per vehicle (yaw degrees, x m, y m), uniform within the traffic's jitter."""
    jy, jp = traffic["jitter_yaw_deg"], traffic["jitter_xy_m"]
    return [(float(rng.uniform(-jy, jy)), float(rng.uniform(-jp, jp)), float(rng.uniform(-jp, jp)))
            for _ in traffic["markers"]]


def render_video(camera: dict, size_wh, traffic: dict, rng: np.random.Generator, device) -> list[np.ndarray]:
    """The traffic's ``distinct_frames`` frames as (H, W, 3) u8 numpy on the
    host, as a decoded video holds them, scaled to ``scale_to`` levels so that
    the brightness shifts cannot wrap."""
    import torch

    xw, yw = world_grids(camera["mtx"], camera["dist"], size_wh, traffic["altitude_m"], device)
    offsets = seeded_offsets(traffic, rng)
    frames = []
    for i in range(traffic["distinct_frames"]):
        img = paint(xw, yw, frame_markers(traffic, i, offsets), size_wh)
        img = (img.to(torch.int32) * traffic["scale_to"] // 255).to(torch.uint8)
        frames.append(img.cpu().numpy())
    return frames
