"""Synthetic UAV test-track scenes rendered through the real camera model.

Counterpart of the JAX reference's ``utils/synthetic.py`` on any device, so a
4K scene renders on the card in well under a second: ``render_scene`` in
float64, the bench renderer ``SceneRenderer`` in float32 as the reference's,
and the ground truth (``marker_world_corners``,
``project_world_to_undistorted``) in float64 numpy.  ArUco markers
(DICT_4X4_50) on vehicle roofs are seen from altitude through the inverse of
the 14-coefficient lens model, supersampled and box-filtered; the host car
carries the 8-LED panel.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os

import numpy as np
import torch

from apse_uav_torch.aruco.dictionary import marker_image
from apse_uav_torch.dcnn.models.resnet import STAGE_BLOCKS
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


def _dist12(dist) -> list[float]:
    """The first 12 of the 14 distortion coefficients, zero-padded, as floats."""
    d = np.zeros(14)
    d[: np.asarray(dist).size] = np.asarray(dist, np.float64).reshape(-1)
    return [float(v) for v in d[:12]]


def _undistort(xd: torch.Tensor, yd: torch.Tensor, dist, num_iters: int = 25):
    """Fixed-point lens inversion, bounded so far corners stay finite."""
    k1, k2, p1, p2, k3, k4, k5, k6, s1, s2, s3, s4 = _dist12(dist)
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


def _scene_grids(mtx, dist, w: int, h: int, ss: int, altitude: float, cam_yaw_deg: float, distorted: bool,
                 device: torch.device):
    """World-coordinate grids and the asphalt base of :class:`SceneRenderer`,
    float32 on ``device``: the reference's 25-step fixed point with its
    ``lim`` clamp, then the re-distortion test that blanks the lens'
    non-invertible zone to plain asphalt at world coordinates 1e9."""
    k1, k2, p1, p2, k3, k4, k5, k6, s1, s2, s3, s4 = _dist12(dist)
    fx, fy, cx, cy = float(mtx[0, 0]), float(mtx[1, 1]), float(mtx[0, 2]), float(mtx[1, 2])
    cy_r, sy_r = float(np.cos(np.radians(cam_yaw_deg))), float(np.sin(np.radians(cam_yaw_deg)))
    f32 = dict(dtype=torch.float32, device=device)
    u = (torch.arange(w * ss, **f32) + 0.5) / ss - 0.5
    v = (torch.arange(h * ss, **f32) + 0.5) / ss - 0.5
    xd = ((u[None, :] - cx) / fx).expand(h * ss, w * ss)
    yd = ((v[:, None] - cy) / fy).expand(h * ss, w * ss)
    if distorted:
        lim = 2.0 * torch.maximum(xd.abs().max(), yd.abs().max()) + 1.0
        x, y = xd, yd
        for _ in range(25):
            r2 = x * x + y * y
            r4 = r2 * r2
            r6 = r4 * r2
            icdist = (1 + k4 * r2 + k5 * r4 + k6 * r6) / (1 + k1 * r2 + k2 * r4 + k3 * r6)
            ddx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x) + s1 * r2 + s2 * r4
            ddy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y + s3 * r2 + s4 * r4
            x = torch.minimum(torch.maximum((xd - ddx) * icdist, -lim), lim)
            y = torch.minimum(torch.maximum((yd - ddy) * icdist, -lim), lim)
        r2 = x * x + y * y
        r4 = r2 * r2
        r6 = r4 * r2
        rad = (1 + k1 * r2 + k2 * r4 + k3 * r6) / (1 + k4 * r2 + k5 * r4 + k6 * r6)
        xd2 = x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x) + s1 * r2 + s2 * r4
        yd2 = y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y + s3 * r2 + s4 * r4
        valid = ((xd2 - xd).abs() < 1e-3) & ((yd2 - yd).abs() < 1e-3)
        del r2, r4, r6, rad, xd2, yd2
    else:
        x, y = xd, yd
        valid = torch.ones(xd.shape, dtype=torch.bool, device=device)
    xw = altitude * (cy_r * x - sy_r * y)
    yw = altitude * (sy_r * x + cy_r * y)
    base = ASPHALT + 8.0 * torch.sin(xw * 1.7) * torch.cos(yw * 2.3)
    sentinel = torch.full((), 1e9, **f32)
    return (torch.where(valid, xw, sentinel), torch.where(valid, yw, sentinel),
            torch.where(valid, base, torch.full((), ASPHALT, **f32)))


class SceneRenderer:
    """Multi-frame renderer for a fixed camera, the reference's bench renderer:
    the lens inversion and the asphalt base render once (float32 grids on
    ``device``), and each frame repaints only a fixed-size patch around each
    vehicle.

    It follows the reference's ``SceneRenderer``, not :func:`render_scene`:
    the grids are float32, and the lens' non-invertible zone (where the fixed
    point fails the re-distortion test) is plain asphalt, where
    ``render_scene`` keeps its clamped float64 fixed point.  A marker whose
    patch does not fit in the frame is skipped.  With ``cache`` the grids are
    kept in an ``.npz`` under ``~/.cache/apse_uav_torch``, keyed by camera
    and geometry.

    Example:
        r = SceneRenderer(mtx, dist, (3840, 2160), altitude=40.0, cache=False)
        frame = r.render([MarkerSpec(4, (0.5, -2.0), leds=0b10110010)])  # (2160, 3840, 3) u8 on cuda
    """

    BLOCK = 128

    def __init__(self, mtx, dist, size_wh: tuple[int, int], altitude: float = 40.0, cam_yaw_deg: float = 0.0,
                 supersample: int = 2, distorted: bool = True, cache: bool = True, device="cuda"):
        self.device = resolve_device(device)
        w, h = size_wh
        self.size_wh = size_wh
        self.ss = supersample
        self.altitude = altitude
        mtx = np.asarray(mtx, np.float64)
        dist = np.asarray(dist, np.float64)
        cache_path = None
        if cache:
            geometry = f"{size_wh}-{altitude}-{cam_yaw_deg}-{supersample}-{distorted}-v2"
            key = hashlib.sha256(mtx.tobytes() + dist.tobytes() + geometry.encode()).hexdigest()[:16]
            cache_path = os.path.join(os.path.expanduser("~"), ".cache", "apse_uav_torch", f"scene_{key}.npz")
            if os.path.exists(cache_path):
                z = np.load(cache_path)
                self.xw, self.yw, self.base = (torch.from_numpy(z[k]).to(self.device) for k in ("xw", "yw", "base"))
                self._finish_init()
                return
        self.xw, self.yw, self.base = _scene_grids(mtx, dist, w, h, supersample, float(altitude), float(cam_yaw_deg),
                                                   bool(distorted), self.device)
        if cache_path is not None:
            os.makedirs(os.path.dirname(cache_path), exist_ok=True)
            np.savez(cache_path + ".tmp.npz", **{k: getattr(self, k).cpu().numpy() for k in ("xw", "yw", "base")})
            os.replace(cache_path + ".tmp.npz", cache_path)
        self._finish_init()

    def _finish_init(self) -> None:
        # Per-block world extents (the 1e9 sentinel excluded), kept on the host:
        # a vehicle's pixel slice is then a scan over ~2k blocks.
        b = self.BLOCK
        gh, gw = self.xw.shape
        ph, pw = -gh % b, -gw % b

        def red(a, fn, fill):
            a = torch.where(a.abs() < 1e8, a, torch.full((), fill, dtype=a.dtype, device=a.device))
            a = torch.nn.functional.pad(a, (0, pw, 0, ph), value=fill)
            return fn(a.reshape((gh + ph) // b, b, (gw + pw) // b, b), dim=(1, 3)).cpu().numpy()

        inf = float("inf")
        self._bx_min, self._bx_max = red(self.xw, torch.amin, inf), red(self.xw, torch.amax, -inf)
        self._by_min, self._by_max = red(self.yw, torch.amin, inf), red(self.yw, torch.amax, -inf)
        # Fixed patch side: the largest vehicle footprint at this scale, measured
        # at the image centre (distortion compresses the corners).
        ch, cw = gh // 2, gw // 2
        px_per_m = 1.0 / max(abs(float(self.xw[ch, cw + 1] - self.xw[ch, cw])), 1e-9)
        self._PS = min(int(-(-int(2 * 3.8 * px_per_m + 2 * b) // b) * b), (gh // b) * b, (gw // b) * b)
        self._led_xy = torch.tensor(LED_OFFSETS, dtype=torch.float32, device=self.device)

    def _world_bbox_slice(self, spec: MarkerSpec, margin: float = 1.0):
        """Supersampled-pixel slice covering the vehicle's world extent, or None."""
        rw_, rl = spec.roof_halfsize
        r = float(np.hypot(rw_, rl)) + margin
        mx0, my0 = spec.center_xy
        hit = ((self._bx_min <= mx0 + r) & (self._bx_max >= mx0 - r)
               & (self._by_min <= my0 + r) & (self._by_max >= my0 - r))
        ys, xs = np.nonzero(hit.any(axis=1))[0], np.nonzero(hit.any(axis=0))[0]
        if len(ys) == 0 or len(xs) == 0:
            return None
        b = self.BLOCK
        gh, gw = self.xw.shape
        return slice(ys[0] * b, min((ys[-1] + 1) * b, gh)), slice(xs[0] * b, min((xs[-1] + 1) * b, gw))

    def _paint_patch(self, img_p, xw_p, yw_p, spec: MarkerSpec):
        """The reference's float32 patch painter: roof, marker cells, LEDs
        (a slot with a negative value is off)."""
        f32 = lambda v: float(np.float32(v))  # noqa: E731  the reference passes float32 scalars
        yaw = np.radians(spec.yaw_deg)
        cx_, cy_ = f32(spec.center_xy[0]), f32(spec.center_xy[1])
        cos_, sin_ = f32(np.cos(yaw)), f32(np.sin(yaw))
        lx = cos_ * (xw_p - cx_) + sin_ * (yw_p - cy_)
        ly = -sin_ * (xw_p - cx_) + cos_ * (yw_p - cy_)
        full = lambda v: torch.full((), v, dtype=torch.float32, device=img_p.device)  # noqa: E731
        out = torch.where((lx.abs() <= f32(spec.roof_halfsize[0])) & (ly.abs() <= f32(spec.roof_halfsize[1])),
                          full(ROOF), img_p)
        half = MARKER_LEN / 2.0
        inside = (lx.abs() <= half) & (ly.abs() <= half)
        gx = torch.clamp(((lx + half) / MARKER_LEN * 6).to(torch.int32), 0, 5).long()
        gy = torch.clamp(((ly + half) / MARKER_LEN * 6).to(torch.int32), 0, 5).long()
        pattern = torch.as_tensor(marker_image(spec.marker_id), device=img_p.device)
        out = torch.where(inside, torch.where(pattern[gy, gx] > 127, full(MARKER_WHITE), full(MARKER_BLACK)), out)
        if spec.leds is not None:
            for j in range(8):
                d2 = (lx - self._led_xy[j, 0]) ** 2 + (ly + self._led_xy[j, 1]) ** 2
                on = (spec.leds >> (7 - j)) & 1
                out = torch.where(d2 <= 0.06**2, full(LED_ON if on else LED_OFF), out)
        return out

    def render(self, markers: list[MarkerSpec]) -> torch.Tensor:
        """One frame: (H, W, 3) uint8 on the renderer's device."""
        img = self.base.clone()
        gh, gw = img.shape
        ps = self._PS
        for spec in markers:
            sl = self._world_bbox_slice(spec)
            if sl is None:
                continue
            y0 = min(sl[0].start, max(gh - ps, 0))
            x0 = min(sl[1].start, max(gw - ps, 0))
            if (min(ps, gh - y0), min(ps, gw - x0)) != (ps, ps):
                continue  # degenerate geometry (the frame is smaller than a patch)
            sy, sx = slice(y0, y0 + ps), slice(x0, x0 + ps)
            img[sy, sx] = self._paint_patch(img[sy, sx], self.xw[sy, sx], self.yw[sy, sx], spec)
        w, h = self.size_wh
        out = img.reshape(h, self.ss, w, self.ss).mean(dim=(1, 3))
        out = torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
        return out[..., None].expand(h, w, 3).contiguous()


def marker_world_corners(spec: MarkerSpec) -> np.ndarray:
    """World coordinates (4, 2) float64 of the marker's corners in OpenCV's
    detection order (top-left, top-right, bottom-right, bottom-left of the
    canonical marker, whose top row lies at negative marker-frame y)."""
    halfm = MARKER_LEN / 2.0
    local = np.array([[-halfm, -halfm], [halfm, -halfm], [halfm, halfm], [-halfm, halfm]])
    yaw = np.radians(spec.yaw_deg)
    c, s = np.cos(yaw), np.sin(yaw)
    return local @ np.array([[c, -s], [s, c]]).T + np.asarray(spec.center_xy)


def project_world_to_undistorted(pts_xy: np.ndarray, mtx, altitude: float, cam_yaw_deg: float = 0.0) -> np.ndarray:
    """Ground-truth pixel positions (N, 2) float64 of world points (N, 2) in
    the undistorted image of the nadir camera at ``altitude``."""
    mtx = np.asarray(mtx, np.float64)
    cy_r, sy_r = np.cos(np.radians(cam_yaw_deg)), np.sin(np.radians(cam_yaw_deg))
    x_c = cy_r * pts_xy[:, 0] + sy_r * pts_xy[:, 1]
    y_c = -sy_r * pts_xy[:, 0] + cy_r * pts_xy[:, 1]
    return np.stack([x_c / altitude * mtx[0, 0] + mtx[0, 2], y_c / altitude * mtx[1, 1] + mtx[1, 2]], axis=-1)


def _spiral(win: int) -> np.ndarray:
    """A one-cell-wide square spiral with one-cell gaps, walked inward from (0, 0)."""
    m = np.zeros((win, win), bool)
    y = x = d = 0
    steps = ((0, 1), (1, 0), (0, -1), (-1, 0))
    m[0, 0] = True

    def free(yy, xx):
        return 0 <= yy < win and 0 <= xx < win and not m[yy, xx]

    def can(d):
        dy, dx = steps[d]
        ahead = (y + 2 * dy, x + 2 * dx)
        return free(y + dy, x + dx) and (not (0 <= ahead[0] < win and 0 <= ahead[1] < win) or not m[ahead])

    while can(d) or can((d + 1) % 4):
        if not can(d):
            d = (d + 1) % 4
        y, x = y + steps[d][0], x + steps[d][1]
        m[y, x] = True
    return m


def labeling_masks(win: int) -> dict[str, np.ndarray]:
    """Hard (win, win) masks for the component-labeling schedule of
    ``detector._label_sweeps``: a serpentine along rows and one along columns
    and a square spiral (each one 4-connected component that the fixed
    schedule leaves split into many labels), full-dark rows and columns, a
    checkerboard, isolated cells, an all-dark and an empty window."""
    yy, xx = np.mgrid[:win, :win]
    snake = yy % 2 == 0
    snake |= (yy % 4 == 1) & (xx == win - 1)
    snake |= (yy % 4 == 3) & (xx == 0)
    return {
        "serpentine_rows": snake,
        "serpentine_cols": snake.T.copy(),
        "spiral": _spiral(win),
        "dark_rows": (yy % 4 == 0) | ((xx == 5) & (yy < win // 2)),
        "dark_cols": (xx % 5 == 1) | ((yy == 3) & (xx > win // 3)),
        "checkerboard": (yy + xx) % 2 == 0,
        "isolated": (yy % 3 == 0) & (xx % 3 == 0),
        "all_dark": np.ones((win, win), bool),
        "empty": np.zeros((win, win), bool),
    }


# Background logit bias of the synthetic class head: only the tail of the
# proposals scores above 0.5, so the detections are few and their scores far
# apart.  Mask logit bias: masks are on over nearly the whole box, so no mask
# cell sits at the 0.5 threshold.
CLS_BG_BIAS = 4.0
MASK_BIAS = 5.0


def detectron2_checkpoint(seed: int, depth: int, num_classes: int, mask_on: bool = True,
                          architecture: str = "fpn") -> dict[str, np.ndarray]:
    """A detectron2 GeneralizedRCNN (Mask R-CNN R-FPN, the model zoo's widths:
    256 FPN channels, 3 anchors a cell, 7x7 box pooling, 1024-d box head; or,
    with ``architecture="c4"``, R-C4: the trunk to res4, a 1024-channel RPN
    with 15 anchors a cell, res5 in the ROI heads, the predictor on 2048
    channels and a mask head of one transposed convolution) state dict of
    float32 numpy arrays, drawn with ``numpy.random.default_rng(seed)``.

    Its statistics keep a deep trunk finite and O(1) and its outputs decisive,
    so that two implementations agree on every discrete choice:

    * He-normal convolutions; the stem's frozen-BN variance divides out the
      raw pixel scale (normalised pixels are O(100));
    * frozen BN with random statistics (scale ~1, bias, mean, variance), and
      scale 0.2 on each block's last BN so residual sums grow slowly;
    * objectness and class logits spread to a standard deviation of ~2-4
      (detectron2's own 0.01 / 0.001 initialisations leave every class score
      near 1 / (K + 1), where top-k and NMS order would follow f32 rounding
      noise), class and mask rows of zero mean, a background bias
      (``CLS_BG_BIAS``) that keeps the detections few and apart, a mask bias
      (``MASK_BIAS``) that keeps mask cells away from 0.5; small box deltas,
      so boxes move little with rounding.
    """
    rng = np.random.default_rng(seed)
    c4 = architecture == "c4"
    fpn_channels, fc_dim, num_anchors, box_res = (1024, 2048, 15, 14) if c4 else (256, 1024, 3, 7)

    def normal(shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    def centred(shape, std):
        """Rows of zero mean: the post-ReLU features' common positive mean
        then adds no shared offset to every logit."""
        w = normal(shape, std)
        return w - w.mean(axis=1, keepdims=True)

    def conv(out_ch, in_ch, k, gain=2.0):
        return normal((out_ch, in_ch, k, k), np.sqrt(gain / (in_ch * k * k)))

    out: dict[str, np.ndarray] = {}

    def bn(prefix, ch, scale=1.0, var_scale=1.0):
        out[f"{prefix}.weight"] = (scale * (1.0 + 0.1 * rng.standard_normal(ch))).astype(np.float32)
        out[f"{prefix}.bias"] = normal(ch, 0.1)
        out[f"{prefix}.running_mean"] = normal(ch, 0.1 * np.sqrt(var_scale))
        out[f"{prefix}.running_var"] = (var_scale * rng.uniform(0.5, 1.5, ch)).astype(np.float32)

    bb = "backbone" if c4 else "backbone.bottom_up"
    out[f"{bb}.stem.conv1.weight"] = conv(64, 3, 7)
    bn(f"{bb}.stem.conv1.norm", 64, var_scale=64.0**2)
    in_ch = 64
    for stage, n_blocks in enumerate(STAGE_BLOCKS[depth]):
        out_ch, mid = 256 * 2**stage, 64 * 2**stage
        owner = "roi_heads" if c4 and stage == 3 else bb  # C4: res5 is the ROI heads' transform
        for b in range(n_blocks):
            p = f"{owner}.res{stage + 2}.{b}"
            cin = in_ch if b == 0 else out_ch
            for name, (o, i, k) in (("conv1", (mid, cin, 1)), ("conv2", (mid, mid, 3)), ("conv3", (out_ch, mid, 1))):
                out[f"{p}.{name}.weight"] = conv(o, i, k)
                bn(f"{p}.{name}.norm", o, scale=0.2 if name == "conv3" else 1.0)
            if b == 0:
                out[f"{p}.shortcut.weight"] = conv(out_ch, cin, 1, gain=1.0)
                bn(f"{p}.shortcut.norm", out_ch)
        in_ch = out_ch
    for i, c in enumerate(() if c4 else (256, 512, 1024, 2048)):
        out[f"backbone.fpn_lateral{i + 2}.weight"] = conv(fpn_channels, c, 1, gain=1.0)
        out[f"backbone.fpn_lateral{i + 2}.bias"] = normal(fpn_channels, 0.1)
        out[f"backbone.fpn_output{i + 2}.weight"] = conv(fpn_channels, fpn_channels, 3, gain=0.25)
        out[f"backbone.fpn_output{i + 2}.bias"] = normal(fpn_channels, 0.1)
    rpn = "proposal_generator.rpn_head"
    out[f"{rpn}.conv.weight"] = conv(fpn_channels, fpn_channels, 3)
    out[f"{rpn}.conv.bias"] = np.zeros(fpn_channels, np.float32)
    out[f"{rpn}.objectness_logits.weight"] = normal((num_anchors, fpn_channels, 1, 1), 3.0 / np.sqrt(fpn_channels))
    out[f"{rpn}.objectness_logits.bias"] = np.zeros(num_anchors, np.float32)
    out[f"{rpn}.anchor_deltas.weight"] = normal((4 * num_anchors, fpn_channels, 1, 1), 0.02 / np.sqrt(fpn_channels))
    out[f"{rpn}.anchor_deltas.bias"] = np.zeros(4 * num_anchors, np.float32)
    if not c4:  # C4's predictor reads the 7x7 mean of res5: no FC trunk
        in_dim = fpn_channels * box_res * box_res
        out["roi_heads.box_head.fc1.weight"] = normal((fc_dim, in_dim), np.sqrt(2.0 / in_dim))
        out["roi_heads.box_head.fc1.bias"] = np.zeros(fc_dim, np.float32)
        out["roi_heads.box_head.fc2.weight"] = normal((fc_dim, fc_dim), np.sqrt(2.0 / fc_dim))
        out["roi_heads.box_head.fc2.bias"] = np.zeros(fc_dim, np.float32)
    out["roi_heads.box_predictor.cls_score.weight"] = centred((num_classes + 1, fc_dim), 2.0 / np.sqrt(fc_dim))
    out["roi_heads.box_predictor.cls_score.bias"] = np.asarray([0.0] * num_classes + [CLS_BG_BIAS], np.float32)
    out["roi_heads.box_predictor.bbox_pred.weight"] = normal((4 * num_classes, fc_dim), 0.1 / np.sqrt(fc_dim))
    out["roi_heads.box_predictor.bbox_pred.bias"] = np.zeros(4 * num_classes, np.float32)
    if mask_on:
        mh, dim = "roi_heads.mask_head", 256
        mask_in = 2048 if c4 else dim
        for i in range(1, 1 if c4 else 5):
            out[f"{mh}.mask_fcn{i}.weight"] = conv(dim, dim, 3)
            out[f"{mh}.mask_fcn{i}.bias"] = np.zeros(dim, np.float32)
        out[f"{mh}.deconv.weight"] = normal((mask_in, dim, 2, 2), np.sqrt(2.0 / mask_in))
        out[f"{mh}.deconv.bias"] = np.zeros(dim, np.float32)
        out[f"{mh}.predictor.weight"] = centred((num_classes, dim), 1 / np.sqrt(dim))[..., None, None]
        out[f"{mh}.predictor.bias"] = np.full(num_classes, MASK_BIAS, np.float32)
    return out


# -- tracking sequences for association-head training ---------------------------


def tracking_sequence(n_frames: int, hw: tuple[int, int], n_objects: int, seed: int = 0):
    """Seeded textured objects moving over textured asphalt with fixed ids.

    Each object keeps its own horizontal lane (so masks never overlap), size
    and stripe texture, and moves at a constant velocity; colours come from
    two families shared across ids, and each frame changes every object's
    brightness and noise, so that identities are not separable at the start
    of training.  Returns
    (frames (T, H, W, 3) uint8 RGB, objects: per frame a list of
    (track_id, class_id (1 car / 2 pedestrian), mask (H, W) uint8 0/1,
    box [x, y, w, h])).
    """
    rng = np.random.default_rng(seed)
    h, w = hw
    lane = h // n_objects
    yy, xx = np.mgrid[0:h, 0:w]
    base = (ASPHALT + 10 * np.sin(xx / 9.0) * np.cos(yy / 7.0))[..., None] + rng.normal(0, 4, (h, w, 1))
    specs = []
    for k in range(n_objects):
        oh = int(rng.integers(lane // 2, max(lane - 4, lane // 2 + 1)))
        ow = int(rng.integers(w // 12, w // 5))
        specs.append({"id": k + 1, "class": 1 + k % 2, "y": k * lane + (lane - oh) // 2, "h": oh, "w": ow,
                      "x0": float(rng.uniform(0, w - ow)), "vx": float(rng.uniform(-0.02, 0.02) * w),
                      "colour": np.array([[180.0, 90.0, 70.0], [70.0, 110.0, 190.0]])[k % 2],
                      "period": float(rng.uniform(3, 9))})
    frames, objects = [], []
    for t in range(n_frames):
        img = np.repeat(base, 3, axis=2) + rng.normal(0, 3, (h, w, 3))
        objs = []
        for s in specs:
            x = int(np.clip(s["x0"] + s["vx"] * t, 0, w - s["w"]))
            y = s["y"]
            stripes = 0.75 + 0.25 * np.sin(np.arange(s["w"]) / s["period"])[None, :, None]
            img[y:y + s["h"], x:x + s["w"]] = (s["colour"] * stripes * rng.uniform(0.7, 1.3)
                                               + rng.normal(0, 20, (s["h"], s["w"], 3)))
            mask = np.zeros((h, w), np.uint8)
            mask[y:y + s["h"], x:x + s["w"]] = 1
            objs.append((s["id"], s["class"], mask, [x, y, s["w"], s["h"]]))
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
        objects.append(objs)
    return np.stack(frames), objects


def write_mots_sequence(instances_dir: str, images_dir: str, seq: str, frames: np.ndarray, objects) -> None:
    """KITTI-MOTS layout: ``images_dir/seq/%06d.png`` and the RLE instances
    file ``instances_dir/seq.txt`` (frame, id = class * 1000 + track, class,
    h, w, RLE); needs PIL."""
    from PIL import Image

    from apse_uav_torch.evaluation import rle

    os.makedirs(os.path.join(images_dir, seq), exist_ok=True)
    os.makedirs(instances_dir, exist_ok=True)
    with open(os.path.join(instances_dir, seq + ".txt"), "w") as f:
        for t, (frame, objs) in enumerate(zip(frames, objects)):
            Image.fromarray(frame).save(os.path.join(images_dir, seq, f"{t:06d}.png"))
            for track_id, class_id, mask, _ in objs:
                r = rle.encode(mask)
                f.write(f"{t} {class_id * 1000 + track_id} {class_id} {r['size'][0]} {r['size'][1]} "
                        f"{r['counts'].decode()}\n")


def write_mot_sequence(seq_dir: str, frames: np.ndarray, objects) -> None:
    """MOT17 layout: ``img1/%06d.jpg`` (frames from 1), ``gt/gt.txt`` rows
    ``frame,id,x,y,w,h,1,class,1`` and ``seqinfo.ini``; needs PIL."""
    from PIL import Image

    os.makedirs(os.path.join(seq_dir, "img1"), exist_ok=True)
    os.makedirs(os.path.join(seq_dir, "gt"), exist_ok=True)
    rows = []
    for t, (frame, objs) in enumerate(zip(frames, objects), start=1):
        Image.fromarray(frame).save(os.path.join(seq_dir, "img1", f"{t:06d}.jpg"), quality=95)
        rows += [f"{t},{track_id},{x},{y},{w},{h},1,{class_id},1" for track_id, class_id, _, (x, y, w, h) in objs]
    with open(os.path.join(seq_dir, "gt", "gt.txt"), "w") as f:
        f.write("\n".join(rows) + "\n")
    h, w = frames.shape[1:3]
    with open(os.path.join(seq_dir, "seqinfo.ini"), "w") as f:
        f.write(f"[Sequence]\nname={os.path.basename(seq_dir)}\nimDir=img1\nframeRate=10\nseqLength={len(frames)}\n"
                f"imWidth={w}\nimHeight={h}\nimExt=.jpg\n")


# -- the learning regression's scenes ------------------------------------------


def learning_config():
    """The reference's learning-regression model (its
    ``tests/test_learning_regression.py``): Mask R-CNN R50-FPN, 2 classes, no
    mask head, unit-scale input normalisation (mean 128, std 64: a random
    frozen backbone keeps the input's scale), RPN 128 -> 64 proposals, 64
    anchors and 32 ROIs sampled an image, 16 detections above 0.3."""
    from apse_uav_torch.dcnn.config import mask_rcnn_r50_fpn

    cfg = mask_rcnn_r50_fpn(num_classes=2)
    return dataclasses.replace(
        cfg, input=dataclasses.replace(cfg.input, pixel_mean=(128.0, 128.0, 128.0), pixel_std=(64.0, 64.0, 64.0)),
        mask_on=False,
        rpn=dataclasses.replace(cfg.rpn, pre_nms_topk_test=128, post_nms_topk_test=64, pre_nms_topk_train=128,
                                post_nms_topk_train=64, batch_size_per_image=64),
        roi=dataclasses.replace(cfg.roi, num_classes=2, detections_per_image=16, batch_size_per_image=32,
                                score_thresh_test=0.3))


def learning_scenes(b: int = 2, hw: tuple[int, int] = (96, 96), seed: int = 0):
    """The learning regression's endless batches (images (B, H, W, 3) f32,
    gt boxes / classes / valid): 1-2 objects an image on textured mid-grey,
    class 0 a bright square, class 1 a dark ring, 28-38 px (on the 32 px
    anchor scale); the same numpy draws as the reference's generator."""
    rng = np.random.default_rng(seed)
    h, w = hw
    g = 4  # GT capacity
    yy, xx = np.mgrid[0:h, 0:w]
    while True:
        images = (128 + 14 * (np.sin(xx / 7.0) * np.cos(yy / 5.0))[None, :, :, None]
                  + rng.normal(0, 6, (b, h, w, 1))).astype(np.float32)
        images = np.repeat(images, 3, axis=-1)
        gt = {"boxes": np.zeros((b, g, 4), np.float32), "classes": np.zeros((b, g), np.int32),
              "valid": np.zeros((b, g), bool)}
        for i in range(b):
            for j in range(int(rng.integers(1, 3))):
                s = int(rng.integers(28, 39))
                x = int(rng.integers(2, w - s - 2))
                y = int(rng.integers(2, h - s - 2))
                cls = int(rng.integers(0, 2))
                if cls == 0:
                    images[i, y:y + s, x:x + s] = 245.0
                else:
                    images[i, y:y + s, x:x + s] = 25.0
                    images[i, y + s // 4:y + s - s // 4, x + s // 4:x + s - s // 4] = 128.0
                gt["boxes"][i, j] = [x, y, x + s, y + s]
                gt["classes"][i, j] = cls
                gt["valid"][i, j] = True
        yield images, gt


# -- detector fine-tuning scenes ------------------------------------------------


def detection_scenes(b: int = 4, hw: tuple[int, int] = (768, 1344), seed: int = 0):
    """Endless seeded fine-tuning batches at the loader's padded train size:
    (images (B, H, W, 3) float32 BGR on the 0-255 scale, gt from
    ``data.loader.pad_gt`` at the loader's capacity: boxes (B, 128, 4),
    classes, valid).

    Textured asphalt with 6-12 vehicles an image drawn as striped boxes,
    their sides on the RPN's anchor scales (32-256 px, aspect 0.5-2), the
    class (of the 4 UAV classes) setting the colour, so that the heads have
    something to learn."""
    from apse_uav_torch.data.loader import pad_gt

    rng = np.random.default_rng(seed)
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = ASPHALT + 12 * np.sin(xx / 11.0) * np.cos(yy / 9.0)
    palette = np.array([[60, 60, 200], [200, 200, 60], [60, 200, 60], [220, 120, 220]], np.float32)
    while True:
        images = np.repeat((base[None] + rng.normal(0, 5, (b, h, w)).astype(np.float32))[..., None], 3, axis=3)
        gts = []
        for i in range(b):
            anns = []
            for _ in range(int(rng.integers(6, 13))):
                side = float(np.exp(rng.uniform(np.log(32), np.log(256))))
                aspect = float(np.exp(rng.uniform(np.log(0.5), np.log(2.0))))
                bw, bh = int(side / np.sqrt(aspect)), int(side * np.sqrt(aspect))
                bw, bh = min(bw, w - 2), min(bh, h - 2)
                x, y = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
                cls = int(rng.integers(4))
                stripes = 0.8 + 0.2 * np.sin(np.arange(bw, dtype=np.float32) / rng.uniform(2, 6))
                images[i, y:y + bh, x:x + bw] = (palette[cls] * rng.uniform(0.8, 1.2))[None, None] * \
                    stripes[None, :, None]
                anns.append({"bbox": [x, y, bw, bh], "category_id": cls})
            gts.append(pad_gt(anns, 128, (1.0, 1.0), None))
        yield np.clip(images, 0, 255), {k: np.stack([g[k] for g in gts]) for k in gts[0]}


def _scene_images(n: int, hw: tuple[int, int], seed: int):
    """n seeded :func:`detection_scenes` images as uint8 with their objects
    [(x, y, w, h, class)] (the classes of the 4 UAV classes)."""
    scenes = detection_scenes(1, hw, seed)
    out = []
    for _ in range(n):
        images, gt = next(scenes)
        objs = [(*[int(v) for v in (b[0], b[1], b[2] - b[0], b[3] - b[1])], int(c))
                for b, c, ok in zip(gt["boxes"][0], gt["classes"][0], gt["valid"][0]) if ok]
        out.append((np.round(images[0]).astype(np.uint8), objs))
    return out


def write_coco_dataset(root: str, n_images: int, hw: tuple[int, int], seed: int = 0) -> tuple[str, str]:
    """Seeded scenes as a COCO-format dataset under ``root``: PNG images in
    ``images/`` and ``annotations.json`` whose objects (4 categories) carry
    box-filled RLE segmentations.  Returns (json path, image directory)."""
    import json

    from PIL import Image

    from apse_uav_torch.evaluation import rle

    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    images, anns = [], []
    for i, (img, objs) in enumerate(_scene_images(n_images, hw, seed)):
        name = f"{i:06d}.png"
        Image.fromarray(img).save(os.path.join(img_dir, name))
        images.append({"id": i, "file_name": name, "height": hw[0], "width": hw[1]})
        for x, y, w, h, c in objs:
            mask = np.zeros(hw, np.uint8)
            mask[y:y + h, x:x + w] = 1
            seg = rle.encode(mask)
            anns.append({"id": len(anns), "image_id": i, "category_id": c, "bbox": [x, y, w, h], "iscrowd": 0,
                         "area": w * h, "segmentation": {"size": seg["size"], "counts": seg["counts"].decode()}})
    path = os.path.join(root, "annotations.json")
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": i, "name": n} for i, n in enumerate(("car", "truck", "bus", "person"))]}, f)
    return path, img_dir


def write_uavdt_dataset(root: str, n_seqs: int, n_frames: int, hw: tuple[int, int], seed: int = 0) -> str:
    """Seeded scenes in UAVDT's layout under ``root``: ``M01{k:02d}/img{t:06d}.jpg``
    frames and ``M01{k:02d}_gt_whole.txt`` rows (frame, target id, x, y, w,
    h, out of view, occlusion, category 1-3).  Returns ``root``."""
    from PIL import Image

    for k in range(n_seqs):
        seq = f"M01{k + 1:02d}"
        os.makedirs(os.path.join(root, seq), exist_ok=True)
        rows = []
        for t, (img, objs) in enumerate(_scene_images(n_frames, hw, seed + 1000 * k), start=1):
            Image.fromarray(img).save(os.path.join(root, seq, f"img{t:06d}.jpg"), quality=95)
            rows += [f"{t},{j + 1},{x},{y},{w},{h},0,0,{c % 3 + 1}" for j, (x, y, w, h, c) in enumerate(objs)]
        with open(os.path.join(root, f"{seq}_gt_whole.txt"), "w") as f:
            f.write("\n".join(rows) + "\n")
    return root
