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


def detectron2_checkpoint(seed: int, depth: int, num_classes: int, mask_on: bool = True) -> dict[str, np.ndarray]:
    """A detectron2 GeneralizedRCNN (Mask R-CNN R-FPN, the model zoo's widths:
    256 FPN channels, 3 anchors a cell, 7x7 box pooling, 1024-d box head)
    state dict of float32 numpy arrays, drawn with
    ``numpy.random.default_rng(seed)``.

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
    fpn_channels, fc_dim, num_anchors, box_res = 256, 1024, 3, 7

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

    bb = "backbone.bottom_up"
    out[f"{bb}.stem.conv1.weight"] = conv(64, 3, 7)
    bn(f"{bb}.stem.conv1.norm", 64, var_scale=64.0**2)
    in_ch = 64
    for stage, n_blocks in enumerate(STAGE_BLOCKS[depth]):
        out_ch, mid = 256 * 2**stage, 64 * 2**stage
        for b in range(n_blocks):
            p = f"{bb}.res{stage + 2}.{b}"
            cin = in_ch if b == 0 else out_ch
            for name, (o, i, k) in (("conv1", (mid, cin, 1)), ("conv2", (mid, mid, 3)), ("conv3", (out_ch, mid, 1))):
                out[f"{p}.{name}.weight"] = conv(o, i, k)
                bn(f"{p}.{name}.norm", o, scale=0.2 if name == "conv3" else 1.0)
            if b == 0:
                out[f"{p}.shortcut.weight"] = conv(out_ch, cin, 1, gain=1.0)
                bn(f"{p}.shortcut.norm", out_ch)
        in_ch = out_ch
    for i, c in enumerate((256, 512, 1024, 2048)):
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
        mh = "roi_heads.mask_head"
        for i in range(1, 5):
            out[f"{mh}.mask_fcn{i}.weight"] = conv(fpn_channels, fpn_channels, 3)
            out[f"{mh}.mask_fcn{i}.bias"] = np.zeros(fpn_channels, np.float32)
        out[f"{mh}.deconv.weight"] = normal((fpn_channels, fpn_channels, 2, 2), np.sqrt(2.0 / fpn_channels))
        out[f"{mh}.deconv.bias"] = np.zeros(fpn_channels, np.float32)
        out[f"{mh}.predictor.weight"] = centred((num_classes, fpn_channels), 1 / np.sqrt(fpn_channels))[..., None, None]
        out[f"{mh}.predictor.bias"] = np.full(num_classes, MASK_BIAS, np.float32)
    return out
