"""End-to-end ArUco measurement pipeline: batched front + temporal scan.

Counterpart of the JAX reference's ``aruco/pipeline.py``:

* **front** (batched over frames).  Two-pass (the shipped configuration):
  4x4 pool of the source (K5), kernel K3 on the pooled camera, proposals
  (K2), candidate-driven tile selection, K4 on the selected full-resolution
  tiles, the candidate stage (with K1).  Single-pass (``two_pass=False``):
  K3 over the whole full-resolution frame, then :class:`ArucoDetector`
  (pool, K2, the candidate stage with K1).  Then per-id slots and
  unit-length planar pose for both ambiguity basins.  On the CPU the plain
  versions run and the full-resolution gray covers the whole frame, as the
  reference's CPU path does.
* **scan**: the reference's per-frame state machine (DIFF_MAX gating,
  marker-size rings, altitude fallback, LEDs, distances) as a Python loop
  over frames with the same carry semantics.

Vehicle slots are fixed: slot v in 0..3 is marker id v + 1; the host car is
id 4 (slot 3).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from apse_uav_torch.aruco import detector as det, geometry as geo, patch_select
from apse_uav_torch.aruco.detector import DetectorParams
from apse_uav_torch.aruco.pose import estimate_pose_single_markers_two
from apse_uav_torch.core import camera, rotation
from apse_uav_torch.device import resolve_device
from apse_uav_torch.preproc import cuda_pool, cuda_remap, remap, twopass


@dataclasses.dataclass(frozen=True)
class ArucoPipelineConfig:
    """User flags mirroring the reference constants (aruco_detect.py:13-87)."""

    n_avg: int = 1
    step_frame: int = 1
    use_centroid_data: bool = False
    source_lidar: bool = False
    leds_threshold: float | None = None
    led_bias_px: tuple[float, float] = (0.0, 0.0)
    two_pass: bool = True
    sel_tile_budget: int = 256

    @property
    def diff_max(self) -> float:
        return 2.0 / 3.0 * self.step_frame * 2.0


def init_carry(cfg: ArucoPipelineConfig, device="cuda") -> dict[str, torch.Tensor]:
    """The temporal state (the reference's cross-frame globals)."""
    dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "detected_prev": torch.zeros(4, dtype=torch.int32, device=dev),
        "cx_prev": torch.zeros(4, **f32),
        "cy_prev": torch.zeros(4, **f32),
        "msp_rings": torch.zeros((4, cfg.n_avg), **f32),
        "marker_length": torch.tensor(geo.MARKER_LENGTH_ORG, **f32),
        "altitude_real": torch.tensor(0.0, **f32),
        "leds": torch.tensor(0, dtype=torch.int32, device=dev),
        "msp_avg": torch.ones(4, **f32),
        "size_corr": torch.ones(4, **f32),
        "lidar_xy": torch.zeros(2, **f32),
        "dist_aruco": torch.zeros(3, **f32),
        "dist_aruco_bbox": torch.zeros(3, **f32),
        "dist_dcnn": torch.zeros(3, **f32),
        "dist_dcnn_bbox": torch.zeros(3, **f32),
    }


def _slot_by_id(ids: torch.Tensor, corners: torch.Tensor):
    """Fixed per-id slots: ids (B, K), corners (B, K, 4, 2) -> present (B, 4),
    corners (B, 4, 4, 2); several decodes of one id keep the largest quad
    (first on ties)."""
    side = torch.linalg.vector_norm(corners - torch.roll(corners, 1, dims=2), dim=-1).sum(-1)  # (B, K)
    vid = torch.arange(1, 5, device=ids.device)
    mask = ids[:, None, :] == vid[None, :, None]  # (B, 4, K)
    present = mask.any(dim=2)
    idx = torch.argmax(torch.where(mask, side[:, None, :], torch.full_like(side[:, None, :], -1.0)), dim=2)
    slot = torch.gather(corners, 1, idx[..., None, None].expand(-1, -1, 4, 2))
    return present, slot


def _led_value(gray: torch.Tensor, rvec, tvec, size_corr, altitude_real, mtx, dist, threshold, bias_xy, tilt):
    """detectAndDrawLEDs: 8 LED windows (5x5 means) -> 8-bit value.
    Python slicing semantics: gray[y-2:y+3, x-2:x+3] is empty when y < 2 or
    x < 2; rows/cols beyond the image are clipped; sum / 25 either way."""
    pts = geo.project_int(geo.const(geo.LED_POINTS, gray.device), rvec, tvec / size_corr, mtx, dist,
                          bias_xy=bias_xy, tilt=tilt)  # (8, 2) x, y
    if threshold is None:
        thr = torch.clamp(190.0 + torch.trunc(altitude_real), min=240.0)
    else:
        thr = torch.tensor(float(threshold), dtype=torch.float32, device=gray.device)
    h, w = gray.shape
    x = pts[:, 0].to(torch.int64)
    y = pts[:, 1].to(torch.int64)
    d = torch.arange(5, device=gray.device)
    ys = y[:, None] - 2 + d
    xs = x[:, None] - 2 + d
    vy = (ys >= 0) & (ys < h)
    vx = (xs >= 0) & (xs < w)
    vals = gray[ys.clamp(0, h - 1)[:, :, None], xs.clamp(0, w - 1)[:, None, :]].to(torch.float32)
    vals = vals * vy[:, :, None] * vx[:, None, :]
    empty = (y < 2) | (x < 2)
    mean = torch.where(empty, torch.zeros_like(vals[:, 0, 0]), vals.sum(dim=(1, 2)) / 25.0)
    bits = (mean > thr).to(torch.int32)
    weights = 2 ** torch.arange(7, -1, -1, device=gray.device, dtype=torch.int32)
    return (bits * weights).sum().to(torch.int32)


class ArucoPipeline:
    """Batched ArUco measurement pipeline on one device.

    Usage:
        pipe = ArucoPipeline(mtx, dist, (3840, 2160), cfg, device="cuda")
        carry = init_carry(cfg, device="cuda")
        carry, out = pipe.process(frames_u8_planar, carry, first=True)
    """

    def __init__(self, mtx, dist, size_wh, cfg: ArucoPipelineConfig | None = None,
                 detector_params: DetectorParams | None = None, device="cuda"):
        self.cfg = cfg or ArucoPipelineConfig()
        self.device = resolve_device(device)
        mtx = np.asarray(mtx, np.float64)
        dist = np.asarray(dist, np.float64).reshape(-1)
        self.tilt = camera.has_tilt(dist)
        if self.device.type == "cuda":
            remap.check_no_tilt(dist)  # the kernel path draws the reference kernel's line
        self.mtx = torch.as_tensor(mtx, dtype=torch.float32, device=self.device)
        self.dist = camera.pad_dist_coeffs(dist, device=self.device)
        self.size_wh = tuple(size_wh)
        self.params = detector_params or DetectorParams()
        self.detector = det.ArucoDetector(self.params, device=self.device)
        w, h = self.size_wh
        self._sel_th, self._sel_tw = remap.pick_tiles(w, h)
        self.map_full = camera.undistort_rectify_map(self.mtx, self.dist, (w, h), tilt=self.tilt)
        if self.cfg.two_pass:
            st = self.params.proposal_stride
            wp, hp = twopass.pooled_frame_size(w, h, st)
            self._pooled_hw = (hp, wp)
            self._pooled_tiles = remap.pick_tiles(wp, hp)
            mtx_p = torch.as_tensor(twopass.pooled_camera(mtx, st), dtype=torch.float32, device=self.device)
            self.map_pooled = camera.undistort_rectify_map(mtx_p, self.dist, (wp, hp), tilt=self.tilt)
            self._groups = tuple(det._patch_groups(h, w, self.params))

    # -- stateless front ----------------------------------------------------

    def front(self, frames: torch.Tensor) -> dict[str, torch.Tensor]:
        """frames: planar (T, 3, H, W) u8 on the pipeline's device -> per-frame slot data + gray."""
        w, h = self.size_wh
        if frames.dtype != torch.uint8 or tuple(frames.shape[1:]) != (3, h, w):
            raise ValueError(f"frames must be (T, 3, {h}, {w}) uint8, got {tuple(frames.shape)} {frames.dtype}")
        if frames.device != self.device:
            raise ValueError(f"frames are on {frames.device}, the pipeline on {self.device}")
        frames = frames.contiguous()
        if not self.cfg.two_pass:
            gray = cuda_remap.remap_gray(frames, self.map_full, self._sel_th, self._sel_tw)  # K3, full res
            corners, ids = self.detector.detect(gray)  # K2, K1 inside
            return self._front_from_detections(gray, corners, ids)
        p = self.params
        st = p.proposal_stride
        pooled_src = cuda_pool.pool_source(frames, st, self._pooled_hw)  # K5
        pooled_gray = cuda_remap.remap_gray(pooled_src, self.map_pooled, *self._pooled_tiles)  # K3
        pool = pooled_gray[:, : h // st, : w // st].to(torch.float32)
        centers, sizes, scores, valid = det.proposals(pool, h, w, p)  # K2
        sel, covered = patch_select.select_tiles_batched(
            centers, valid, h=h, w=w, th=self._sel_th, tw=self._sel_tw, groups=self._groups,
            t_sel=self.cfg.sel_tile_budget, per_scale_k=p.per_scale_k,
        )
        if self.device.type == "cuda":
            gray = cuda_remap.remap_gray_selected(frames, self.map_full, sel, self._sel_th, self._sel_tw)  # K4
        else:
            gray = cuda_remap.remap_gray(frames, self.map_full, self._sel_th, self._sel_tw)
        corners, ids = det.candidates(gray, centers, sizes, scores, valid, p, covered)  # K1 inside
        return self._front_from_detections(gray, corners, ids)

    def _front_from_detections(self, gray, corners, ids):
        present, slot_corners = _slot_by_id(ids, corners)
        rvecs, utvecs, rvecs2, utvecs2, perr, perr2, pswap = estimate_pose_single_markers_two(
            slot_corners, 1.0, self.mtx, self.dist, tilt=self.tilt
        )
        cx, cy, msp = geo.marker_center_and_size(slot_corners)
        return {
            "present": present, "corners": slot_corners,
            "rvec": rvecs, "utvec": utvecs, "rvec2": rvecs2, "utvec2": utvecs2,
            "perr": perr, "perr2": perr2, "pswap": pswap,
            "cx": cx, "cy": cy, "msp": torch.clamp(msp, min=1e-6), "gray": gray,
        }

    # -- temporal scan -------------------------------------------------------

    def _step(self, carry: dict, f: dict, first: bool, crow: torch.Tensor):
        cfg = self.cfg
        mtx, dist, tilt = self.mtx, self.dist, self.tilt
        dev = self.device
        present = f["present"]
        rvec = f["rvec"]
        tvec = f["utvec"] * carry["marker_length"]
        rvec2 = f["rvec2"]
        tvec2 = f["utvec2"] * carry["marker_length"]
        cx, cy, msp = f["cx"], f["cy"], f["msp"]

        # Temporal gate (all vehicles, using L_prev).
        diff = geo.displacement_metres(cx, cy, carry["cx_prev"], carry["cy_prev"], carry["marker_length"], msp)
        prev = carry["detected_prev"].to(torch.bool)
        measured = present & ((prev & (diff < cfg.diff_max)) | first)
        newly = present & ~prev
        detected = (measured | newly).to(torch.int32)
        cx_new = torch.where(measured | newly, cx, carry["cx_prev"])
        cy_new = torch.where(measured | newly, cy, carry["cy_prev"])
        host = measured[3]

        # Host branch: altitude (with the reference's fallback), marker length.
        altitude_raw = tvec[3, 2]
        any_veh = present[:3].any()
        fb_idx = torch.where(any_veh, 2 - torch.argmax(torch.flip(present[:3], (0,)).to(torch.int32)),
                             torch.tensor(3, device=dev))
        alt_fb = tvec[fb_idx, 2]
        use_fb = ~host & (any_veh | present[3])
        altitude_eff = torch.where(host, altitude_raw,
                                   torch.where(use_fb, alt_fb, carry["altitude_real"] * geo.MARKER_DIV))
        update_len = host | use_fb
        marker_length = torch.where(update_len, geo.marker_length_correction(altitude_eff), carry["marker_length"])
        altitude_real = torch.where(update_len, altitude_eff / geo.MARKER_DIV, carry["altitude_real"])

        # Marker size averaging for every measured vehicle.
        new_ring, corr, avg = geo.average_marker_size(carry["msp_rings"], msp)
        rings = torch.where(measured[:, None], new_ring, carry["msp_rings"])
        size_corr = torch.where(measured, corr, carry["size_corr"])
        msp_avg = torch.where(measured, avg, carry["msp_avg"])

        leds = torch.where(
            host,
            _led_value(f["gray"], rvec[3], tvec[3], size_corr[3], altitude_real, mtx, dist, cfg.leds_threshold,
                       cfg.led_bias_px, tilt),
            carry["leds"],
        )
        lidar_pt = geo.project_int(geo.const(geo.VEH4_LIDAR, dev), rvec[3], tvec[3] / size_corr[3], mtx, dist,
                                   tilt=tilt)[0]
        lidar_xy = torch.where(host, lidar_pt, carry["lidar_xy"])

        # Perspective-modified bbox dims under both pose-ambiguity basins.
        flat_a4 = torch.abs(rotation.rodrigues_to_matrix(rvec)[:, 2, 2])
        flat_b4 = torch.abs(rotation.rodrigues_to_matrix(rvec2)[:, 2, 2])
        a_is_flat4 = flat_a4 >= flat_b4
        veh_dims_c = geo.const(geo.VEH_DIMS, dev)
        veh_dims = geo.bbox_dims_update(tvec, rvec, veh_dims_c)
        veh_dims2 = geo.bbox_dims_update(tvec2, rvec2, veh_dims_c)

        # Distance pass (vehicles 0..2 batched).
        if cfg.source_lidar:
            source_xy = lidar_xy.to(torch.float32)
        else:
            source_xy = torch.stack([cx_new[3], cy_new[3]]).to(torch.float32)
        veh_xy = torch.stack([cx_new[:3], cy_new[:3]], dim=-1)
        d_aruco_new = geo.pixel_distance_to_metres(source_xy, veh_xy, marker_length, msp_avg[3], msp_avg[:3])

        def one_basin(dims, rv, tv):
            bbox_pts = geo.bbox_perimeter_points(dims)  # (3, 56, 3)
            point = geo.min_distance_bbox_point(source_xy.expand(3, 2), bbox_pts, rv, tv / size_corr[:3, None],
                                                mtx, dist, tilt=tilt)
            return geo.pixel_distance_to_metres(source_xy, point.to(torch.float32), marker_length, msp_avg[3],
                                                msp_avg[:3])

        e1, e2 = f["perr"][:3], f["perr2"][:3]
        both_fin = torch.isfinite(e1) & torch.isfinite(e2)
        gap = torch.where(both_fin, torch.abs(e2 - e1), torch.zeros_like(e1))
        d_a = one_basin(veh_dims[:3], rvec[:3], tvec[:3])
        d_b = one_basin(veh_dims2[:3], rvec2[:3], tvec2[:3])
        d_flat = torch.where(a_is_flat4[:3], d_a, d_b)
        d_tilt = torch.where(a_is_flat4[:3], d_b, d_a)
        w_flat = 0.5 + 0.5 * gap / (gap + 0.05)
        d_bbox_new = w_flat * d_flat + (1.0 - w_flat) * d_tilt
        do_dist = host & measured[:3]
        dist_aruco = torch.where(do_dist, d_aruco_new, carry["dist_aruco"])
        dist_aruco_bbox = torch.where(do_dist, d_bbox_new, carry["dist_aruco_bbox"])

        if cfg.use_centroid_data:
            crow_f = crow.to(torch.float32)
            cent = torch.stack([crow_f[[5, 9, 13]], crow_f[[6, 10, 14]]], dim=1).clamp(min=0.0)
            bbox = torch.stack([crow_f[[7, 11, 15]], crow_f[[8, 12, 16]]], dim=1).clamp(min=0.0)
            src = lidar_xy.to(torch.float32)
            dc_new = geo.pixel_distance_to_metres(src, cent, marker_length, msp_avg[3], msp_avg[:3])
            db_new = geo.pixel_distance_to_metres(src, bbox, marker_length, msp_avg[3], msp_avg[:3])
            dist_dcnn = torch.where(do_dist, dc_new, carry["dist_dcnn"])
            dist_dcnn_bbox = torch.where(do_dist, db_new, carry["dist_dcnn_bbox"])
        else:
            dist_dcnn, dist_dcnn_bbox = carry["dist_dcnn"], carry["dist_dcnn_bbox"]

        new_carry = {
            "detected_prev": detected, "cx_prev": cx_new, "cy_prev": cy_new, "msp_rings": rings,
            "marker_length": marker_length, "altitude_real": altitude_real, "leds": leds,
            "msp_avg": msp_avg, "size_corr": size_corr, "lidar_xy": lidar_xy,
            "dist_aruco": dist_aruco, "dist_aruco_bbox": dist_aruco_bbox,
            "dist_dcnn": dist_dcnn, "dist_dcnn_bbox": dist_dcnn_bbox,
        }
        out = {
            "detected": detected, "measured": measured, "marker_length": marker_length, "leds": leds,
            "altitude": altitude_real,
            "fov_w": geo.FRAME_W * marker_length / msp_avg[3],
            "fov_h": geo.FRAME_H * marker_length / msp_avg[3],
            "dist_aruco": dist_aruco, "dist_aruco_bbox": dist_aruco_bbox,
            "dist_dcnn": dist_dcnn, "dist_dcnn_bbox": dist_dcnn_bbox,
            "corners": f["corners"], "rvec": rvec, "tvec": tvec, "msp_avg": msp_avg,
            "dist_bbox_basin_a": d_a, "basin_a_is_flat": a_is_flat4[:3],
            "flat_margin": torch.abs(flat_a4 - flat_b4)[:3], "dist_bbox_basin_b": d_b,
            "pose_gap": gap, "pose_swapped": f["pswap"][:3],
        }
        return new_carry, out

    def scan(self, carry: dict, front: dict, first_frame, centroid_rows: torch.Tensor | None = None):
        """Run the state machine over the T frames of ``front``.

        first_frame: (T,) bool, True only on the sequence's first frame;
        centroid_rows: (T, 17) int DCNN CSV rows (zeros when unused).
        Returns (carry, outputs stacked over T).
        """
        t = front["present"].shape[0]
        firsts = [bool(v) for v in (first_frame.tolist() if torch.is_tensor(first_frame) else first_frame)]
        if centroid_rows is None:
            centroid_rows = torch.zeros((t, 17), dtype=torch.int32, device=self.device)
        outs = []
        for i in range(t):
            f = {k: v[i] for k, v in front.items()}
            carry, out = self._step(carry, f, firsts[i], centroid_rows[i])
            outs.append(out)
        return carry, {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    def process(self, frames: torch.Tensor, carry: dict, first: bool = False,
                centroid_rows: torch.Tensor | None = None):
        """front + scan for a batch of frames."""
        f = self.front(frames)
        firsts = [bool(first)] + [False] * (frames.shape[0] - 1)
        return self.scan(carry, f, firsts, centroid_rows)
