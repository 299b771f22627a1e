"""End-to-end ArUco measurement pipeline: batched front + temporal scan.

Counterpart of the JAX reference's ``aruco/pipeline.py``:

* **front** (batched over frames).  Two-pass (the shipped configuration):
  4x4 pool of the source (K5), kernel K3 on the pooled camera, proposals
  (K2), candidate-driven tile selection, K4 on the selected full-resolution
  tiles, the candidate stage (with K1).  Single-pass (``two_pass=False``):
  K3 over the whole full-resolution frame, then the detector's pool, K2
  and the candidate stage with K1.  Then per-id slots and
  unit-length planar pose for both ambiguity basins.  The constants of the
  tile selection, the candidate stage and pose are made with the pipeline,
  so a call copies nothing from the host.  On a card the candidate stage is
  two CUDA graphs a call with K1 launched between them (counters
  ``aruco.windows_graph.*`` and ``aruco.candidates_graph.*``) and pose one
  (``aruco.pose_graph.capture`` and ``.replay``), each captured once for
  each input shape and replayed.  On the CPU the same functions run one
  after the other and the full-resolution gray covers the whole frame, as
  the reference's CPU path does.
* **scan**: the reference's per-frame state machine (DIFF_MAX gating,
  marker-size rings, altitude fallback, LEDs, distances) as a Python loop
  over frames with the same carry semantics.  It makes no host sync, so on
  a card the loop of a call is captured once as a CUDA graph and replayed
  (counters ``aruco.scan_graph.capture`` and ``aruco.scan_graph.replay``).

Each stage is a span of ``utils/profiling.py`` (``aruco.process`` >
``aruco.front`` > ``aruco.pool``, ..., ``aruco.pose``; ``aruco.scan`` >
``aruco.step``, the steps on the CPU and while a graph is captured).

Vehicle slots are fixed: slot v in 0..3 is marker id v + 1; the host car is
id 4 (slot 3).
"""

from __future__ import annotations

import dataclasses
import gc
from typing import NamedTuple

import numpy as np
import torch

from apse_uav_torch.aruco import cuda_labeling, detector as det, dictionary as dict_mod, geometry as geo, patch_select
from apse_uav_torch.aruco import pose
from apse_uav_torch.aruco.detector import DetectorParams
from apse_uav_torch.core import camera, rotation
from apse_uav_torch.device import resolve_device
from apse_uav_torch.preproc import cuda_pool, cuda_remap, remap, twopass
from apse_uav_torch.utils import profiling


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


def _led_value(gray: torch.Tensor, rvec, tvec, size_corr, altitude_real, mtx, dist, led_points, threshold, bias,
               tilt):
    """detectAndDrawLEDs: 8 LED windows (5x5 means) -> 8-bit value.
    Python slicing semantics: gray[y-2:y+3, x-2:x+3] is empty when y < 2 or
    x < 2; rows/cols beyond the image are clipped; sum / 25 either way.
    ``threshold``: a float32 scalar tensor, or None for the altitude's."""
    pts = geo.project_int(led_points, rvec, tvec / size_corr, mtx, dist, bias=bias, tilt=tilt)  # (8, 2) x, y
    thr = torch.clamp(190.0 + torch.trunc(altitude_real), min=240.0) if threshold is None else threshold
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


def _fallback_altitude(tvec: torch.Tensor, present: torch.Tensor, host_slot: torch.Tensor):
    """The reference's altitude fallback: the tvec z of the last present
    vehicle among slots 0-2, else of the host's slot (``host_slot``, a
    one-element int64 tensor holding 3).  A gather, so no sync on the card.
    Returns (altitude, whether any of slots 0-2 is present)."""
    any_veh = present[:3].any()
    idx = torch.where(any_veh, 2 - torch.argmax(torch.flip(present[:3], (0,)).to(torch.int32)), host_slot)
    return tvec[:, 2].index_select(0, idx.reshape(1))[0], any_veh


def _pack(named: dict) -> tuple[list[torch.Tensor], list[tuple]]:
    """Tensors by name -> one flat buffer a dtype and the layout that
    :func:`_unpack` views them back with."""
    groups: dict[torch.dtype, list[torch.Tensor]] = {}
    layout = []
    for name, t in named.items():
        group = groups.setdefault(t.dtype, [])
        layout.append((name, list(groups).index(t.dtype), sum(x.numel() for x in group), t.shape))
        group.append(t)
    return [torch.cat([x.reshape(-1) for x in group]) for group in groups.values()], layout


def _unpack(flats: list[torch.Tensor], layout: list[tuple]) -> dict:
    return {name: flats[g].narrow(0, offset, shape.numel()).view(shape) for name, g, offset, shape in layout}


class _Graph(NamedTuple):
    """One captured stage: the buffers it reads, the flat buffers it writes
    and their layout."""

    graph: torch.cuda.CUDAGraph
    inputs: list[torch.Tensor]
    flats: list[torch.Tensor]
    layout: list[tuple]


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
        self.calls = 0
        w, h = self.size_wh
        self._sel_th, self._sel_tw = remap.pick_tiles(w, h)
        # The gray colour table of the remap kernels (K3, K4), built on the card only.
        self.table = cuda_remap.colour_table(2.0, self.device) if self.device.type == "cuda" else None
        self.map_full = camera.undistort_rectify_map(self.mtx, self.dist, (w, h), tilt=self.tilt)
        if self.cfg.two_pass:
            st = self.params.proposal_stride
            wp, hp = twopass.pooled_frame_size(w, h, st)
            self._pooled_hw = (hp, wp)
            self._pooled_tiles = remap.pick_tiles(wp, hp)
            mtx_p = torch.as_tensor(twopass.pooled_camera(mtx, st), dtype=torch.float32, device=self.device)
            self.map_pooled = camera.undistort_rectify_map(mtx_p, self.dist, (wp, hp), tilt=self.tilt)
        # The tile selection's and the candidate stage's constants, made once here so that a call copies nothing.
        self._groups = tuple(det._patch_groups(h, w, self.params))
        self._patch_sizes = patch_select.patch_sizes(self._groups, self._groups[-1][1], self.device)
        self._dict_table = dict_mod.rotation_table(self.device)
        # The scan's constants, made once here so that a step copies nothing from the host.
        f32 = dict(dtype=torch.float32, device=self.device)
        self._led_points = torch.tensor(geo.LED_POINTS, **f32)
        self._veh4_lidar = torch.tensor(geo.VEH4_LIDAR, **f32)
        self._veh_dims = torch.tensor(geo.VEH_DIMS, **f32)
        self._host_slot = torch.tensor([3], device=self.device)
        thr = self.cfg.leds_threshold
        self._led_threshold = None if thr is None else torch.tensor(float(thr), **f32)
        bias = tuple(self.cfg.led_bias_px)
        self._led_bias = None if bias == (0.0, 0.0) else torch.tensor(bias, **f32)
        # DCNN CSV columns of the centroids (x, y) and bbox points (x, y) of vehicles 1-3.
        self._centroid_cols = torch.tensor([[5, 6], [9, 10], [13, 14]], device=self.device)
        self._bbox_cols = torch.tensor([[7, 8], [11, 12], [15, 16]], device=self.device)
        # Pose's constants at unit length, and the inverse of the object square's map by marker count.
        self._pose_obj = pose.object_points(1.0, self.device)
        self._pose_mirror = torch.tensor(pose.MIRROR, **f32)
        self._pose_inverse: dict[int, torch.Tensor] = {}
        self._graphs: dict[tuple, _Graph] = {}

    # -- stateless front ----------------------------------------------------

    def front(self, frames: torch.Tensor) -> dict[str, torch.Tensor]:
        """frames: planar (T, 3, H, W) u8 on the pipeline's device -> per-frame slot data + gray."""
        w, h = self.size_wh
        if frames.dtype != torch.uint8 or tuple(frames.shape[1:]) != (3, h, w):
            raise ValueError(f"frames must be (T, 3, {h}, {w}) uint8, got {tuple(frames.shape)} {frames.dtype}")
        if frames.device != self.device:
            raise ValueError(f"frames are on {frames.device}, the pipeline on {self.device}")
        with profiling.span("aruco.front"):
            frames = frames.contiguous()
            p = self.params
            st = p.proposal_stride
            if not self.cfg.two_pass:
                with profiling.span("aruco.remap_full"):
                    gray = cuda_remap.remap_gray(frames, self.map_full, self._sel_th, self._sel_tw,
                                                 table=self.table)  # K3
                with profiling.span("aruco.pool"):
                    pool = det.pool_gray(gray, st)
                with profiling.span("aruco.proposals"):
                    props = det.proposals(pool, h, w, p)  # K2
                with profiling.span("aruco.candidates"):
                    corners, ids = self._candidates(gray, *props, None)  # K1 inside
                return self._front_from_detections(gray, corners, ids)
            with profiling.span("aruco.pool"):
                pooled_src = cuda_pool.pool_source(frames, st, self._pooled_hw)  # K5
            with profiling.span("aruco.remap_pooled"):
                pooled_gray = cuda_remap.remap_gray(pooled_src, self.map_pooled, *self._pooled_tiles,
                                                    table=self.table)  # K3
            with profiling.span("aruco.proposals"):
                pool = pooled_gray[:, : h // st, : w // st].to(torch.float32)
                centers, sizes, scores, valid = det.proposals(pool, h, w, p)  # K2
            with profiling.span("aruco.select_tiles"):
                sel, covered = patch_select.select_tiles_batched(
                    centers, valid, h=h, w=w, th=self._sel_th, tw=self._sel_tw, groups=self._groups,
                    t_sel=self.cfg.sel_tile_budget, per_scale_k=p.per_scale_k, psize=self._patch_sizes,
                )
            with profiling.span("aruco.remap_selected"):
                if self.device.type == "cuda":
                    gray = cuda_remap.remap_gray_selected(frames, self.map_full, sel, self._sel_th, self._sel_tw,
                                                          table=self.table)  # K4
                else:
                    gray = cuda_remap.remap_gray(frames, self.map_full, self._sel_th, self._sel_tw)
            with profiling.span("aruco.candidates"):
                corners, ids = self._candidates(gray, centers, sizes, scores, valid, covered)  # K1 inside
            return self._front_from_detections(gray, corners, ids)

    def _candidates(self, gray, centers, sizes, scores, valid, covered):
        """The candidate stage (:func:`det.candidates`) as :func:`det.binarized_windows`,
        K1 through its wrapper, then :func:`det.candidates_from_labels`; on a
        card the two functions are CUDA graphs (:meth:`_stage`), keyed by the
        inputs' shapes and dtypes and by whether ``covered`` is given, and K1
        is launched between them."""
        p, hw = self.params, tuple(gray.shape[1:])
        extra = [] if covered is None else [covered]
        key = (tuple((t.shape, t.dtype) for t in (gray, centers, sizes, scores, valid)), covered is not None)

        def windows(inputs):
            pres, darks = det.binarized_windows(*inputs, p)
            return {"darks": darks, **{(g, i): t for g, parts in enumerate(pres) for i, t in enumerate(parts)}}

        out = self._stage("windows", key, windows, [gray, centers, sizes])
        labels = cuda_labeling.labels(out.pop("darks"))  # K1
        parts = list(out)  # (group, index in the group's tuple)

        def rest(inputs):
            labels_, scores_, valid_, *more = inputs
            covered_ = more.pop(0) if extra else None
            named = dict(zip(parts, more))
            pres = [tuple(named[k] for k in sorted(k for k in named if k[0] == g)) for g in range(len(self._groups))]
            corners, ids = det.candidates_from_labels(labels_, pres, scores_, valid_, hw, p, covered_,
                                                      self._dict_table)
            return {"corners": corners, "ids": ids}

        out = self._stage("candidates", key, rest, [labels, scores, valid, *extra, *(out[k] for k in parts)])
        return out["corners"], out["ids"]

    def _front_from_detections(self, gray, corners, ids):
        """Pose of the detections: on a card one CUDA graph a call, keyed by the inputs' shapes and dtypes."""
        with profiling.span("aruco.pose"):
            n = 4 * ids.shape[0]  # four slots a frame
            if n not in self._pose_inverse:
                self._pose_inverse[n] = pose.source_inverse(self._pose_obj[:, :2], n)
            key = tuple((t.shape, t.dtype) for t in (ids, corners))
            out = self._stage("pose", key, lambda inputs: self._pose(*inputs, self._pose_inverse[n]), [ids, corners])
        return {**out, "gray": gray}

    def _pose(self, ids, corners, src_inv):
        """Slots by id, both basins' unit-length poses, centres and sizes: no host sync."""
        present, slot_corners = _slot_by_id(ids, corners)
        rvecs, utvecs, rvecs2, utvecs2, perr, perr2, pswap = pose.estimate_two(
            slot_corners, self._pose_obj, self.mtx, self.dist, 6, self.tilt, src_inv, self._pose_mirror
        )
        cx, cy, msp = geo.marker_center_and_size(slot_corners)
        msp = torch.clamp(msp, min=1e-6)
        return {
            "present": present, "corners": slot_corners,
            "rvec": rvecs, "utvec": utvecs, "rvec2": rvecs2, "utvec2": utvecs2,
            "perr": perr, "perr2": perr2, "pswap": pswap,
            "cx": cx, "cy": cy, "msp": msp,
        }

    # -- temporal scan -------------------------------------------------------

    def _step(self, carry: dict, f: dict, first: bool, crow: torch.Tensor):
        cfg = self.cfg
        mtx, dist, tilt = self.mtx, self.dist, self.tilt
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
        alt_fb, any_veh = _fallback_altitude(tvec, present, self._host_slot)
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
            _led_value(f["gray"], rvec[3], tvec[3], size_corr[3], altitude_real, mtx, dist, self._led_points,
                       self._led_threshold, self._led_bias, tilt),
            carry["leds"],
        )
        lidar_pt = geo.project_int(self._veh4_lidar, rvec[3], tvec[3] / size_corr[3], mtx, dist, tilt=tilt)[0]
        lidar_xy = torch.where(host, lidar_pt, carry["lidar_xy"])

        # Perspective-modified bbox dims under both pose-ambiguity basins.
        flat_a4 = torch.abs(rotation.rodrigues_to_matrix(rvec)[:, 2, 2])
        flat_b4 = torch.abs(rotation.rodrigues_to_matrix(rvec2)[:, 2, 2])
        a_is_flat4 = flat_a4 >= flat_b4
        veh_dims = geo.bbox_dims_update(tvec, rvec, self._veh_dims)
        veh_dims2 = geo.bbox_dims_update(tvec2, rvec2, self._veh_dims)

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
            cent = crow_f[self._centroid_cols].clamp(min=0.0)
            bbox = crow_f[self._bbox_cols].clamp(min=0.0)
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
        Returns (carry, outputs stacked over T), tensors of their own.

        On a card the whole scan is one CUDA graph, captured once for each
        T, pattern of first frames and input layout, then replayed; on the
        CPU the steps run one by one.
        """
        with profiling.span("aruco.scan"):
            if torch.is_tensor(first_frame):
                with profiling.sync("first_frame"):
                    first_frame = first_frame.tolist()
            firsts = tuple(bool(v) for v in first_frame)
            if self.device.type == "cuda":
                return self._scan_graph(carry, front, firsts, centroid_rows)
            if centroid_rows is None:
                centroid_rows = torch.zeros((len(firsts), 17), dtype=torch.int32, device=self.device)
            return self._scan_eager(carry, front, firsts, centroid_rows)

    def _scan_eager(self, carry: dict, front: dict, firsts: tuple, centroid_rows: torch.Tensor):
        """The steps one by one: the CPU path, and what a graph captures."""
        outs = []
        for i, first in enumerate(firsts):
            with profiling.span("aruco.step"):
                f = {k: v[i] for k, v in front.items()}
                carry, out = self._step(carry, f, first, centroid_rows[i])
            outs.append(out)
        return carry, {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    def _scan_graph(self, carry: dict, front: dict, firsts: tuple, centroid_rows: torch.Tensor | None):
        """The scan as a CUDA graph (:meth:`_graphed`), keyed by the pattern
        of first frames and the inputs' layout."""
        inputs = [*carry.values(), *front.values()] + ([] if centroid_rows is None else [centroid_rows])
        key = (firsts, tuple((k, v.shape, v.dtype) for k, v in carry.items()),
               tuple((k, v.shape, v.dtype) for k, v in front.items()), centroid_rows is not None)
        n_carry, n_front = len(carry), len(front)

        def run(static):
            c = dict(zip(carry, static[:n_carry]))
            f = dict(zip(front, static[n_carry:n_carry + n_front]))
            rows = static[-1] if centroid_rows is not None else torch.zeros(
                (len(firsts), 17), dtype=torch.int32, device=self.device)
            new_carry, out = self._scan_eager(c, f, firsts, rows)
            return {**{("carry", k): v for k, v in new_carry.items()}, **{("out", k): v for k, v in out.items()}}

        return self._split(self._graphed("scan", key, run, inputs))

    def _stage(self, name: str, key: tuple, run, inputs: list[torch.Tensor]) -> dict:
        """``run(inputs)``: on a card as a CUDA graph (:meth:`_graphed`), on the CPU as it is."""
        return self._graphed(name, key, run, inputs) if self.device.type == "cuda" else run(inputs)

    def _graphed(self, name: str, key: tuple, run, inputs: list[torch.Tensor]) -> dict:
        """``run(inputs)`` (tensors by name, no host sync) as a CUDA graph a key:
        on a key seen before, the inputs copied into the graph's buffers, one
        replay, and its outputs copied out (a copy a dtype), so that what a call
        returns stays as it is after the next; on a new key, ``run`` on a side
        stream, its results returned, and the graph captured.  Counts
        ``aruco.<name>_graph.replay`` or ``.capture``."""
        entry = self._graphs.get((name, key))
        if entry is not None:
            torch._foreach_copy_(entry.inputs, inputs)
            entry.graph.replay()
            profiling.count(f"aruco.{name}_graph.replay")
            return _unpack([f.clone() for f in entry.flats], entry.layout)

        static = [v.clone() for v in inputs]
        # PyTorch's rules for a capture: warm up on a side stream, then
        # capture there into the graph's private memory pool.  Not through
        # torch.cuda.graph(), which first synchronizes the device: a host sync.
        # No garbage collection while capturing: freeing another graph then
        # (one left in a reference cycle) would invalidate the capture.
        here = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(here)
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        with torch.cuda.stream(side):
            flats, layout = _pack(run(static))
            gc.disable()
            graph.capture_begin()
            try:
                static_flats, _ = _pack(run(static))
            finally:
                graph.capture_end()
                if collecting:
                    gc.enable()
        here.wait_stream(side)
        for f in flats:
            f.record_stream(here)
        self._graphs[(name, key)] = _Graph(graph, static, static_flats, layout)
        profiling.count(f"aruco.{name}_graph.capture")
        return _unpack(flats, layout)

    @staticmethod
    def _split(named: dict) -> tuple[dict, dict]:
        carry = {k: v for (part, k), v in named.items() if part == "carry"}
        return carry, {k: v for (part, k), v in named.items() if part == "out"}

    def process(self, frames: torch.Tensor, carry: dict, first: bool = False,
                centroid_rows: torch.Tensor | None = None):
        """front + scan for a batch of frames."""
        self.calls += 1
        with profiling.span("aruco.process", batch=self.calls):
            f = self.front(frames)
            firsts = [bool(first)] + [False] * (frames.shape[0] - 1)
            return self.scan(carry, f, firsts, centroid_rows)
