"""Runtime engines: the detector wrapper and the tracking engine.

Counterpart of the JAX reference's ``dcnn/engines.py``:

* :class:`TrackPredictor` -- resize (two separable matrix products) + Mask
  R-CNN inference, detections mapped back to the original frame;
* :class:`RcnnTracker` -- detect -> embed -> associate -> track over batches
  of frames: the detector and the embeddings run on the whole batch, only
  the association loops over its frames; the embeddings read the backbone
  map :func:`reid_map` names (R-FPN's p2, C4's res2);
* :class:`SelectivePredictor` -- proposals from the coarsest RPN level only,
  each stage timed.

The predictors build their model through ``c4.build_model`` (R-FPN, C4 or
ViTDet).  A config's ``input.format`` "RGB" flips the BGR frames before the
resize, and its ``input.square_size`` pads the normalised image with zeros
to a square and clips boxes to the resized image, as detectron2 does.
Every entry point runs on ``cuda`` unless the caller asks for ``cpu``; there
is no fallback.  The float32 model runs in true float32 on the card: TF32 is off
for matrix products and convolutions inside every call (:func:`full_fp32`).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch
import torch.nn.functional as F

from apse_uav_torch.dcnn import structures, tracker as tracker_mod
from apse_uav_torch.dcnn.config import ModelConfig, TrackerConfig
from apse_uav_torch.dcnn.models.association import AssociationHead
from apse_uav_torch.dcnn.models.c4 import build_model
from apse_uav_torch.dcnn.weights import load_detectron2
from apse_uav_torch.device import resolve_device, synchronize
from apse_uav_torch.utils import profiling


@contextlib.contextmanager
def full_fp32():
    """TF32 off for matrix products and cuDNN convolutions inside the block
    (cuDNN allows TF32 by default); the previous settings come back after."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def linear_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """The (n_in, n_out) operator of ``jax.image.resize(method="linear")``
    along one axis (antialiased triangle kernel, stretched by the downsample
    factor, normalised per output sample), computed in float64, returned f32."""
    scale = n_out / n_in
    j = np.arange(n_in, dtype=np.float64)[:, None]
    centers = (np.arange(n_out, dtype=np.float64)[None, :] + 0.5) / scale - 0.5
    stretch = min(scale, 1.0)
    w = np.maximum(0.0, 1.0 - np.abs(j - centers) * stretch)
    return (w / w.sum(axis=0, keepdims=True)).astype(np.float32)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (nearest even), held in float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def resize_frames_matmul(frames: torch.Tensor, a_h: torch.Tensor, a_w: torch.Tensor) -> torch.Tensor:
    """Bilinear resize of (B, H, W, C) u8 frames by two separable products ->
    (B, H', W', C) float32, with the reference's roundings: the operands
    rounded to bfloat16 (exact for u8), the first product accumulated in f32
    and rounded to bfloat16, the second accumulated and returned in f32.
    Both products are float32 matmuls of the rounded values."""
    b, h, w, c = frames.shape
    x = frames.to(torch.float32).permute(0, 2, 3, 1).reshape(b * w * c, h)
    y = _bf16(x @ _bf16(a_h)).reshape(b, w, c, -1)  # (B, W, C, H'): one 2-D product
    z = y.permute(0, 2, 3, 1).reshape(-1, w) @ _bf16(a_w)  # (B*C*H', W')
    return z.reshape(b, c, a_h.shape[1], -1).permute(0, 2, 3, 1)


def resize_target(orig_hw: tuple[int, int], min_size: int, max_size: int, div: int = 32):
    """ResizeShortestEdge target (detectron2 semantics): ((padded h, w), (h, w))."""
    h, w = orig_hw
    scale = min_size / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))

    def pad(v):
        return -(-v // div) * div

    return (pad(nh), pad(nw)), (nh, nw)


def reid_map(cfg: ModelConfig) -> tuple[str, int]:
    """The backbone map the re-ID embeddings read and its channels: the
    pyramid's ``p2`` (R-FPN, ViTDet); C4, which has no pyramid, its trunk's
    ``res2``, of p2's stride (4) and width (256), so the association head
    keeps its input size.  At 40 m a 4.0 x 2.2 m roof is ~30 x 16 texels at
    stride 4, ~7 x 4 on res4."""
    return ("res2", 256) if cfg.architecture == "c4" else ("p2", cfg.fpn_channels)


class TrackPredictor:
    """Resize + Mask R-CNN inference; detections in original frame coordinates.

    ``weights``: a detectron2 GeneralizedRCNN state dict (names -> arrays or
    tensors), e.g. ``weights.load_torch_file("model_final.pth")``; keys the
    checkpoint lacks stay at their initial values and are listed in
    ``missing``.

    Example:
        pred = TrackPredictor(uav_tracker_config(), load_torch_file(path), (2160, 3840))
        dets, feats = pred(frames_u8)   # (B, 2160, 3840, 3) u8 BGR, numpy or on the device
    """

    def __init__(self, cfg: ModelConfig, weights, orig_hw: tuple[int, int], device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.orig_hw = tuple(orig_hw)
        inp = cfg.input
        self.pad_hw, self.net_hw = resize_target(self.orig_hw, inp.min_size_test, inp.max_size_test,
                                                 inp.pad_divisibility)
        # The extent the model clips boxes to: the padded input, or with a
        # square pad (detectron2's order) the resized image.
        self.clip_hw = self.pad_hw
        self._square_fill = None
        if inp.square_size:
            if max(self.net_hw) > inp.square_size:
                raise ValueError(f"a {self.net_hw} image does not fit the {inp.square_size} square")
            self.pad_hw, self.clip_hw = (inp.square_size,) * 2, self.net_hw
            self._square_fill = torch.tensor(inp.pixel_mean, dtype=torch.float32, device=self.device)
        self._rgb = inp.format == "RGB"
        self.model = build_model(cfg).eval().requires_grad_(False)
        self.missing = load_detectron2(self.model, weights)[0] if weights is not None else []
        self.model.to(self.device)
        nh, nw = self.net_hw
        self._resize_mats = tuple(torch.from_numpy(linear_resize_matrix(n, m)).to(self.device)
                                  for n, m in ((self.orig_hw[0], nh), (self.orig_hw[1], nw)))
        (oh, ow) = self.orig_hw
        self._box_scale = torch.tensor([ow / nw, oh / nh, ow / nw, oh / nh], dtype=torch.float32, device=self.device)

    def _frames(self, frames_u8) -> torch.Tensor:
        if isinstance(frames_u8, torch.Tensor):
            if frames_u8.device != self.device:
                raise ValueError(f"frames are on {frames_u8.device}, the predictor on {self.device}")
            return frames_u8
        return torch.from_numpy(np.ascontiguousarray(frames_u8)).to(self.device)

    def resize(self, frames_u8) -> torch.Tensor:
        """(B, H, W, 3) u8 BGR -> (B, pad_h, pad_w, 3) f32 in the configured
        channel order (flipped first for "RGB"): resized to ``net_hw`` and
        zero-padded, or with a square pad filled with the pixel mean, which
        the model's normalisation turns into exact zeros (detectron2 pads the
        normalised image with 0)."""
        (ph, pw), (nh, nw) = self.pad_hw, self.net_hw
        frames = self._frames(frames_u8)
        if self._rgb:
            frames = frames.flip(-1)
        with full_fp32():
            x = resize_frames_matmul(frames, *self._resize_mats)
        x = F.pad(x, (0, 0, 0, pw - nw, 0, ph - nh))
        if self._square_fill is not None:
            x[:, nh:] = self._square_fill
            x[:, :, nw:] = self._square_fill
        return x

    def postprocess(self, dets: dict) -> dict:
        """Boxes rescaled to the original frame (detectron2's
        detector_postprocess) and re-clipped to it: the model clipped to the
        padded extent."""
        oh, ow = self.orig_hw
        boxes = dets["boxes"] * self._box_scale
        boxes = torch.stack([boxes[..., 0].clamp(0, ow), boxes[..., 1].clamp(0, oh), boxes[..., 2].clamp(0, ow),
                             boxes[..., 3].clamp(0, oh)], dim=-1)
        return {**dets, "boxes": boxes}

    @torch.no_grad()
    def __call__(self, frames_u8):
        """frames (B, H, W, 3) u8 BGR -> (detections, backbone maps)."""
        with profiling.span("track.resize"):
            x = self.resize(frames_u8)
        hw = self.clip_hw
        with full_fp32():
            with profiling.span("track.features"):
                feats = self.model.features(x)
            with profiling.span("track.proposals"):
                boxes, _, valid = self.model.proposals(feats, hw)
            with profiling.span("track.roi_heads"):
                dets = self.postprocess(self.model.detect(feats, boxes, valid, hw))
        return dets, feats


class SelectivePredictor:
    """Proposals from the coarsest RPN level only, each stage timed (the
    reference's SelectiveMaskRCNN scan and SelectiveRPN,
    selective_rcnn.py:46-76, selective_rpn.py:47-48).

    ``__call__`` runs the backbone alone, then the whole inference with
    ``rpn_levels``; each stage is bracketed by a synchronize of the device,
    and its seconds land in ``timings["backbone"]`` and
    ``timings["selective_scan"]``.  Boxes are scaled to ``orig_hw`` as the
    reference scales them (not re-clipped)."""

    def __init__(self, cfg: ModelConfig, weights, orig_hw: tuple[int, int], rpn_levels: tuple[str, ...] = ("p6",),
                 device="cuda"):
        self.base = TrackPredictor(cfg, weights, orig_hw, device)
        self.device = self.base.device
        self.rpn_levels = tuple(rpn_levels)
        self.timings: dict[str, float] = {}
        (oh, ow), (nh, nw) = self.base.orig_hw, self.base.net_hw
        self._scale = torch.tensor([ow / nw, oh / nh, ow / nw, oh / nh], dtype=torch.float32, device=self.device)

    @torch.no_grad()
    def __call__(self, frames_u8) -> dict[str, torch.Tensor]:
        """frames (B, H, W, 3) u8 -> detections (boxes in original coordinates)."""
        x = self.base.resize(frames_u8)
        model = self.base.model
        with full_fp32():
            synchronize(self.device)
            t0 = time.perf_counter()
            model.features(x)
            synchronize(self.device)
            self.timings["backbone"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            dets, _ = model.inference(x, rpn_levels=self.rpn_levels)
            synchronize(self.device)
            self.timings["selective_scan"] = time.perf_counter() - t0
        return {**dets, "boxes": dets["boxes"] * self._scale}


class Pending(tuple):
    """A dispatched batch: the pair (detections, snapshots) on the device, and
    ``batch``, the number of its dispatch (its spans' batch)."""

    batch: int | None = None


class RcnnTracker:
    """Detect -> associate -> track (the reference's RcnnTracker).

    ``assoc_weights``: the AssociationHead state dict ({"fc.weight",
    "fc.bias"}); ``models.association.init_weights`` makes a seeded one.
    ``process_frames_async`` enqueues a batch without waiting for the device
    except at its loops' convergence tests; ``materialize`` copies the
    snapshots to the host.  A caller that dispatches batch N+1 before it
    materialises batch N overlaps the host's work on N with the device's on
    N+1.
    """

    def __init__(self, model_cfg: ModelConfig, tracker_cfg: TrackerConfig, weights, assoc_weights,
                 orig_hw: tuple[int, int], display_info: tuple[str, ...] = (), device="cuda"):
        self.predictor = TrackPredictor(model_cfg, weights, orig_hw, device)
        self.device = self.predictor.device
        self.cfg = tracker_cfg
        self.orig_hw = tuple(orig_hw)
        self.display_info = tuple(display_info)
        self.reid, channels = reid_map(model_cfg)
        self.head = AssociationHead(channels * tracker_cfg.roi_size**2, tracker_cfg.embedding_dim)
        self.head.load_state_dict({k: torch.as_tensor(np.array(v)) for k, v in assoc_weights.items()})
        self.head = self.head.eval().requires_grad_(False).to(self.device)
        self.dispatched = 0
        self.reset()

    def reset(self) -> None:
        mask_res = 2 * self.predictor.cfg.roi.mask_pooler_resolution  # the model's masks: R-FPN 28, C4 14
        self.state = structures.init_track_state(self.cfg.max_tracks, self.cfg.embedding_dim, mask_res,
                                                 device=self.device)
        self.frame_count = 0

    @torch.no_grad()
    def embed(self, dets: dict, feats: dict):
        """The stateless half over the batch: top-k cap + re-ID embeddings."""
        with profiling.span("track.embed"), full_fp32():
            return tracker_mod.prepare_frame(dets, feats[self.reid], self.head, self.cfg, self.orig_hw)

    @torch.no_grad()
    def associate(self, dets: dict, emb: torch.Tensor) -> dict:
        """The state-carrying half, frame by frame; returns the stacked snapshots."""
        with profiling.span("track.associate"):
            self.state, recents = tracker_mod.associate_frames(self.state, dets, emb, self.cfg, self.orig_hw)
        return recents

    def process_frames_async(self, frames_u8) -> Pending:
        """Dispatch detect + embed + associate for a batch; returns a pending
        handle for :meth:`materialize`."""
        self.dispatched += 1
        with profiling.span("track.dispatch", batch=self.dispatched):
            dets, feats = self.predictor(frames_u8)
            self.frame_count += int(frames_u8.shape[0])
            det_cap, emb = self.embed(dets, feats)
            pending = Pending((dets, self.associate(det_cap, emb)))
        pending.batch = self.dispatched
        return pending

    def materialize(self, pending) -> dict[str, np.ndarray]:
        """Copy a pending batch's snapshots (T, ...) to the host, one sync a copy."""
        dets, recents = pending
        with profiling.span("track.materialize", batch=getattr(pending, "batch", None)):
            with profiling.sync("materialize", len(recents)):
                out = {k: v.cpu().numpy() for k, v in recents.items()}
        if self.display_info:
            self._debug_print(dets, out)
        return out

    def process_frames(self, frames_u8) -> dict[str, np.ndarray]:
        """frames (T, H, W, 3) u8 -> recent-object snapshots (T, ...) on the host."""
        return self.materialize(self.process_frames_async(frames_u8))

    def next_frame(self, frame_u8) -> dict[str, np.ndarray]:
        """One frame (H, W, 3); returns its snapshot."""
        frame = frame_u8[None] if isinstance(frame_u8, torch.Tensor) else np.asarray(frame_u8)[None]
        return {k: v[0] for k, v in self.process_frames(frame).items()}

    def _debug_print(self, dets: dict, recents: dict) -> None:
        """Host-side named traces ('frame_count', 'detections', 'objects')."""
        t = recents["valid"].shape[0]
        for b in range(t):
            if "frame_count" in self.display_info:
                print(f"\nFRAME: {self.frame_count - t + b + 1}")
            if "detections" in self.display_info:
                v = dets["valid"][b].cpu().numpy()
                cls = dets["classes"][b].cpu().numpy()
                print(f"{int(v.sum())} detections:")
                for d in np.nonzero(v)[0]:
                    print(f"detection_id: {d} class: {int(cls[d])}")
            if "objects" in self.display_info:
                for k in np.nonzero(recents["valid"][b])[0]:
                    print(f"object id {int(recents['ids'][b][k])} class {int(recents['classes'][b][k])} "
                          f"score {float(recents['scores'][b][k]):.2f}")
