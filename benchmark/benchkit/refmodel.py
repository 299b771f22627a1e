"""The tracker's plain reference, built on ``refplain``: the preprocessing,
the resize, Mask R-CNN R-FPN, the top-k cap and re-ID embeddings, and the
association, each computed with plain PyTorch ops.

The resize, its target and the boxes' mapping back to the frame are frozen
copies of the measured package's ``dcnn/engines.py``.  ``tf32`` allows TF32
in the convolutions and products: the control, one step below the float32
that the configuration states.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from refplain.dcnn import config as rc, structures, tracker as rtracker
from refplain.dcnn.models.association import AssociationHead
from refplain.dcnn.models.mask_rcnn import MaskRCNN
from refplain.dcnn.weights import load_detectron2
from refplain.preproc.remap import Preprocessor


def _tuples(fields: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in fields.items()}


def model_config(model: dict, rc=rc):
    """The ModelConfig of the config module ``rc`` (the reference's, or the
    measured package's) from the configuration file's ``model``."""
    return rc.ModelConfig(**{**model, "anchors": rc.AnchorConfig(**_tuples(model["anchors"])),
                             "rpn": rc.RPNConfig(**model["rpn"]), "roi": rc.ROIConfig(**_tuples(model["roi"])),
                             "input": rc.InputConfig(**_tuples(model["input"]))})


def tracker_config(tracker: dict, rc=rc):
    return rc.TrackerConfig(**tracker)


@contextlib.contextmanager
def precision(tf32: bool):
    """TF32 allowed (``tf32``) or not in matrix products and cuDNN convolutions inside the block."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def linear_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    scale = n_out / n_in
    j = np.arange(n_in, dtype=np.float64)[:, None]
    centers = (np.arange(n_out, dtype=np.float64)[None, :] + 0.5) / scale - 0.5
    stretch = min(scale, 1.0)
    w = np.maximum(0.0, 1.0 - np.abs(j - centers) * stretch)
    return (w / w.sum(axis=0, keepdims=True)).astype(np.float32)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def resize_frames_matmul(frames: torch.Tensor, a_h: torch.Tensor, a_w: torch.Tensor) -> torch.Tensor:
    b, h, w, c = frames.shape
    x = frames.to(torch.float32).permute(0, 2, 3, 1).reshape(b * w * c, h)
    y = _bf16(x @ _bf16(a_h)).reshape(b, w, c, -1)
    z = y.permute(0, 2, 3, 1).reshape(-1, w) @ _bf16(a_w)
    return z.reshape(b, c, a_h.shape[1], -1).permute(0, 2, 3, 1)


def resize_target(orig_hw, min_size: int, max_size: int, div: int = 32):
    h, w = orig_hw
    scale = min_size / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    return (-(-nh // div) * div, -(-nw // div) * div), (nh, nw)


class RefTracker:
    """The reference tracker: the same calls as the measured ``RcnnTracker``
    (``process_frames_async``, ``materialize``, ``state``, ``reset``) and a
    ``pre`` of the measured ``Preprocessor``'s signature, in plain ops."""

    def __init__(self, model: dict, tracker: dict, ckpt: dict, assoc: dict, orig_hw, camera: dict, device,
                 tf32: bool = False):
        self.device = device
        self.tf32 = tf32
        self.cfg = model_config(model)
        self.tcfg = tracker_config(tracker)
        self.orig_hw = tuple(orig_hw)
        self.model = MaskRCNN(self.cfg).eval().requires_grad_(False)
        load_detectron2(self.model, ckpt)
        self.model.to(device)
        self.head = AssociationHead(self.cfg.fpn_channels * self.tcfg.roi_size ** 2, self.tcfg.embedding_dim)
        self.head.load_state_dict({k: torch.as_tensor(v) for k, v in assoc.items()})
        self.head = self.head.eval().requires_grad_(False).to(device)
        inp = self.cfg.input
        self.pad_hw, self.net_hw = resize_target(self.orig_hw, inp.min_size_test, inp.max_size_test,
                                                 inp.pad_divisibility)
        (oh, ow), (nh, nw) = self.orig_hw, self.net_hw
        self.mats = tuple(torch.from_numpy(linear_resize_matrix(n, m)).to(device) for n, m in ((oh, nh), (ow, nw)))
        self.box_scale = torch.tensor([ow / nw, oh / nh, ow / nw, oh / nh], dtype=torch.float32, device=device)
        self.pre = Preprocessor(camera["mtx"], camera["dist"], (ow, oh), device=device)
        self.reset()

    def reset(self) -> None:
        self.state = structures.init_track_state(self.tcfg.max_tracks, self.tcfg.embedding_dim, device=self.device)

    @torch.no_grad()
    def resize(self, frames: torch.Tensor) -> torch.Tensor:
        (ph, pw), (nh, nw) = self.pad_hw, self.net_hw
        with precision(self.tf32):
            x = resize_frames_matmul(frames, *self.mats)
        return F.pad(x, (0, 0, 0, pw - nw, 0, ph - nh))

    @torch.no_grad()
    def detect(self, frames: torch.Tensor):
        """Preprocessed (B, H, W, 3) u8 frames -> (detections in frame coordinates, backbone maps)."""
        with precision(self.tf32):
            dets, feats = self.model.inference(self.resize(frames))
        oh, ow = self.orig_hw
        b = dets["boxes"] * self.box_scale
        b = torch.stack([b[..., 0].clamp(0, ow), b[..., 1].clamp(0, oh), b[..., 2].clamp(0, ow),
                         b[..., 3].clamp(0, oh)], dim=-1)
        return {**dets, "boxes": b}, feats

    @torch.no_grad()
    def embed(self, dets: dict, feats: dict):
        with precision(self.tf32):
            return rtracker.prepare_frame(dets, feats["p2"], self.head, self.tcfg, self.orig_hw)

    @torch.no_grad()
    def associate(self, state: dict, det_cap: dict, emb: torch.Tensor):
        return rtracker.associate_frames(state, det_cap, emb, self.tcfg, self.orig_hw)

    def process_frames_async(self, frames: torch.Tensor):
        dets, feats = self.detect(frames)
        self.state, recents = self.associate(self.state, *self.embed(dets, feats))
        return dets, recents

    def materialize(self, pending) -> dict:
        return {k: v.cpu().numpy() for k, v in pending[1].items()}

    def offload(self) -> None:
        """Move the weights to the host (while the measured program runs)."""
        self.model.to("cpu")
        self.head.to("cpu")

    def reload(self) -> None:
        self.model.to(self.device)
        self.head.to(self.device)
