"""The plain reference of the ViTDet tracker: ``refmodel.RefTracker`` with
Mask R-CNN ViTDet (``refplain.dcnn.models.vitdet``) in place of R-FPN.

detectron2's input order for ViTDet: the BGR frames flipped to RGB, resized
(the same separable products as R-FPN's reference, to 576 x 1024 for a 4K
frame), and handed to the model unpadded; the model normalises and pads to
its square itself and clips boxes to the resized image, so ``pad_hw`` here
is the resized image's size.  The re-ID embeddings read p2 and the
association is R-FPN's.  The reference's frozen ``ModelConfig`` has none of
the ViTDet fields: :func:`model_config_vitdet` leaves out what a config
module lacks, and the model takes the ViT and head settings from the
configuration file beside it.
"""

from __future__ import annotations

import dataclasses

import torch

from benchkit.refmodel import (RefTracker, _tuples, linear_resize_matrix, precision, resize_frames_matmul,
                               resize_target, tracker_config)
from refplain.dcnn import config as rc
from refplain.dcnn.models.association import AssociationHead
from refplain.dcnn.models.vitdet import MaskRCNNViTDet
from refplain.dcnn.weights import load_detectron2
from refplain.preproc.remap import Preprocessor


def model_config_vitdet(model: dict, rc=rc):
    """The ModelConfig of the config module ``rc`` from a ViTDet
    configuration file's ``model``, each nested config with the fields its
    class has: all of them in the measured package's, with its ``ViTConfig``."""

    def known(cls, d: dict) -> dict:
        return _tuples({k: v for k, v in d.items() if k in {f.name for f in dataclasses.fields(cls)}})

    out = {**known(rc.ModelConfig, model), "anchors": rc.AnchorConfig(**_tuples(model["anchors"])),
           "rpn": rc.RPNConfig(**known(rc.RPNConfig, model["rpn"])),
           "roi": rc.ROIConfig(**known(rc.ROIConfig, model["roi"])),
           "input": rc.InputConfig(**known(rc.InputConfig, model["input"]))}
    if hasattr(rc, "ViTConfig"):
        out["vit"] = rc.ViTConfig(**_tuples(model["vit"]))
    return rc.ModelConfig(**out)


class RefTrackerViTDet(RefTracker):
    """:class:`~benchkit.refmodel.RefTracker` on the ViTDet model; the same calls."""

    def __init__(self, model: dict, tracker: dict, ckpt: dict, assoc: dict, orig_hw, camera: dict, device,
                 tf32: bool = False):
        self.device = device
        self.tf32 = tf32
        self.cfg = model_config_vitdet(model)
        self.tcfg = tracker_config(tracker)
        self.orig_hw = tuple(orig_hw)
        inp = model["input"]
        if inp["format"] != "RGB" or inp["square_size"] != model["vit"]["img_size"]:
            raise ValueError("the ViTDet reference takes RGB images padded to the ViT's square")
        heads = {"rpn_num_conv": model["rpn"]["num_conv"], "num_box_conv": model["roi"]["num_box_conv"]}
        self.model = MaskRCNNViTDet(self.cfg, model["vit"], heads).eval().requires_grad_(False)
        load_detectron2(self.model, ckpt)
        self.model.to(device)
        self.head = AssociationHead(self.cfg.fpn_channels * self.tcfg.roi_size ** 2, self.tcfg.embedding_dim)
        self.head.load_state_dict({k: torch.as_tensor(v) for k, v in assoc.items()})
        self.head = self.head.eval().requires_grad_(False).to(device)
        _, self.net_hw = resize_target(self.orig_hw, inp["min_size_test"], inp["max_size_test"],
                                       inp["pad_divisibility"])
        self.pad_hw = self.net_hw  # the model's input: the resized image, which the model pads itself
        (oh, ow), (nh, nw) = self.orig_hw, self.net_hw
        self.mats = tuple(torch.from_numpy(linear_resize_matrix(n, m)).to(device) for n, m in ((oh, nh), (ow, nw)))
        self.box_scale = torch.tensor([ow / nw, oh / nh, ow / nw, oh / nh], dtype=torch.float32, device=device)
        self.pre = Preprocessor(camera["mtx"], camera["dist"], (ow, oh), device=device)
        self.reset()

    @torch.no_grad()
    def resize(self, frames: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) u8 BGR -> (B, h, w, 3) f32 RGB, resized, not padded."""
        with precision(self.tf32):
            return resize_frames_matmul(frames[..., [2, 1, 0]], *self.mats)
