"""The plain reference of the C4 tracker: ``refmodel.RefTracker`` with Mask
R-CNN R-C4 (``refplain.dcnn.models.c4``) in place of R-FPN, and the re-ID
embeddings read from the trunk's res2.

C4 has no pyramid, so there is no p2.  res2 is the trunk's map of p2's
stride (4) and width (256): the association head keeps its 256 x 10 x 10
inputs, and a 4.0 x 2.2 m roof at 40 m stays ~30 x 16 texels (on res4 it
would be ~7 x 4).  The reference tracker has no C4 path; this is the
measured program's rule (``engines.reid_map``), written here independently.
"""

from __future__ import annotations

import dataclasses

import torch

from benchkit.refmodel import (RefTracker, linear_resize_matrix, model_config, precision, resize_target,
                               tracker_config)
from refplain.dcnn import config as rc, structures, tracker as rtracker
from refplain.dcnn.models.association import AssociationHead
from refplain.dcnn.models.c4 import MaskRCNNC4
from refplain.dcnn.weights import load_detectron2
from refplain.preproc.remap import Preprocessor

REID_MAP, REID_CHANNELS = "res2", 256


def model_config_c4(model: dict, rc=rc):
    """The ModelConfig of the config module ``rc`` (the reference's or the
    measured package's) from a C4 configuration file's ``model``: every
    anchor size on the one res4 level, so ``anchors.sizes`` is a tuple of
    one tuple."""
    cfg = model_config(model, rc)
    sizes = tuple(tuple(s) if isinstance(s, list) else s for s in model["anchors"]["sizes"])
    return dataclasses.replace(cfg, anchors=dataclasses.replace(cfg.anchors, sizes=sizes))


class RefTrackerC4(RefTracker):
    """:class:`~benchkit.refmodel.RefTracker` on the C4 model; the same calls."""

    def __init__(self, model: dict, tracker: dict, ckpt: dict, assoc: dict, orig_hw, camera: dict, device,
                 tf32: bool = False):
        self.device = device
        self.tf32 = tf32
        self.cfg = model_config_c4(model)
        self.tcfg = tracker_config(tracker)
        self.orig_hw = tuple(orig_hw)
        self.model = MaskRCNNC4(self.cfg).eval().requires_grad_(False)
        load_detectron2(self.model, ckpt)
        self.model.to(device)
        self.head = AssociationHead(REID_CHANNELS * self.tcfg.roi_size ** 2, self.tcfg.embedding_dim)
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
        """An empty track state whose masks are C4's (2 x the mask pooler's side: 14)."""
        self.state = structures.init_track_state(self.tcfg.max_tracks, self.tcfg.embedding_dim,
                                                 2 * self.cfg.roi.mask_pooler_resolution, device=self.device)

    @torch.no_grad()
    def embed(self, dets: dict, feats: dict):
        with precision(self.tf32):
            return rtracker.prepare_frame(dets, feats[REID_MAP], self.head, self.tcfg, self.orig_hw)
