"""The plain reference of the X101 tracker: ``refmodel.RefTracker`` with Mask
R-CNN X-FPN (``refplain.dcnn.models.resnext``) in place of R-FPN.

Everything after the trunk (the FPN, the RPN, the heads, the re-ID
embeddings from p2, the association) is R-FPN's.  The reference's frozen
``ModelConfig`` has no group fields: :func:`model_config_x101` leaves them
out of the reference's config and hands them to the model beside it, and
passes them into a config module that has them (the measured package's).
"""

from __future__ import annotations

import dataclasses

import torch

from benchkit.refmodel import RefTracker, linear_resize_matrix, model_config, resize_target, tracker_config
from refplain.dcnn import config as rc
from refplain.dcnn.models.association import AssociationHead
from refplain.dcnn.models.resnext import MaskRCNNX
from refplain.dcnn.weights import load_detectron2
from refplain.preproc.remap import Preprocessor

GROUP_KEYS = ("num_groups", "width_per_group")


def model_config_x101(model: dict, rc=rc):
    """The ModelConfig of the config module ``rc`` from an X101 configuration
    file's ``model``: with the group fields where ``rc``'s ModelConfig has
    them, without them (the reference's) otherwise."""
    fields = {f.name for f in dataclasses.fields(rc.ModelConfig)}
    return model_config({k: v for k, v in model.items() if k in fields}, rc)


class RefTrackerX101(RefTracker):
    """:class:`~benchkit.refmodel.RefTracker` on the X-FPN model; the same calls."""

    def __init__(self, model: dict, tracker: dict, ckpt: dict, assoc: dict, orig_hw, camera: dict, device,
                 tf32: bool = False):
        self.device = device
        self.tf32 = tf32
        self.cfg = model_config_x101(model)
        self.tcfg = tracker_config(tracker)
        self.orig_hw = tuple(orig_hw)
        self.model = MaskRCNNX(self.cfg, *(model[k] for k in GROUP_KEYS)).eval().requires_grad_(False)
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
