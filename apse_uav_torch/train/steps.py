"""Training steps: the detector fine-tune and the association head.

Counterparts of the JAX reference's ``train/steps.py``: a forward, autograd's
backward of the summed loss with respect to the trainable tensors only, and
one update of :class:`~apse_uav_torch.train.optim.SGD` in place.
"""

from __future__ import annotations

import numpy as np
import torch

from apse_uav_torch.dcnn.losses import batch_hard_triplet_loss
from apse_uav_torch.dcnn.models.association import AssociationHead
from apse_uav_torch.dcnn.models.mask_rcnn import MaskRCNN
from apse_uav_torch.train.optim import SGD


def trainable_only(tensors: list[torch.Tensor], all_tensors) -> None:
    """Let autograd track exactly ``tensors`` among ``all_tensors``."""
    keep = {id(t) for t in tensors}
    for t in all_tensors:
        t.requires_grad_(id(t) in keep)


def detector_train_step(model: MaskRCNN, opt: SGD, images: torch.Tensor, gt: dict[str, torch.Tensor],
                        key: np.ndarray, freeze_backbone: bool = False, mark=None, proposals=None,
                        features: dict | None = None, gt_proposals: bool = False,
                        reduce_grads=None) -> dict[str, torch.Tensor]:
    """One SGD step on the full detector loss (finetune_uav.py:231-246).

    Pass ``freeze_backbone=True`` when the optimizer leaves the backbone out
    (the reference regime): the features are computed without autograd, so
    no convolution or ROIAlign backward runs.  Returns the losses and
    ``loss_total`` (tensors on the device; reading them is the caller's sync).
    ``mark(stage)``, if given, is called as each stage ends: the three of
    ``MaskRCNN.losses``, then "backward" and "optimizer".  ``proposals``,
    ``features``, ``gt_proposals``: as ``MaskRCNN.losses`` takes them.
    ``model`` is a MaskRCNN or a MaskRCNNC4, in float32 or the reference's
    bf16 regime (its config's compute dtypes; the parameters, the gradients
    and the update stay float32).  ``reduce_grads(grads, params)``, if
    given, maps the gradients before the update (the data-parallel step's
    mean over ranks, :mod:`apse_uav_torch.parallel.dp`); ``key`` may then be
    the rank's rows of the whole batch's key split.
    """
    losses = model.losses(images, gt, key, gt_proposals=gt_proposals, freeze_backbone=freeze_backbone, mark=mark,
                          proposals=proposals, features=features)
    total = sum(losses.values())
    params = opt.trainable()
    grads = torch.autograd.grad(total, params, allow_unused=True)
    if reduce_grads is not None:
        grads = reduce_grads(grads, params)
    if mark:
        mark("backward")
    opt.step(grads)
    if mark:
        mark("optimizer")
    return {**{k: v.detach() for k, v in losses.items()}, "loss_total": total.detach()}


def association_train_step(head: AssociationHead, opt: SGD, rois: torch.Tensor, labels: torch.Tensor,
                           valid: torch.Tensor, margin: float = 0.2) -> torch.Tensor:
    """One SGD step of batch-hard triplet training (train_association_head.py:102-113)."""
    loss = batch_hard_triplet_loss(labels, head(rois), margin, valid=valid)
    grads = torch.autograd.grad(loss, opt.trainable(), allow_unused=True)
    opt.step(grads)
    return loss.detach()
