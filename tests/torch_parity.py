"""Helpers for the port's parity tests: one proposal slot through the
candidate stage, with the coarse corners exchangeable between the two
packages.

The candidate stage's corner refinement is not continuous in its start: a
gradient-peak argmax per edge sample decides which taps a line fit uses.
The coarse corners come from atan2/sin/cos and long sums, which the two
libraries round differently in the last bit, so a 1-ulp difference there can
move a refined corner by tenths of a pixel in either package.  These helpers
let a test hold the continuous part (coarse corners) and the discontinuous
part (refinement from one and the same start) each to a tight tolerance.

The DCNN helpers at the end build the small Mask R-CNN that the DCNN parity
tests share and load one detectron2-format checkpoint into both packages;
``cost_case`` makes gated-auction problems.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import torch

from apse_uav_tpu.aruco import detector as jdet
from apse_uav_torch.aruco import detector as tdet


def slot_psize(h: int, w: int, k: int) -> int:
    """Patch size of proposal slot k (the static per-scale grouping)."""
    return next(ps for a, b, ps in tdet._patch_groups(h, w, tdet.DetectorParams()) if a <= k < b)


def reference_coarse(gray: np.ndarray, center, size, psize: int):
    """The reference's clockwise coarse corners (4, 2) yx in window coords
    for one slot of the (H, W) gray, and its window (win, win)."""
    p = jdet.DetectorParams()
    center = jnp.asarray(center, jnp.float32)
    patch, origin = jdet._extract_patch(jnp.asarray(gray, jnp.float32), center, psize)
    win, _, _ = jdet._extract_window(patch, center - origin, jnp.float32(size), p.window)
    dark, _, _ = jdet._binarize(win)
    coarse, _ = jdet._coarse_corners(jdet._largest_component(dark, p.window), win, p.window)
    return np.asarray(jdet._order_clockwise(coarse)), win


def port_candidate(gray: np.ndarray, center, size, psize: int, coarse_w: np.ndarray | None = None):
    """The port's candidate stage for one slot, exactly as ``candidates``
    runs it, optionally restarted from the given clockwise coarse corners.

    Returns (corners (4, 2) x,y image coords, decoded id, the clockwise coarse
    corners (4, 2) yx window coords that the refinement started from).
    """
    p = tdet.DetectorParams()
    g = torch.as_tensor(np.asarray(gray, np.float32))[None]
    c = torch.as_tensor(np.asarray(center, np.float32))
    patch, p_origin = tdet._extract_patch(g, c[None, None], psize)
    patch, p_origin = patch.reshape(1, psize, psize), p_origin.reshape(1, 2)
    win, scale, origin = tdet._extract_window(patch, c[None] - p_origin, torch.tensor([float(size)]), p.window)
    dark, _, _ = tdet._binarize(win)
    coarse, _ = tdet._coarse_corners(tdet._largest_component(dark, p.window), win, p.window)
    coarse_w = tdet._order_clockwise(coarse) if coarse_w is None else torch.tensor(np.asarray(coarse_w))[None]
    rough_w, _ = tdet._refine_edges(win, coarse_w, p.edge_points, torch.ones_like(scale), step_scale=1.04, n_taps=11)
    drift0 = torch.linalg.vector_norm(rough_w - coarse_w, dim=-1).amax(dim=-1)
    rough_w = torch.where((drift0 < 6.0)[:, None, None], rough_w, coarse_w)
    rough = origin[:, None, :] + (rough_w + 0.5) * scale[:, None, None]
    refined, _ = tdet._refine_edges(patch, rough, p.edge_points, scale, step_scale=0.8)
    good = torch.linalg.vector_norm(refined - rough, dim=-1).amax(dim=-1) < 6.0
    corners = torch.where(good[:, None, None], refined, rough)
    marker_id, rot, _, _ = tdet._decode_candidate(patch, corners, p)
    corners = torch.roll(corners[0] + p_origin[0], -int(rot[0]), dims=0)
    return corners.flip(-1).numpy(), int(marker_id[0]), coarse_w[0].numpy()


def corner_errors(gray: np.ndarray, center, size, k: int, got: np.ndarray, want: np.ndarray) -> dict:
    """Errors, in px, of the port's corners ``got`` (4, 2) x,y of proposal
    slot k against the reference's ``want``:

    * ``direct``: got against want;
    * ``coarse``: the port's coarse corners against the reference's (window px);
    * ``restarted``: the port restarted from the reference's coarse corners,
      against want;
    * ``replay``: this module's replay of the port's stage against got.
    """
    h, w = gray.shape
    ps = slot_psize(h, w, k)
    coarse_ref, _ = reference_coarse(gray, center, size, ps)
    own, _, coarse_port = port_candidate(gray, center, size, ps)
    restarted, _, _ = port_candidate(gray, center, size, ps, coarse_ref)
    return {"direct": float(np.abs(got - want).max()), "coarse": float(np.abs(coarse_port - coarse_ref).max()),
            "restarted": float(np.abs(restarted - want).max()), "replay": float(np.abs(own - got).max())}


# -- DCNN --------------------------------------------------------------------

# Frames of the tracker's end-to-end tests: (T, H, W, 3) u8 from a seed.
E2E_HW = (100, 160)


def e2e_frames(n: int = 3, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 255, (n, *E2E_HW, 3), np.uint8)


def tiny_dcnn_config(num_classes: int = 2, score_thresh: float = 0.0):
    """The JAX engine tests' small Mask R-CNN R50-FPN: RPN 32 -> 16
    proposals, 4 detections, inputs resized to a 64 short side (max 128)."""
    import dataclasses

    from apse_uav_tpu.dcnn.config import mask_rcnn_r50_fpn

    cfg = mask_rcnn_r50_fpn(num_classes=num_classes)
    return dataclasses.replace(
        cfg,
        rpn=dataclasses.replace(cfg.rpn, pre_nms_topk_test=32, post_nms_topk_test=16, batch_size_per_image=16),
        roi=dataclasses.replace(cfg.roi, num_classes=num_classes, detections_per_image=4,
                                score_thresh_test=score_thresh),
        input=dataclasses.replace(cfg.input, min_size_test=64, max_size_test=128),
    )


def jax_mask_rcnn(cfg, checkpoint: dict):
    """The JAX MaskRCNN and its parameters from a detectron2 checkpoint
    (``map_detectron2_weights`` + ``load_into_params`` on the abstract init
    tree: every parameter must come from the checkpoint)."""
    import jax

    from apse_uav_tpu.dcnn import weights as W
    from apse_uav_tpu.dcnn.models.mask_rcnn import MaskRCNN

    model = MaskRCNN(cfg=cfg)
    abstract = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), mode="inference"))["params"]
    params, missing, unused = W.load_into_params(abstract, W.map_detectron2_weights(checkpoint, cfg.depth,
                                                                                     cfg.mask_on))
    assert not missing and not unused, (missing[:3], unused[:3])
    return model, params


def port_config(jcfg):
    """The port's config of a JAX one (through ``dataclasses.asdict``)."""
    import dataclasses

    from apse_uav_torch import convert

    return convert.model_config(dataclasses.asdict(jcfg))


def c4_config(depth: int = 26, num_classes: int = 3):
    """The JAX C4 tests' small Mask R-CNN R-C4: RPN 64 -> 16 proposals, 4
    detections; training budgets 64 -> 16 proposals, 16 / 8 samples."""
    import dataclasses

    from apse_uav_tpu.dcnn.config import mask_rcnn_r50_c4

    cfg = mask_rcnn_r50_c4(num_classes=num_classes)
    return dataclasses.replace(
        cfg, depth=depth,
        rpn=dataclasses.replace(cfg.rpn, pre_nms_topk_test=64, post_nms_topk_test=16, pre_nms_topk_train=64,
                                post_nms_topk_train=16, batch_size_per_image=16),
        roi=dataclasses.replace(cfg.roi, detections_per_image=4, batch_size_per_image=8))


def jax_c4(cfg, checkpoint: dict):
    """The JAX MaskRCNNC4 and its parameters from a detectron2 C4 checkpoint
    (``map_detectron2_weights_c4`` + ``load_into_params``: every parameter
    from the checkpoint).  The reference's mapper knows depths 50 and 101;
    for the depth-26 trunk of these tests its block table gains that entry
    for the call."""
    import jax

    from apse_uav_tpu.dcnn import weights as W
    from apse_uav_tpu.dcnn.models.c4 import MaskRCNNC4
    from apse_uav_torch.dcnn.models.resnet import STAGE_BLOCKS

    model = MaskRCNNC4(cfg=cfg)
    abstract = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), mode="inference"))["params"]
    added = cfg.depth not in W._STAGE_BLOCKS
    if added:
        W._STAGE_BLOCKS[cfg.depth] = STAGE_BLOCKS[cfg.depth]
    try:
        flat = W.map_detectron2_weights_c4(checkpoint, cfg.depth, cfg.mask_on)
    finally:
        if added:
            del W._STAGE_BLOCKS[cfg.depth]
    params, missing, unused = W.load_into_params(abstract, flat)
    assert not missing and not unused, (missing[:3], unused[:3])
    return model, params


COST_CASES = ("random", "ties", "invalid", "contested")


def cost_case(kind: str, rng, r: int = 12, c: int = 10):
    """A gated-auction problem (cost (r, c), row_valid, col_valid) of one of
    COST_CASES: random costs, exact ties (float64), invalid rows and columns,
    crowded columns."""
    cost = rng.uniform(0, 1.2, (r, c)).astype(np.float32)
    rv, cv = np.ones(r, bool), np.ones(c, bool)
    if kind == "ties":
        cost = np.round(cost * 3) / 3  # exact ties between columns and rows
    if kind == "invalid":
        rv[rng.uniform(size=r) < 0.3] = False
        cv[rng.uniform(size=c) < 0.3] = False
    if kind == "contested":  # every row prefers the same few columns
        cost = (rng.uniform(0, 0.05, (r, c)) + np.arange(c)[None, :] * 0.1).astype(np.float32)
    return cost, rv, cv
