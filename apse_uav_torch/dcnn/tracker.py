"""Tracker step: re-ID embeddings, association, track update.

Counterpart of the JAX reference's ``dcnn/tracker.py``.  Its association
metrics (``TrackerConfig.association_metric``):

* ``embeddings`` (default): mask-cropped p2 features -> ROIAlign (10x10,
  sampling ratio 4, aligned=False) -> AssociationHead -> squared-L2 distance
  matrix -> gated auction (threshold 0.6; one kernel launch a frame on the
  card, ``cuda_auction``), or with ``exact=True`` the
  Jonker-Volgenant solve of the padded square problem, then the gate;
* ``bbox_center_dist``: the nearest active track by squared box-centre
  distance, below the threshold;
* ``mask_iou``: the active track of highest centroid-aligned mask IoU on a
  64x64 pasted grid, at least the threshold.

Unmatched detections become new tracks.  Where two detections match one
track, the later detection's fields land (the reference's scatter, where the
last write wins).

The stateless half (:func:`prepare_frame`: top-k cap + embeddings) takes a
batch of frames at once; only :func:`tracker_step_assoc` carries state from
frame to frame.  Scatters that the reference drops at the sentinel index
``cap`` land in a spare row that is then dropped.
"""

from __future__ import annotations

import torch

from apse_uav_torch.dcnn import cuda_auction, structures
from apse_uav_torch.dcnn.config import TrackerConfig
from apse_uav_torch.dcnn.hungarian import _BIG, linear_sum_assignment, pad_cost, set_at
from apse_uav_torch.dcnn.models.association import AssociationHead
from apse_uav_torch.dcnn.ops.nms import descending_order
from apse_uav_torch.dcnn.ops.roi_align import sample_grid
from apse_uav_torch.utils import profiling


# Gating pad of the argmin metrics: "farther than anything real" (the
# reference's _FAR_SQ; the exact solver pads with hungarian._BIG instead).
_FAR_SQ = 1e7


def paste_mask_lowres(mask_rr: torch.Tensor, boxes: torch.Tensor, grid_hw: tuple[int, int],
                      image_hw: tuple[int, int]) -> torch.Tensor:
    """Paste (..., R, R) box-space masks onto a (gh, gw) grid over the whole
    image: (..., gh, gw), the nearest mask cell of each grid cell's centre, 0
    outside the box band.  boxes (..., 4) in ``image_hw`` coordinates."""
    gh, gw = grid_hw
    r = mask_rr.shape[-1]
    dev = mask_rr.device
    lead = mask_rr.shape[:-2]
    m = mask_rr.reshape(-1, r, r)
    b = boxes.reshape(-1, 4)
    x1, y1, x2, y2 = (b[:, i : i + 1] for i in range(4))
    xs = ((torch.arange(gw, device=dev) + 0.5) * (image_hw[1] / gw) - x1) / torch.clamp(x2 - x1, min=1e-4) * r - 0.5
    ys = ((torch.arange(gh, device=dev) + 0.5) * (image_hw[0] / gh) - y1) / torch.clamp(y2 - y1, min=1e-4) * r - 0.5
    xi = torch.round(xs).to(torch.int64).clamp(0, r - 1)
    yi = torch.round(ys).to(torch.int64).clamp(0, r - 1)
    inside = ((xs > -1) & (xs < r))[:, None, :] & ((ys > -1) & (ys < r))[:, :, None]
    vals = m[torch.arange(m.shape[0], device=dev)[:, None, None], yi[:, :, None], xi[:, None, :]]
    return torch.where(inside, vals, torch.zeros((), device=dev)).reshape(*lead, gh, gw)


def _mask_plane_patch(mask_rr: torch.Tensor, boxes: torch.Tensor, anchor_yx, patch_hw: tuple[int, int],
                      image_hw: tuple[int, int], feat_hw: tuple[int, int]) -> torch.Tensor:
    """Paste (N, R, R) box-space masks onto feature-resolution patches:
    (N, ph, pw), the patch rows and columns being the global texels
    anchor + arange(P) (nearest mask cell, 0 outside the box band)."""
    ph, pw = patch_hw
    sy = image_hw[0] / feat_hw[0]
    sx = image_hw[1] / feat_hw[1]
    r = mask_rr.shape[-1]
    dev = mask_rr.device
    x1, y1, x2, y2 = (boxes[:, i : i + 1] for i in range(4))
    gx = (anchor_yx[1][:, None] + torch.arange(pw, device=dev)).to(torch.float32)
    gy = (anchor_yx[0][:, None] + torch.arange(ph, device=dev)).to(torch.float32)
    xs = ((gx + 0.5) * sx - x1) / torch.clamp(x2 - x1, min=1e-4) * r - 0.5
    ys = ((gy + 0.5) * sy - y1) / torch.clamp(y2 - y1, min=1e-4) * r - 0.5
    xi = torch.round(xs).to(torch.int64).clamp(0, r - 1)
    yi = torch.round(ys).to(torch.int64).clamp(0, r - 1)
    inside = ((xs > -1) & (xs < r))[:, None, :] & ((ys > -1) & (ys < r))[:, :, None]
    n = mask_rr.shape[0]
    vals = mask_rr[torch.arange(n, device=dev)[:, None, None], yi[:, :, None], xi[:, None, :]]
    return torch.where(inside, vals, torch.zeros((), device=dev))


def detection_embeddings(head: AssociationHead, feats_p2: torch.Tensor, det: dict, image_hw: tuple[int, int],
                         roi_size: int = 10, crop_features: bool = True, sampling_ratio: int = 4,
                         patch: int = 48) -> torch.Tensor:
    """Re-ID embeddings of a batch of frames' detections.

    feats_p2 (B, H4, W4, C) NHWC; det["boxes"] (B, D, 4) in ``image_hw``
    coordinates, det["masks"] (B, D, R, R).  Returns (B, D, embedding_dim).

    The mask-cropped ROIAlign of each detection is taken on one (P, P) patch
    of p2 as two interpolation matrix products (hat-function weights of the
    clipped sample coordinates), the reference's formulation: exact for
    boxes up to patch - 2 texels of p2; larger boxes clamp their samples to
    the patch.  The products are float32 (no TF32; see ``engines.full_fp32``).
    """
    nb, d = det["boxes"].shape[:2]
    h4, w4, c = feats_p2.shape[1:]
    dev = feats_p2.device
    spatial_scale = w4 / image_hw[1]
    s = max(int(sampling_ratio), 1)
    n = roi_size * s
    py, px = min(patch, h4), min(patch, w4)
    boxes = det["boxes"].reshape(nb * d, 4)
    x1, y1, x2, y2 = (boxes[:, i] * spatial_scale for i in range(4))
    rw = torch.clamp(x2 - x1, min=1.0)  # aligned=False: ROIs are at least 1 texel
    rh = torch.clamp(y2 - y1, min=1.0)
    grid = sample_grid(roi_size, s, dev)
    ys = y1[:, None] + grid * (rh / roi_size)[:, None]  # (N, n)
    xs = x1[:, None] + grid * (rw / roi_size)[:, None]
    oor_y = (ys < -1.0) | (ys > h4 * 1.0)  # torchvision border band
    oor_x = (xs < -1.0) | (xs > w4 * 1.0)
    ysc = ys.clamp(0.0, h4 - 1.0)
    xsc = xs.clamp(0.0, w4 - 1.0)
    ay = torch.floor(ysc[:, 0]).to(torch.int64).clamp(0, h4 - py)
    ax = torch.floor(xsc[:, 0]).to(torch.int64).clamp(0, w4 - px)
    yloc = (ysc - ay[:, None].to(torch.float32)).clamp(0.0, py - 1.0)
    xloc = (xsc - ax[:, None].to(torch.float32)).clamp(0.0, px - 1.0)
    taps_y = torch.arange(py, dtype=torch.float32, device=dev)
    taps_x = torch.arange(px, dtype=torch.float32, device=dev)
    wy = torch.clamp(1.0 - (yloc[:, :, None] - taps_y).abs(), min=0.0)
    wx = torch.clamp(1.0 - (xloc[:, :, None] - taps_x).abs(), min=0.0)
    wy = torch.where(oor_y[:, :, None], torch.zeros((), device=dev), wy)  # (N, n, py)
    wx = torch.where(oor_x[:, :, None], torch.zeros((), device=dev), wx)  # (N, n, px)
    frame = torch.arange(nb, device=dev)[:, None].expand(nb, d).reshape(-1)
    rows = ay[:, None] + torch.arange(py, device=dev)
    cols = ax[:, None] + torch.arange(px, device=dev)
    pt = feats_p2[frame[:, None, None], rows[:, :, None], cols[:, None, :]]  # (N, py, px, C)
    if crop_features:
        masks = det["masks"].reshape(nb * d, *det["masks"].shape[2:])
        plane = _mask_plane_patch(masks, boxes, (ay, ax), (py, px), image_hw, (h4, w4))
        pt = pt * plane[..., None]
    pt = pt.to(torch.float32)  # bf16 maps and masks meet the float32 weights: float32 products
    sampled = torch.matmul(wy, pt.reshape(nb * d, py, px * c)).reshape(nb * d, n, px, c)  # (N, s, q, C)
    sampled = torch.matmul(sampled.permute(0, 1, 3, 2), wx.transpose(1, 2)[:, None])  # (N, s, C, t)
    vals = sampled.reshape(nb * d, roi_size, s, c, roi_size, s).mean(dim=(2, 5))  # (N, R, C, R)
    return head(vals.permute(0, 2, 1, 3)).reshape(nb, d, -1)


def _allocate_new_tracks(state: dict, det: dict, embeddings: torch.Tensor, is_new: torch.Tensor) -> dict:
    """Unmatched detections take free slots (k-th new detection in index
    order, k-th free slot) with fresh increasing ids."""
    free = ~state["active"]
    cap = free.shape[0]
    dev = free.device
    new_rank = torch.cumsum(is_new.to(torch.int64), 0) - 1
    free_slots = torch.cumsum(free.to(torch.int64), 0) - 1
    slot_of_rank = set_at(torch.full((cap,), cap, dtype=torch.int64, device=dev),
                           torch.where(free, free_slots, cap), torch.arange(cap, device=dev))
    can_place = is_new & (new_rank < free.sum())
    slot = torch.where(can_place, slot_of_rank[new_rank.clamp(0, cap - 1)], cap)
    new_ids = state["next_id"] + new_rank.to(torch.int32)
    ones = torch.ones_like(can_place)
    return {
        **state,
        "active": set_at(state["active"], slot, ones),
        "ids": set_at(state["ids"], slot, new_ids),
        "detected_this_frame": set_at(state["detected_this_frame"], slot, ones),
        "frames_since_detected": set_at(state["frames_since_detected"], slot, torch.zeros_like(new_ids)),
        "boxes": set_at(state["boxes"], slot, det["boxes"]),
        "scores": set_at(state["scores"], slot, det["scores"]),
        "classes": set_at(state["classes"], slot, det["classes"].to(torch.int32)),
        "masks": set_at(state["masks"], slot, det["masks"]),
        "embeddings": set_at(state["embeddings"], slot, embeddings),
        "next_id": state["next_id"] + can_place.sum().to(torch.int32),
    }


def _apply_matches(state: dict, det: dict, embeddings: torch.Tensor, track_for_det: torch.Tensor,
                   is_matched: torch.Tensor) -> dict:
    """Overwrite matched tracks with their detections; of two detections
    matched to one track, the later one's fields land."""
    cap = state["active"].shape[0]
    idx = torch.where(is_matched, track_for_det, cap)
    order = torch.arange(idx.shape[0], device=idx.device)
    overwritten = ((idx[:, None] == idx[None, :]) & (order[None, :] > order[:, None])).any(dim=1)
    idx = torch.where(overwritten, cap, idx)
    return {
        **state,
        "detected_this_frame": set_at(state["detected_this_frame"], idx, torch.ones_like(is_matched)),
        "frames_since_detected": set_at(state["frames_since_detected"], idx,
                                         torch.zeros(idx.shape, dtype=torch.int32, device=idx.device)),
        "boxes": set_at(state["boxes"], idx, det["boxes"]),
        "scores": set_at(state["scores"], idx, det["scores"]),
        "classes": set_at(state["classes"], idx, det["classes"].to(torch.int32)),
        "masks": set_at(state["masks"], idx, det["masks"]),
        "embeddings": set_at(state["embeddings"], idx, embeddings),
    }


def associate_embeddings(state: dict, det: dict, embeddings: torch.Tensor, threshold: float,
                         exact: bool = False) -> dict:
    """Association on squared-L2 embedding distances, then new tracks for the
    unmatched detections (one frame: det fields (D, ...)).  The default
    solver is the gated auction (``cuda_auction``: the kernel on the card,
    the plain version on the CPU); ``exact=True`` pads the problem to square
    with the solver's pad (``_BIG``, not ``_FAR_SQ``: float32 keeps sub-unit
    resolution there), solves it with Jonker-Volgenant and gates the pairs."""
    cap = state["active"].shape[0]
    d_cap = embeddings.shape[0]
    dev = embeddings.device
    diffs = state["embeddings"][:, None, :] - embeddings[None, :, :]
    dist = torch.sum(diffs * diffs, dim=-1)  # (T, D)
    if exact:
        n = max(cap, d_cap)
        cost = torch.full((n, n), _BIG, device=dev)
        cost[:cap, :d_cap] = pad_cost(dist, state["active"], det["valid"])
        det_for_track = linear_sum_assignment(cost)[1][:cap]
    else:
        det_for_track = cuda_auction.gated_auction_match(dist, state["active"], det["valid"], threshold)
        det_for_track = torch.where(det_for_track < 0, d_cap, det_for_track)
    clipped = det_for_track.clamp(0, d_cap - 1)
    ok = state["active"] & (det_for_track < d_cap) & det["valid"][clipped]
    ok &= dist[torch.arange(cap, device=dev), clipped] < threshold
    track_for_det = set_at(torch.full((d_cap,), cap, dtype=torch.int64, device=dev),
                            torch.where(ok, clipped, d_cap), torch.arange(cap, device=dev))
    is_matched = det["valid"] & (track_for_det < cap)
    state = _apply_matches(state, det, embeddings, track_for_det, is_matched)
    return _allocate_new_tracks(state, det, embeddings, det["valid"] & ~is_matched)


def associate_center_dist(state: dict, det: dict, embeddings: torch.Tensor, threshold_sq: float) -> dict:
    """Each detection to the nearest active track by squared box-centre
    distance (lower track index on ties) if below ``threshold_sq``."""
    cap = state["active"].shape[0]
    det_c = (det["boxes"][:, :2] + det["boxes"][:, 2:]) / 2.0
    trk_c = (state["boxes"][:, :2] + state["boxes"][:, 2:]) / 2.0
    d2 = torch.sum((trk_c[:, None] - det_c[None]) ** 2, dim=-1)  # (T, D)
    d2 = torch.where(state["active"][:, None], d2, torch.full((), _FAR_SQ, device=d2.device))
    nearest = torch.argmin(d2, dim=0)
    is_matched = det["valid"] & (d2.gather(0, nearest[None])[0] < threshold_sq)
    track_for_det = torch.where(is_matched, nearest, cap)
    state = _apply_matches(state, det, embeddings, track_for_det, is_matched)
    return _allocate_new_tracks(state, det, embeddings, det["valid"] & ~is_matched)


def _centroids(m: torch.Tensor) -> torch.Tensor:
    """(N, g, g) bool -> (N, 2) float32 (y, x) mean cell, (0, 0) for an empty mask."""
    g = m.shape[-1]
    ar = torch.arange(g, device=m.device)
    tot = m.sum(dim=(1, 2)).clamp(min=1)
    ys = (m.sum(dim=2) * ar).sum(dim=1) / tot
    xs = (m.sum(dim=1) * ar).sum(dim=1) / tot
    return torch.stack([ys, xs], dim=-1).to(torch.float32)


def associate_mask_iou(state: dict, det: dict, embeddings: torch.Tensor, threshold: float,
                       image_hw: tuple[int, int], grid: int = 64) -> dict:
    """Each detection to the active track of highest centroid-aligned mask
    IoU (lower track index on ties) if at least ``threshold``: both masks
    pasted on a (grid, grid) image grid at 0.5, the detection's rolled
    (cyclically, ``jnp.roll``) by the rounded centroid offset."""
    cap = state["active"].shape[0]
    dev = embeddings.device
    det_m = paste_mask_lowres(det["masks"], det["boxes"], (grid, grid), image_hw) > 0.5  # (D, g, g)
    trk_m = paste_mask_lowres(state["masks"], state["boxes"], (grid, grid), image_hw) > 0.5  # (T, g, g)
    shift = torch.round(_centroids(trk_m)[:, None] - _centroids(det_m)[None]).to(torch.int64)  # (T, D, 2)
    ar = torch.arange(grid, device=dev)
    ry = (ar - shift[..., 0:1]) % grid  # (T, D, g): the source row of each rolled row
    rx = (ar - shift[..., 1:2]) % grid
    d_idx = torch.arange(det_m.shape[0], device=dev)[None, :, None, None]
    rolled = det_m[d_idx, ry[..., :, None], rx[..., None, :]]  # (T, D, g, g)
    inter = (rolled & trk_m[:, None]).sum(dim=(2, 3))
    union = (rolled | trk_m[:, None]).sum(dim=(2, 3)).clamp(min=1)
    iou = torch.where(state["active"][:, None], inter / union, torch.full((), -1.0, device=dev))
    best = torch.argmax(iou, dim=0)
    is_matched = det["valid"] & (iou.gather(0, best[None])[0] >= threshold)
    track_for_det = torch.where(is_matched, best, cap)
    state = _apply_matches(state, det, embeddings, track_for_det, is_matched)
    return _allocate_new_tracks(state, det, embeddings, det["valid"] & ~is_matched)


def prepare_frame(det: dict, feats_p2: torch.Tensor, head: AssociationHead, cfg: TrackerConfig,
                  image_hw: tuple[int, int]):
    """The stateless half of a tracker step for a batch of frames: cap the
    detections at the ``max_detections`` best scores (the reference's
    ``top_k`` order) and embed them.  det fields (B, D, ...), feats_p2 (B, H4,
    W4, C); returns (det (B, D', ...), embeddings (B, D', E))."""
    d_cap = det["valid"].shape[1]
    if d_cap > cfg.max_detections:
        neg_inf = torch.full((), float("-inf"), device=det["scores"].device)
        top = descending_order(torch.where(det["valid"], det["scores"], neg_inf))[:, : cfg.max_detections]
        frames = torch.arange(top.shape[0], device=top.device)[:, None]
        det = {key: v[frames, top] for key, v in det.items()}
    return det, detection_embeddings(head, feats_p2, det, image_hw, cfg.roi_size)


def tracker_step(state: dict, det: dict, feats_p2: torch.Tensor, head: AssociationHead, cfg: TrackerConfig,
                 image_hw: tuple[int, int]):
    """One frame (``RcnnTracker.next_frame``): cap and embed the detections
    (:func:`prepare_frame`), then associate, prune, snapshot and age
    (:func:`tracker_step_assoc`).  det fields (D, ...), feats_p2 (H4, W4, C);
    returns (new_state, recent_objects)."""
    det, emb = prepare_frame({k: v[None] for k, v in det.items()}, feats_p2[None], head, cfg, image_hw)
    return tracker_step_assoc(state, {k: v[0] for k, v in det.items()}, emb[0], cfg, image_hw)


def tracker_step_assoc(state: dict, det: dict, emb: torch.Tensor, cfg: TrackerConfig,
                       image_hw: tuple[int, int]):
    """The state-carrying half of a tracker step (one frame): associate by
    ``cfg.association_metric``, prune, snapshot, age.  Returns (new_state,
    recent_objects)."""
    if cfg.association_metric == "embeddings":
        state = associate_embeddings(state, det, emb, cfg.embedding_dist_threshold)
    elif cfg.association_metric == "bbox_center_dist":
        state = associate_center_dist(state, det, emb, cfg.center_dist_threshold)
    elif cfg.association_metric == "mask_iou":
        state = associate_mask_iou(state, det, emb, cfg.mask_iou_threshold, image_hw)
    else:
        raise ValueError(cfg.association_metric)
    state = structures.delete_undetected(state, cfg.delete_after_undetected)
    recent = structures.recent_objects(state)
    return structures.finish_association(state), recent


def associate_frames(state: dict, det: dict, emb: torch.Tensor, cfg: TrackerConfig, image_hw: tuple[int, int]):
    """:func:`tracker_step_assoc` over a batch of frames in order; returns
    (state, recent objects stacked (B, ...))."""
    recents = []
    for t in range(emb.shape[0]):
        with profiling.span("track.assoc_step"):
            state, recent = tracker_step_assoc(state, {k: v[t] for k, v in det.items()}, emb[t], cfg, image_hw)
        recents.append(recent)
    return state, {k: torch.stack([r[k] for r in recents]) for k in recents[0]}
