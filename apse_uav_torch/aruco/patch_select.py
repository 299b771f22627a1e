"""Candidate-driven tile selection for the two-pass preprocessing.

Counterpart of the JAX reference's ``aruco/patch_select.py``: every valid
candidate demands the (th, tw)-tile rectangle covering its patch (the exact
``_extract_patch`` clamp arithmetic); tiles are ranked by the best per-scale
rank of any candidate demanding them (tile id breaks ties) and a fixed
budget keeps the best ``t_sel``.  Candidates whose patch is not fully
covered are reported uncovered and invalidated before decoding.  The tile
grid is :func:`apse_uav_torch.preproc.remap.pick_tiles` of the full frame,
so both packages drop the same candidates when the budget overflows.
"""

from __future__ import annotations

import torch


def select_tiles(centers: torch.Tensor, valid: torch.Tensor, *, h: int, w: int, th: int, tw: int, groups: tuple,
                 t_sel: int, per_scale_k: int):
    """One frame: centers (K, 2) f32 yx, valid (K,) bool -> sel
    (min(t_sel, n_tiles),) int32, covered (K,) bool (see :func:`select_tiles_batched`)."""
    sel, covered = select_tiles_batched(centers[None], valid[None], h=h, w=w, th=th, tw=tw, groups=groups,
                                        t_sel=t_sel, per_scale_k=per_scale_k)
    return sel[0], covered[0]


def select_tiles_batched(centers: torch.Tensor, valid: torch.Tensor, *, h: int, w: int, th: int, tw: int,
                         groups: tuple, t_sel: int, per_scale_k: int):
    """centers (B, K, 2) f32 yx, valid (B, K) bool ->
    sel (B, min(t_sel, n_tiles)) int32 tile ids (ty * ntx + tx; -1 padding),
    covered (B, K) bool."""
    nty, ntx = h // th, w // tw
    n_tiles = nty * ntx
    t_sel = min(t_sel, n_tiles)
    bsz, k = valid.shape
    dev = centers.device
    psize = torch.zeros(k, dtype=torch.int64)
    for a, b, ps in groups:
        psize[a:b] = ps
    psize = psize.to(dev)
    prio = torch.arange(k, device=dev) % per_scale_k

    cy = torch.round(centers[..., 0]).to(torch.int64)
    cx = torch.round(centers[..., 1]).to(torch.int64)
    oy = torch.minimum(torch.clamp(cy - psize // 2, min=0), h - psize)
    ox = torch.minimum(torch.clamp(cx - psize // 2, min=0), w - psize)
    ty0, ty1 = oy // th, (oy + psize - 1) // th
    tx0, tx1 = ox // tw, (ox + psize - 1) // tw

    tty = torch.arange(nty, device=dev)
    ttx = torch.arange(ntx, device=dev)
    in_y = (tty >= ty0[..., None]) & (tty <= ty1[..., None])  # (B, K, nty)
    in_x = (ttx >= tx0[..., None]) & (ttx <= tx1[..., None])  # (B, K, ntx)
    demand = in_y[..., :, None] & in_x[..., None, :] & valid[..., None, None]  # (B, K, nty, ntx)

    big = per_scale_k
    prio_t = torch.where(demand, prio[:, None, None], torch.full_like(prio[:, None, None], big)).amin(dim=1)
    prio_t = prio_t.reshape(bsz, n_tiles)
    demanded = prio_t < big
    tid = torch.arange(n_tiles, device=dev)
    # Unique integer score, higher = keep.
    score = torch.where(demanded, (big - prio_t) * n_tiles + (n_tiles - 1 - tid), torch.full_like(prio_t, -1))
    top_v, top_i = torch.topk(score, t_sel, dim=1)  # scores are unique (or -1): order is determined
    sel = torch.where(top_v >= 0, top_i, torch.full_like(top_i, -1)).to(torch.int32)
    kth = torch.clamp(top_v[:, -1:], min=0)
    tile_sel = (score >= kth) & (score >= 0)  # (B, n_tiles)
    missing = demand.reshape(bsz, k, n_tiles) & ~tile_sel[:, None, :]
    covered = valid & ~missing.any(dim=2)
    return sel, covered
