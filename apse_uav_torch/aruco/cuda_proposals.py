"""Wrapper of kernel K2 (``csrc/proposals.cu``): multi-scale proposal scoring.

Replaces the JAX reference's ``aruco/pallas_proposals.py``
(``proposals_batched_from_pool``).  On a CPU tensor it runs the plain
version, :func:`apse_uav_torch.aruco.detector._proposals_from_pool`; on a
CUDA tensor it mean-centres the pool in PyTorch (the plain version's
``pool.mean``, bit for bit) and launches the kernels: the integral image, the
tiles' candidate flags, one fused pass per (tile, frame) over every scale that
keeps the tile's k best after NMS, and the global top-k per scale, which
writes the proposal tuple.
The plain versions of the last two are :func:`tile_topk_plain` and
:func:`select_plain`.  The scale table comes from device tensors built once
per ``(h, w, params, device)``, so a call copies nothing to the card and does
not synchronise.

The kernel has ``decimate=False`` semantics, as the reference's does; it raises
on ``decimate=True`` (:func:`apse_uav_torch.aruco.detector.proposals` runs
that branch in plain PyTorch).

Contract with the plain version: the same valid candidate set per scale,
scores within 5e-4.  Both sum the integral image exactly in float64 and
divide with IEEE divisions, so in practice the scores agree bit for bit;
among equal scores the kernel path orders by flat grid index, the plain path
as the reference's grouped top-k does.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from apse_uav_torch import _build
from apse_uav_torch.aruco.detector import (DetectorParams, _proposals_from_pool, _top_k, candidates_from_scores,
                                           plan_vectors, scale_plans)

NAME = "proposals"
# The fused kernel's tile of the pooled grid (rows, columns); csrc/proposals.cu checks it.
TILE = (32, 64)
MAX_K = 16


@functools.lru_cache(maxsize=16)
def _plan_tensors(h: int, w: int, p: DetectorParams, device: torch.device):
    """The scale ladder on ``device``: (S, 8) i32 sc_in, sc_mid, sc_ring,
    off_in, off_mid, n_y, n_x, r_d; (S, 3) f32 off_px, unit, size; r_max."""
    plans = scale_plans(h, w, p)
    prm = torch.tensor([[e.sc_in, e.sc_mid, e.sc_ring, e.off_in, e.off_mid, e.n_y, e.n_x, e.r_d] for e in plans],
                       dtype=torch.int32, device=device)
    return prm, plan_vectors(plans, device), max(e.r_d for e in plans)


def proposals_from_pool(pool: torch.Tensor, h: int, w: int, p: DetectorParams):
    """pool (B, >=h//st, >=w//st) f32 stride-pooled gray (un-centred) ->
    centers (B, K, 2) yx, sizes (B, K), scores (B, K), valid (B, K)."""
    if pool.dtype != torch.float32 or pool.dim() != 3:
        raise ValueError(f"pool must be (B, h4, w4) float32, got {tuple(pool.shape)} {pool.dtype}")
    if pool.device.type == "cpu":
        return _proposals_from_pool(pool, h, w, p)
    if p.decimate:
        raise ValueError("the proposals kernel has decimate=False semantics; decimate=True runs in plain "
                         "PyTorch (detector.proposals)")
    st = p.proposal_stride
    h4, w4 = h // st, w // st
    k = p.per_scale_k
    if not 1 <= k <= MAX_K:
        raise ValueError(f"per_scale_k {k} beyond the kernel's limit {MAX_K}")
    pool = pool[:, :h4, :w4]
    pool = (pool - pool.mean(dim=(1, 2), keepdim=True)).contiguous()
    dev = pool.device
    prm, fprm, r_max = _plan_tensors(h, w, p, dev)
    ns = prm.shape[0]
    bsz = pool.shape[0]
    n_tiles = -(-h4 // TILE[0]) * -(-w4 // TILE[1])
    f32 = dict(dtype=torch.float32, device=dev)
    acc = torch.empty((bsz, h4, w4), dtype=torch.float64, device=dev)
    ii = torch.empty((bsz, h4 + 1, w4 + 1), **f32)
    flags = torch.empty((bsz, ns, n_tiles), dtype=torch.uint8, device=dev)
    tile_val = torch.empty((bsz, ns, n_tiles * k), **f32)
    tile_idx = torch.empty((bsz, ns, n_tiles * k), dtype=torch.int32, device=dev)
    centers = torch.empty((bsz, ns * k, 2), **f32)
    sizes = torch.empty((bsz, ns * k), **f32)
    scores = torch.empty((bsz, ns * k), **f32)
    valid = torch.empty((bsz, ns * k), dtype=torch.bool, device=dev)
    fn = _build.load("proposals").proposals_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    err = fn(*(_build.ptr(t) for t in (pool, prm, fprm, acc, ii, flags, tile_val, tile_idx, centers, sizes, scores,
                                       valid)),
             bsz, h4, w4, ns, k, r_max, *TILE, float(p.min_white_black_diff), float(p.score_threshold),
             _build.stream_ptr(dev))
    _build.check(err, "proposals kernels")
    _build.count(NAME)
    return centers, sizes, scores, valid


def tile_topk_plain(masked: torch.Tensor, k: int, tile: tuple[int, int] = TILE):
    """Plain version of the fused kernel's output: masked (B, S, h4, w4) NMS
    maps (:func:`apse_uav_torch.aruco.detector.nms_maps`) -> per (frame,
    scale) the k best of every tile, tile by tile in row-major tile order:
    values and flat indices (B, S, n_tiles * k), value descending and flat
    index ascending on ties (a stable sort of the tile's row-major cells);
    (-inf, 2^31 - 1) where a tile has fewer than k cells inside the map."""
    b, ns, h4, w4 = masked.shape
    th, tw = tile
    nty, ntx = -(-h4 // th), -(-w4 // tw)
    pad = (0, ntx * tw - w4, 0, nty * th - h4)
    vals = torch.nn.functional.pad(masked, pad, value=-torch.inf)
    idx = torch.arange(h4 * w4, device=masked.device, dtype=torch.int64).reshape(h4, w4)
    idx = torch.nn.functional.pad(idx, pad, value=2 ** 31 - 1)
    vals = vals.reshape(b, ns, nty, th, ntx, tw).permute(0, 1, 2, 4, 3, 5).reshape(b, ns, nty * ntx, th * tw)
    idx = idx.reshape(nty, th, ntx, tw).permute(0, 2, 1, 3).reshape(nty * ntx, th * tw)
    top_v, pos = _top_k(vals, k)
    top_i = torch.gather(idx.expand(b, ns, -1, -1), -1, pos)
    return top_v.reshape(b, ns, -1), top_i.reshape(b, ns, -1).to(torch.int32)


def select_plain(tile_val: torch.Tensor, tile_idx: torch.Tensor, w4: int, plans, p: DetectorParams):
    """Plain version of the global top-k kernel: the k best per (frame,
    scale) of the tiles' candidates (value descending, flat index ascending:
    two stable sorts), then the proposal tuple (-1 for a missing value)."""
    k = p.per_scale_k
    order = torch.argsort(tile_idx, dim=-1, stable=True)
    v = torch.gather(tile_val, -1, order)
    i = torch.gather(tile_idx, -1, order)
    top = torch.argsort(v, dim=-1, descending=True, stable=True)[..., :k]
    v, i = torch.gather(v, -1, top), torch.gather(i, -1, top).to(torch.int64)
    found = v != -torch.inf
    return candidates_from_scores(torch.where(found, v, -1.0), torch.where(found, i, 0), w4, plans, p)
