"""Wrapper of kernel K2 (``csrc/proposals.cu``): multi-scale proposal scoring.

Replaces the JAX reference's ``aruco/pallas_proposals.py``
(``proposals_batched_from_pool``).  On a CPU tensor it runs the plain
version, :func:`apse_uav_torch.aruco.detector._proposals_from_pool`; on a
CUDA tensor it launches the kernels (integral image, scores, dilation, NMS
+ per-block top-k) and finishes like the reference's XLA epilogue: a global
top-k per scale over the blocks' candidates, centres from ``off_px``.

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

import torch

from apse_uav_torch import _build
from apse_uav_torch.aruco.detector import DetectorParams, _proposals_from_pool, candidates_from_scores, scale_plans

NAME = "proposals"
_SMEM_LIMIT = 48 * 1024


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
    if w4 * 4 > _SMEM_LIMIT or k > 16:
        raise ValueError(f"pooled width {w4} or per_scale_k {k} beyond the kernel's limits")
    pool = pool[:, :h4, :w4]
    pool = (pool - pool.mean(dim=(1, 2), keepdim=True)).contiguous()
    plans = scale_plans(h, w, p)
    ns = len(plans)
    bsz = pool.shape[0]
    dev = pool.device
    prm = torch.tensor([[e.sc_in, e.sc_mid, e.sc_ring, e.off_in, e.off_mid, e.n_y, e.n_x, e.r_d] for e in plans],
                       dtype=torch.int32).to(dev)
    rows = max(1, 8192 // w4)
    n_blocks = -(-h4 // rows)
    acc = torch.empty((bsz, h4, w4), dtype=torch.float64, device=dev)
    ii = torch.empty((bsz, h4 + 1, w4 + 1), dtype=torch.float32, device=dev)
    score = torch.empty((bsz, ns, h4, w4), dtype=torch.float32, device=dev)
    tmp = torch.empty_like(score)
    dil = torch.empty_like(score)
    out_val = torch.empty((bsz, ns, n_blocks * k), dtype=torch.float32, device=dev)
    out_idx = torch.empty((bsz, ns, n_blocks * k), dtype=torch.int32, device=dev)
    lib = _build.load("proposals")
    fn = lib.proposals_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    err = fn(_build.ptr(pool), _build.ptr(prm), _build.ptr(acc), _build.ptr(ii), _build.ptr(score), _build.ptr(tmp), _build.ptr(dil),
             _build.ptr(out_val), _build.ptr(out_idx), bsz, h4, w4, ns, rows, k,
             float(p.min_white_black_diff), float(p.score_threshold), _build.stream_ptr(dev))
    _build.check(err, "proposals kernels")
    _build.count(NAME)
    # Global top-k per scale: value descending, flat index ascending on ties.
    order = torch.argsort(out_idx, dim=-1, stable=True)
    v = torch.gather(out_val, -1, order)
    i = torch.gather(out_idx, -1, order)
    top = torch.argsort(v, dim=-1, descending=True, stable=True)[..., :k]
    return candidates_from_scores(torch.gather(v, -1, top), torch.gather(i, -1, top).to(torch.int64), w4, plans, p)
