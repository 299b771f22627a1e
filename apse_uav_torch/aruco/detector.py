"""Fixed-shape ArUco detector in PyTorch (proposals + candidate stage).

Counterpart of the JAX reference's ``aruco/detector.py``.  Everything is
batched: frames on a leading ``B`` axis, candidates on a ``(B, K)`` slot
grid, so the whole candidate stage is a fixed sequence of tensor ops
whatever the data.

* :func:`_proposals_from_pool` with ``decimate=False`` (the shipped setting)
  is the plain version of kernel K2 (``csrc/proposals.cu`` via
  :mod:`.cuda_proposals`).  With ``decimate=True`` it scores the larger scales
  on a mean pyramid, as the reference does in XLA; no kernel implements that
  branch, so :func:`proposals` runs it in plain PyTorch on every device.
* :func:`_label_sweeps` is the plain version of kernel K1
  (``csrc/labeling.cu`` via :mod:`.cuda_labeling`).

The JAX code samples patches through hat-function matmuls (a TPU idiom that
avoids gathers); here sampling is a direct bilinear gather with the same
hat weights, row blend first, then columns -- the same arithmetic up to the
summation order inside a matmul.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from apse_uav_torch.aruco import dictionary as dict_mod
from apse_uav_torch.core.ops import div_const
from apse_uav_torch.device import resolve_device

_SQRT2 = 1.41421356


@dataclasses.dataclass(frozen=True)
class DetectorParams:
    """Tuned to mirror the reference's detector configuration (see the JAX
    counterpart for the reasoning behind each value)."""

    per_scale_k: int = 6
    min_marker_perimeter_rate: float = 0.01
    max_line_fit_mse: float = 1.5
    scales: tuple = (8, 12, 16, 20, 28, 40, 56, 80, 112, 160)
    proposal_stride: int = 4
    adaptive_const: float = 7.0
    score_threshold: float = 0.20
    min_white_black_diff: float = 30.0
    window: int = 64
    edge_points: int = 24
    error_correction_rate: float = 2.0
    max_border_errors: float = 0.35
    # Scale-proportional score-map decimation (see _decimation); off in the
    # shipped configuration.
    decimate: bool = False


# ---------------------------------------------------------------------------
# Stage 1: proposals (plain version of K2)
# ---------------------------------------------------------------------------


def _decimation(s: int, st: int, enable: bool = True) -> int:
    """Pyramid level (a power of 2) that scores scale s: the largest grid
    decimation keeping the origin stride <= s/8 px (1 without decimation)."""
    if not enable:
        return 1
    q = 1
    while q * 2 * 8 * st <= s:
        q *= 2
    return q


def _level_shape(h4: int, w4: int, q: int) -> tuple[int, int]:
    """The pooled grid (h4, w4) halved, rounding up, down to pyramid level q."""
    lq = 1
    while lq < q:
        h4, w4 = -(-h4 // 2), -(-w4 // 2)
        lq *= 2
    return h4, w4


def _kept_scales(h: int, w: int, p: DetectorParams) -> tuple:
    """The static per-frame-size scale ladder (shared by the proposals and the
    candidate stage's patch grouping)."""
    min_side = p.min_marker_perimeter_rate * max(h, w) / 4.0
    scales = tuple(int(s) for s in p.scales if s >= min_side / 1.5) or (int(p.scales[-1]),)
    scales = tuple(s for s in scales if int(round(s * 1.8)) < min(h, w))
    st = p.proposal_stride
    kept = []
    for s in scales:
        q = _decimation(s, st, p.decimate)
        _, _, sc_ring = _box_sides(s, st * q)
        if sc_ring < min(_level_shape(h // st, w // st, q)):
            kept.append(s)
    return tuple(kept)


def _box_sides(s: int, unit: int) -> tuple[int, int, int]:
    """Inner, mid (circumscribed) and ring box sides, in grid cells."""
    ring = int(round(s * 1.8))
    sc_in = max(s // unit, 1)
    sc_mid = max(int(round(s * _SQRT2 / unit)), sc_in + 1)
    sc_ring = max(int(round(ring / unit)), sc_mid + 1)
    return sc_in, sc_mid, sc_ring


@dataclasses.dataclass(frozen=True)
class ScalePlan:
    """Static box geometry of one scale on its pyramid level's grid (shared by
    the plain version and the K2 kernel, which takes level 1 only)."""

    size: int
    sc_in: int
    sc_mid: int
    sc_ring: int
    off_in: int
    off_mid: int
    n_y: int  # valid score rows / cols (top-left anchored)
    n_x: int
    r_d: int  # dilation radius, cells
    off_px: float  # candidate centre offset added to pos * unit
    q: int  # pyramid level (grid decimation of the pooled grid)
    unit: int  # px per grid cell: proposal_stride * q


def scale_plans(h: int, w: int, p: DetectorParams) -> tuple:
    st = p.proposal_stride
    plans = []
    for s in _kept_scales(h, w, p):
        q = _decimation(s, st, p.decimate)
        unit = st * q
        ny_q, nx_q = _level_shape(h // st, w // st, q)
        sc_in, sc_mid, sc_ring = _box_sides(s, unit)
        off_in = (sc_ring - sc_in) // 2
        off_mid = (sc_ring - sc_mid) // 2
        n_y_i, n_x_i = ny_q - sc_in + 1, nx_q - sc_in + 1
        n_y_m, n_x_m = ny_q - sc_mid + 1, nx_q - sc_mid + 1
        n_y_r, n_x_r = ny_q - sc_ring + 1, nx_q - sc_ring + 1
        n_y = min(n_y_r, n_y_i - 2 * off_in if off_in else n_y_i, n_y_m - 2 * off_mid if off_mid else n_y_m)
        n_x = min(n_x_r, n_x_i - 2 * off_in if off_in else n_x_i, n_x_m - 2 * off_mid if off_mid else n_x_m)
        plans.append(ScalePlan(
            size=s, sc_in=sc_in, sc_mid=sc_mid, sc_ring=sc_ring, off_in=off_in, off_mid=off_mid,
            n_y=n_y, n_x=n_x, r_d=max(-(-s // (2 * unit)), 1), off_px=off_in * unit + sc_in * unit / 2.0,
            q=q, unit=unit,
        ))
    return tuple(plans)


def _top_k(x: torch.Tensor, k: int):
    """lax.top_k semantics on the last axis: largest first, lower index
    first among equal values (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _top_k_grouped(flat: torch.Tensor, k: int, gsz: int = 2048):
    """The reference's top-k over large maps: group maxima -> top-k groups
    -> top-k inside them (exact on the value set; among equal values the
    order follows the groups' ranks, as in the reference)."""
    n = flat.shape[-1]
    if n < 8 * gsz:
        return _top_k(flat, k)
    padn = (-n) % gsz
    groups = torch.nn.functional.pad(flat, (0, padn), value=-1.0)
    groups = groups.reshape(*flat.shape[:-1], -1, gsz)
    _, gidx = _top_k(groups.amax(dim=-1), k)
    sub = torch.gather(groups, -2, gidx[..., None].expand(*gidx.shape, gsz))
    vals, sidx = _top_k(sub.reshape(*flat.shape[:-1], -1), k)
    idx = torch.gather(gidx, -1, torch.div(sidx, gsz, rounding_mode="floor")) * gsz + sidx % gsz
    return vals, idx


def _dilate_sq(a: torch.Tensor, r: int) -> torch.Tensor:
    """Square max filter of radius r over the last two axes, out-of-map
    cells ignored (the reference's -inf padded shift-max doubling)."""
    shape = a.shape
    x = a.reshape(-1, 1, shape[-2], shape[-1])
    x = torch.nn.functional.max_pool2d(x, (1, 2 * r + 1), stride=1, padding=(0, r))
    x = torch.nn.functional.max_pool2d(x, (2 * r + 1, 1), stride=1, padding=(r, 0))
    return x.reshape(shape)


@functools.lru_cache(maxsize=64)
def plan_vectors(plans: tuple, device: torch.device) -> torch.Tensor:
    """(S, 3) f32 off_px, unit, size of each scale plan on ``device``, built
    once per (plans, device) so that no call copies them to the card."""
    return torch.tensor([[e.off_px, float(e.unit), float(e.size)] for e in plans], dtype=torch.float32,
                        device=device)


def candidates_from_scores(vals: torch.Tensor, idx: torch.Tensor, nx: int, plans, p: DetectorParams):
    """Per-scale top-k (B, S, k) values and flat indices into the plans'
    (shared) level grid of width nx -> the detector's proposal tuple
    (centers (B,K,2) yx, sizes, scores, valid)."""
    b, ns, k = vals.shape
    iy = torch.div(idx, nx, rounding_mode="floor").to(torch.float32)
    ix = (idx % nx).to(torch.float32)
    vec = plan_vectors(tuple(plans), vals.device)
    offs = vec[None, :, 0, None]
    units = vec[None, :, 1, None]
    cy = (iy * units + offs).reshape(b, -1)
    cx = (ix * units + offs).reshape(b, -1)
    sizes = vec[None, :, 2, None].expand(b, ns, k).reshape(b, -1)
    vals = vals.reshape(b, -1)
    return torch.stack([cy, cx], dim=-1), sizes, vals, vals > p.score_threshold


def integral_image(pool: torch.Tensor) -> torch.Tensor:
    """Zero-padded integral image (B, h+1, w+1) f32 of the centred pool.

    Summed in float64 and rounded once: every centred value is a multiple of
    the mean's ulp and below 256 in magnitude, so the float64 partial sums
    of a 4K pooled frame are exact and the result does not depend on the
    summation order -- the K2 kernel gets the same integral bit for bit.
    """
    ii = torch.cumsum(torch.cumsum(pool.to(torch.float64), dim=1), dim=2).to(torch.float32)
    return torch.nn.functional.pad(ii, (1, 0, 1, 0))


def _pyramid(pool: torch.Tensor, max_q: int) -> dict:
    """Mean pyramid {q: (B, h_q, w_q)} of the pooled frame: each level the
    2x2 mean of the one below, edge-padded to even sizes first."""
    levels = {1: pool}
    q = 1
    while q < max_q:
        prev = levels[q]
        b, ph, pw = prev.shape
        pp = torch.nn.functional.pad(prev[:, None], (0, pw % 2, 0, ph % 2), mode="replicate")[:, 0]
        levels[2 * q] = pp.reshape(b, pp.shape[1] // 2, 2, pp.shape[2] // 2, 2).mean(dim=(2, 4))
        q *= 2
    return levels


def _to_level(src: torch.Tensor, src_q: int, dst_q: int, dst_shape: tuple[int, int]) -> torch.Tensor:
    """A dilated (B, h, w) score map resampled between adjacent pyramid
    levels: max-pool to a coarser level, nearest upsample to a finer one,
    cropped or -inf padded to the destination grid."""
    if src_q < dst_q:
        r = dst_q // src_q
        m = torch.nn.functional.pad(src, (0, -src.shape[2] % r, 0, -src.shape[1] % r), value=-math.inf)
        m = m.reshape(m.shape[0], m.shape[1] // r, r, m.shape[2] // r, r).amax(dim=(2, 4))
    elif src_q > dst_q:
        r = src_q // dst_q
        m = src.repeat_interleave(r, dim=1).repeat_interleave(r, dim=2)
    else:
        m = src
    dh, dw = dst_shape
    m = m[:, :dh, :dw]
    return torch.nn.functional.pad(m, (0, dw - m.shape[2], 0, dh - m.shape[1]), value=-math.inf)


def _proposals_from_pool(pool: torch.Tensor, h: int, w: int, p: DetectorParams):
    """Top-K dark-square candidates from the stride-pooled gray (B, h4, w4) f32.

    Returns centers (B, K, 2) yx, sizes (B, K), scores (B, K), valid (B, K),
    K = per_scale_k * n_scales, slots per scale in ladder order.  Each scale
    is scored on its pyramid level (level 1, the pooled grid itself, for
    every scale unless ``p.decimate``).
    """
    plans, levels, masked = nms_maps(pool, h, w, p)

    # Top-k per scale, batched per pyramid level (the ladder is monotone in q).
    outs = []
    a = 0
    while a < len(plans):
        b = a
        while b < len(plans) and plans[b].q == plans[a].q:
            b += 1
        vals, idx = _top_k_grouped(torch.stack(masked[a:b], dim=1), p.per_scale_k)
        outs.append(candidates_from_scores(vals, idx, levels[plans[a].q].shape[2], plans[a:b], p))
        a = b
    return tuple(torch.cat(parts, dim=1) for parts in zip(*outs))


def nms_maps(pool: torch.Tensor, h: int, w: int, p: DetectorParams):
    """The score maps of :func:`_proposals_from_pool` after the adjacent-scale
    non-max suppression: (plans, pyramid levels {q: (B, h_q, w_q)}, per scale
    the (B, h_q * w_q) map that holds each local maximum's score above the
    threshold and 0 elsewhere)."""
    st = p.proposal_stride
    h4, w4 = h // st, w // st
    pool = pool[:, :h4, :w4]
    # Mean-centre before the integral image (f32 cancellation control; the
    # shift cancels exactly in the outer-inner contrast).
    pool = pool - pool.mean(dim=(1, 2), keepdim=True)
    plans = scale_plans(h, w, p)
    levels = _pyramid(pool, max(e.q for e in plans))
    integrals = {q: integral_image(im) for q, im in levels.items()}

    def box(ii, oy: int, ox: int, sz: int, ny: int, nx: int):
        """Box sums of side sz at origins (oy + i, ox + j), i < ny, j < nx."""
        return (ii[:, oy + sz: oy + sz + ny, ox + sz: ox + sz + nx] - ii[:, oy + sz: oy + sz + ny, ox: ox + nx]
                - ii[:, oy: oy + ny, ox + sz: ox + sz + nx] + ii[:, oy: oy + ny, ox: ox + nx])

    scores, dils = [], []
    for e in plans:
        ii = integrals[e.q]
        inner = div_const(box(ii, e.off_in, e.off_in, e.sc_in, e.n_y, e.n_x), float(e.sc_in * e.sc_in))
        mid = box(ii, e.off_mid, e.off_mid, e.sc_mid, e.n_y, e.n_x)
        ring = box(ii, 0, 0, e.sc_ring, e.n_y, e.n_x)
        outer = div_const(ring - mid, float(e.sc_ring * e.sc_ring) - float(e.sc_mid * e.sc_mid))
        contrast = torch.clamp(outer - inner, min=0.0)
        sc = torch.where(contrast >= p.min_white_black_diff, div_const(contrast, 255.0), torch.zeros_like(contrast))
        full = torch.zeros(levels[e.q].shape, dtype=torch.float32, device=pool.device)
        full[:, : e.n_y, : e.n_x] = sc
        scores.append(full)
        dils.append(_dilate_sq(full, e.r_d))

    # Adjacent-scale non-max suppression.
    masked = []
    for si, (e, sc) in enumerate(zip(plans, scores)):
        cross = dils[si]
        for sj in (si - 1, si + 1):
            if 0 <= sj < len(scores):
                cross = torch.maximum(cross, _to_level(dils[sj], plans[sj].q, e.q, sc.shape[1:]))
        is_max = (sc >= cross) & (sc > p.score_threshold)
        masked.append(torch.where(is_max, sc, torch.zeros_like(sc)).reshape(pool.shape[0], -1))
    return plans, levels, masked


def pool_gray(gray: torch.Tensor, st: int) -> torch.Tensor:
    """Mean-pool (B, H, W) gray by the proposal stride -> (B, H//st, W//st)
    f32 (the reference's _pool_gray; sums of st*st u8 values are exact)."""
    b, h, w = gray.shape
    h4, w4 = h // st, w // st
    g = gray[:, : h4 * st, : w4 * st].to(torch.float32).reshape(b, h4, st, w4, st).sum(dim=(2, 4))
    return div_const(g, float(st * st))


def proposals(pool: torch.Tensor, h: int, w: int, p: DetectorParams):
    """Proposal slots of the pooled gray: kernel K2 (plain on the CPU), or,
    with ``p.decimate``, the pyramid in plain PyTorch on every device (the
    reference computes it in XLA; no kernel implements it)."""
    if p.decimate:
        return _proposals_from_pool(pool, h, w, p)
    from apse_uav_torch.aruco import cuda_proposals

    return cuda_proposals.proposals_from_pool(pool, h, w, p)


# ---------------------------------------------------------------------------
# Stage 2: quad extraction
# ---------------------------------------------------------------------------


def _patch_size(h: int, w: int) -> int:
    return min(384, (min(h, w) // 128) * 128) or min(h, w)


def _patch_groups(h: int, w: int, p: DetectorParams) -> list:
    """Contiguous per-scale slot groups sharing one patch size:
    [(start_slot, stop_slot, psize)] in slot-ladder order."""
    cap = _patch_size(h, w)
    k = p.per_scale_k
    groups = []
    for si, s in enumerate(_kept_scales(h, w, p)):
        ps = cap
        for cand_ps in (128, 256):
            if cand_ps >= 2.4 * s and cand_ps <= cap:
                ps = cand_ps
                break
        if groups and groups[-1][2] == ps:
            groups[-1] = (groups[-1][0], (si + 1) * k, ps)
        else:
            groups.append((si * k, (si + 1) * k, ps))
    return groups


def _extract_patch(gray: torch.Tensor, center_yx: torch.Tensor, psize: int):
    """Fixed-size patches around candidates.

    gray (B, H, W) f32, center_yx (B, n, 2) -> patches (B, n, psize, psize),
    origins (B, n, 2) f32 -- the reference's dynamic_slice clamp arithmetic.
    """
    b, h, w = gray.shape
    oy = torch.clamp(torch.round(center_yx[..., 0]) - psize // 2, 0, h - psize).to(torch.int64)
    ox = torch.clamp(torch.round(center_yx[..., 1]) - psize // 2, 0, w - psize).to(torch.int64)
    r = torch.arange(psize, device=gray.device)
    rows = (oy[..., None] + r)[..., :, None]
    cols = (ox[..., None] + r)[..., None, :]
    bi = torch.arange(b, device=gray.device)[:, None, None, None]
    patches = gray[bi, rows, cols]
    return patches, torch.stack([oy, ox], dim=-1).to(torch.float32)


def _hat_taps(v: torch.Tensor):
    """The two nonzero hat weights max(0, 1 - |v - c|) at c = floor(v), floor(v)+1."""
    c0 = torch.floor(v)
    w0 = torch.clamp(1.0 - torch.abs(v - c0), min=0.0)
    w1 = torch.clamp(1.0 - torch.abs(v - (c0 + 1.0)), min=0.0)
    return c0.to(torch.int64), w0, w1


def _sample_img(img: torch.Tensor, yx: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of img (N, Hi, Wi) at yx (N, ..., 2), coordinates
    clamped to [0, size - 1.001] as in the reference."""
    n, hi, wi = img.shape
    shape = yx.shape[:-1]
    pts = yx.reshape(n, -1, 2)
    y0, wy0, wy1 = _hat_taps(torch.clamp(pts[..., 0], 0.0, hi - 1.001))
    x0, wx0, wx1 = _hat_taps(torch.clamp(pts[..., 1], 0.0, wi - 1.001))
    flat = img.reshape(n, -1)

    def at(dy, dx):
        return torch.gather(flat, 1, (y0 + dy) * wi + x0 + dx)

    r0 = wy0 * at(0, 0) + wy1 * at(1, 0)
    r1 = wy0 * at(0, 1) + wy1 * at(1, 1)
    return (r0 * wx0 + r1 * wx1).reshape(shape)


def _extract_window(patch: torch.Tensor, center_rel: torch.Tensor, size: torch.Tensor, win: int):
    """Resample a win x win window covering 2.4*size around the centre.

    patch (N, P, P), center_rel (N, 2), size (N,) -> window (N, win, win),
    scale (N,) px per window px, origin (N, 2) yx in patch coords.
    """
    n, psize, _ = patch.shape
    span = torch.clamp(2.4 * size, max=float(psize))
    scale = span / win
    r = torch.arange(win, dtype=torch.float32, device=patch.device)
    oy = center_rel[:, 0] - span / 2.0
    ox = center_rel[:, 1] - span / 2.0
    ys = torch.clamp(oy[:, None] + (r + 0.5) * scale[:, None], 0.0, psize - 1.001)
    xs = torch.clamp(ox[:, None] + (r + 0.5) * scale[:, None], 0.0, psize - 1.001)
    y0, wy0, wy1 = _hat_taps(ys)
    x0, wx0, wx1 = _hat_taps(xs)
    rows0 = torch.gather(patch, 1, y0[..., None].expand(n, win, psize))
    rows1 = torch.gather(patch, 1, (y0 + 1)[..., None].expand(n, win, psize))
    rows = wy0[..., None] * rows0 + wy1[..., None] * rows1  # (N, win, P)
    c0 = torch.gather(rows, 2, x0[:, None, :].expand(n, win, win))
    c1 = torch.gather(rows, 2, (x0 + 1)[:, None, :].expand(n, win, win))
    window = c0 * wx0[:, None, :] + c1 * wx1[:, None, :]
    return window, scale, torch.stack([oy, ox], dim=-1)


def _masked_mean(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    s = torch.where(m, x, torch.zeros_like(x)).sum(dim=(-2, -1))
    return s / torch.clamp(m.sum(dim=(-2, -1)), min=1)


def _binarize(winimg: torch.Tensor):
    """2-means (Ridler-Calvard) threshold of (N, win, win): (dark, lo, hi)."""
    t = (winimg.amin(dim=(-2, -1)) + winimg.amax(dim=(-2, -1))) / 2.0
    for _ in range(4):
        below = winimg < t[:, None, None]
        t = (_masked_mean(winimg, below) + _masked_mean(winimg, ~below)) / 2.0
    below = winimg < t[:, None, None]
    return below, _masked_mean(winimg, below), _masked_mean(winimg, ~below)


def _label_sweeps(dark: torch.Tensor, rounds: int = 3, mop: int = 8) -> torch.Tensor:
    """Component labels of (N, win, win) bool masks under the reference's
    fixed schedule: ``rounds`` of segmented row/column prefix-min sweeps
    with run-id keys (R - runid)*K + label, then ``mop`` radius-1 steps.
    Root label y*win + x, sentinel win*win.  Plain version of K1."""
    n_win, win, _ = dark.shape
    n = win * win
    idx = torch.arange(n, dtype=torch.int32, device=dark.device).reshape(win, win)
    sentinel = torch.full((), n, dtype=torch.int32, device=dark.device)
    labels = torch.where(dark, idx, sentinel)
    kk, rr = n + 1, win + 1
    bi = (~dark).to(torch.int32)
    terms = []
    for axis in (2, 1):
        rf = torch.cumsum(bi, dim=axis, dtype=torch.int32)
        rb = torch.flip(torch.cumsum(torch.flip(bi, (axis,)), dim=axis, dtype=torch.int32), (axis,))
        terms.append(((rr - rf) * kk, (rr - rb) * kk))

    def sweep(lab, axis, tf, tb):
        lf = torch.cummin(tf + lab, dim=axis).values - tf
        lb = torch.flip(torch.cummin(torch.flip(tb + lab, (axis,)), dim=axis).values, (axis,)) - tb
        return torch.where(dark, torch.minimum(lab, torch.minimum(lf, lb)), sentinel)

    for _ in range(rounds):
        labels = sweep(labels, 2, *terms[0])
        labels = sweep(labels, 1, *terms[1])
    for _ in range(mop):
        p = torch.nn.functional.pad(labels, (1, 1, 1, 1), value=n)
        neigh = torch.minimum(torch.minimum(p[:, :-2, 1:-1], p[:, 2:, 1:-1]), torch.minimum(p[:, 1:-1, :-2], p[:, 1:-1, 2:]))
        labels = torch.where(dark, torch.minimum(labels, neigh), sentinel)
    return labels


def _largest_from_labels(labels: torch.Tensor, win: int) -> torch.Tensor:
    """Mask of the most populous label (smallest root on ties; sentinel
    cells count for nothing)."""
    n_win = labels.shape[0]
    n = win * win
    counts = torch.zeros((n_win, n + 1), dtype=torch.int32, device=labels.device)
    counts.scatter_add_(1, labels.reshape(n_win, -1).to(torch.int64),
                        torch.ones((n_win, n), dtype=torch.int32, device=labels.device))
    biggest = torch.argmax(counts[:, :n], dim=1)
    return labels == biggest[:, None, None].to(labels.dtype)


def _largest_component(dark: torch.Tensor, win: int, rounds: int = 3, mop: int = 8) -> torch.Tensor:
    """Largest 4-connected component of each (N, win, win) dark mask."""
    return _largest_from_labels(_label_sweeps(dark, rounds, mop), win)


def _coarse_corners(dark: torch.Tensor, win_img: torch.Tensor, win: int):
    """Quad corners of the dark blob via support-line fitting: (N, 4, 2) yx
    window coords and a quality flag (N,)."""
    n = dark.shape[0]
    dev = dark.device
    r = torch.arange(win, dtype=torch.float32, device=dev)
    yy = r[:, None].expand(win, win)
    xx = r[None, :].expand(win, win)
    gy = torch.zeros_like(win_img)
    gy[:, 1:-1, :] = (win_img[:, 2:, :] - win_img[:, :-2, :]) * 0.5
    gx = torch.zeros_like(win_img)
    gx[:, :, 1:-1] = (win_img[:, :, 2:] - win_img[:, :, :-2]) * 0.5
    near = dark
    for _ in range(2):  # dilate by 1 twice: gradients live on the blob rim
        p = torch.nn.functional.pad(near, (1, 1, 1, 1))
        near = p[:, 1:-1, 1:-1] | p[:, :-2, 1:-1] | p[:, 2:, 1:-1] | p[:, 1:-1, :-2] | p[:, 1:-1, 2:]
    wgt = torch.where(near, gx * gx + gy * gy, torch.zeros_like(gx))
    phi = torch.atan2(gy, gx)
    zr = (wgt * torch.cos(4.0 * phi)).sum(dim=(1, 2))
    zi = (wgt * torch.sin(4.0 * phi)).sum(dim=(1, 2))
    theta = torch.atan2(zi, zr) / 4.0

    k = torch.arange(4, dtype=torch.float32, device=dev)
    a = theta[:, None] + k * (math.pi / 2.0)  # (N, 4)
    ny_, nx_ = torch.sin(a), torch.cos(a)
    proj = ny_[..., None, None] * yy + nx_[..., None, None] * xx  # (N, 4, win, win)
    proj = torch.where(dark[:, None], proj, torch.full_like(proj, -math.inf))
    pmax = proj.amax(dim=(-2, -1))
    strip = dark[:, None] & (proj > pmax[..., None, None] - 1.5)
    wsum = torch.clamp(strip.sum(dim=(-2, -1)), min=1)
    c = torch.where(strip, proj, torch.zeros_like(proj)).sum(dim=(-2, -1)) / wsum
    lines = torch.stack([ny_, nx_, c], dim=-1)  # (N, 4, 3)
    l1, l2 = lines, torch.roll(lines, -1, dims=1)
    det = l1[..., 0] * l2[..., 1] - l2[..., 0] * l1[..., 1]
    det = torch.where(torch.abs(det) < 1e-9, torch.full_like(det, 1e-9), det)
    y = (l1[..., 2] * l2[..., 1] - l2[..., 2] * l1[..., 1]) / det
    x = (l1[..., 0] * l2[..., 2] - l2[..., 0] * l1[..., 2]) / det
    corners = torch.stack([y, x], dim=-1)
    extent = pmax[:, 0] + pmax[:, 2]
    ok = torch.isfinite(extent) & (dark.sum(dim=(1, 2)) > 30) & torch.isfinite(corners).all(dim=(1, 2))
    return corners, ok


def _order_clockwise(corners_yx: torch.Tensor) -> torch.Tensor:
    """Order (N, 4, 2) corners clockwise in image coords (y down) by angle."""
    c = corners_yx.mean(dim=1, keepdim=True)
    ang = torch.atan2(corners_yx[..., 0] - c[..., 0], corners_yx[..., 1] - c[..., 1])
    order = torch.argsort(ang, dim=1, stable=True)
    return torch.gather(corners_yx, 1, order[..., None].expand(-1, -1, 2))


def _refine_edges(img: torch.Tensor, corners_img: torch.Tensor, n_pts: int, spacing: torch.Tensor,
                  step_scale: float = 1.0, n_taps: int = 7):
    """Subpixel edge-line fit by gradient-weighted crossings + TLS.

    img (N, Hi, Wi), corners_img (N, 4, 2) yx clockwise, spacing (N,) ->
    refined corners (N, 4, 2), max line-fit MSE (N,).
    """
    dev = img.device
    half_t = n_taps // 2
    taps = torch.arange(-half_t, half_t + 1, dtype=torch.float32, device=dev)
    a = corners_img
    b = torch.roll(corners_img, -1, dims=1)
    t = (torch.arange(n_pts, dtype=torch.float32, device=dev) + 0.5) / n_pts
    t = 0.12 + t * 0.76
    pts = a[:, :, None, :] * (1 - t[:, None]) + b[:, :, None, :] * t[:, None]  # (N, 4, P, 2)
    d = b - a
    norm = torch.clamp(torch.linalg.vector_norm(d, dim=-1), min=1e-6)
    nvec = torch.stack([-d[..., 1], d[..., 0]], dim=-1) / norm[..., None]  # (N, 4, 2)
    step = torch.clamp(spacing * 0.6, min=0.35) * step_scale  # (N,)
    samp = pts[:, :, :, None, :] + nvec[:, :, None, None, :] * (taps[:, None] * step[:, None, None, None, None])
    vals = _sample_img(img, samp)  # (N, 4, P, T)
    grad = vals[..., 1:] - vals[..., :-1]
    gmag = torch.abs(grad)
    nseg = gmag.shape[-1]
    peak = torch.argmax(gmag, dim=-1)
    reliable = (peak > 0) & (peak < nseg - 1)
    wsum = torch.clamp(gmag.sum(-1), min=1e-6)
    pc = torch.clamp(peak, 1, nseg - 2)
    g_m1 = torch.gather(gmag, -1, (pc - 1)[..., None])[..., 0]
    g_0 = torch.gather(gmag, -1, pc[..., None])[..., 0]
    g_p1 = torch.gather(gmag, -1, (pc + 1)[..., None])[..., 0]
    denom = g_m1 - 2.0 * g_0 + g_p1
    big = torch.abs(denom) > 1e-6
    delta = torch.where(big, 0.5 * (g_m1 - g_p1) / torch.where(big, denom, torch.ones_like(denom)), torch.zeros_like(denom))
    delta = torch.clamp(delta, -0.75, 0.75)
    off = ((taps[0] + 0.5) + pc.to(torch.float32) + delta) * step[:, None, None]  # (N, 4, P)
    edge_pts = pts + nvec[:, :, None, :] * off[..., None]
    wts = torch.where(reliable, wsum, torch.zeros_like(wsum))
    wts = torch.where(wts.sum(-1, keepdim=True) > 1e-6, wts, wsum)
    wsumt = wts.sum(-1)  # (N, 4)
    mean = (edge_pts * wts[..., None]).sum(-2) / wsumt[..., None]
    d0 = edge_pts - mean[:, :, None, :]
    sxx = (wts * d0[..., 1] * d0[..., 1]).sum(-1)
    syy = (wts * d0[..., 0] * d0[..., 0]).sum(-1)
    sxy = (wts * d0[..., 1] * d0[..., 0]).sum(-1)
    tr = syy + sxx
    det = syy * sxx - sxy * sxy
    lam = tr / 2.0 - torch.sqrt(torch.clamp(tr * tr / 4.0 - det, min=0.0))
    has_xy = torch.abs(sxy) > 1e-9
    flat_y = syy <= sxx
    one, zero = torch.ones_like(sxy), torch.zeros_like(sxy)
    a_n = torch.where(has_xy, sxy, torch.where(flat_y, one, zero))
    b_n = torch.where(has_xy, lam - syy, torch.where(flat_y, zero, one))
    nrm = torch.clamp(torch.sqrt(a_n * a_n + b_n * b_n), min=1e-9)
    a_n, b_n = a_n / nrm, b_n / nrm
    c_n = -(a_n * mean[..., 0] + b_n * mean[..., 1])
    resid = a_n[..., None] * edge_pts[..., 0] + b_n[..., None] * edge_pts[..., 1] + c_n[..., None]
    mse = (wts * resid * resid).sum(-1) / torch.clamp(wsumt, min=1e-6)
    lines = torch.stack([a_n, b_n, c_n], dim=-1)  # (N, 4, 3)
    # Corner i = intersection of edge lines i-1 and i.
    l1, l2 = torch.roll(lines, 1, dims=1), lines
    det = l1[..., 0] * l2[..., 1] - l2[..., 0] * l1[..., 1]
    det = torch.where(torch.abs(det) < 1e-9, torch.full_like(det, 1e-9), det)
    y = (-l1[..., 2] * l2[..., 1] + l2[..., 2] * l1[..., 1]) / det
    x = (-l1[..., 0] * l2[..., 2] + l2[..., 0] * l1[..., 2]) / det
    return torch.stack([y, x], dim=-1), mse.amax(dim=-1)


# ---------------------------------------------------------------------------
# Stage 3: decoding
# ---------------------------------------------------------------------------


def _homography_unit_square(corners_xy: torch.Tensor) -> torch.Tensor:
    """Homographies (N, 3, 3) mapping the unit square to (N, 4, 2) x,y quads."""
    x0, y0 = corners_xy[:, 0, 0], corners_xy[:, 0, 1]
    x1, y1 = corners_xy[:, 1, 0], corners_xy[:, 1, 1]
    x2, y2 = corners_xy[:, 2, 0], corners_xy[:, 2, 1]
    x3, y3 = corners_xy[:, 3, 0], corners_xy[:, 3, 1]
    dx1, dx2, dy1, dy2 = x1 - x2, x3 - x2, y1 - y2, y3 - y2
    sx = x0 - x1 + x2 - x3
    sy = y0 - y1 + y2 - y3
    den = dx1 * dy2 - dx2 * dy1
    den = torch.where(torch.abs(den) < 1e-12, torch.full_like(den, 1e-12), den)
    g = (sx * dy2 - sy * dx2) / den
    hh = (dx1 * sy - dy1 * sx) / den
    one = torch.ones_like(g)
    return torch.stack([
        torch.stack([x1 - x0 + g * x1, x3 - x0 + hh * x3, x0], -1),
        torch.stack([y1 - y0 + g * y1, y3 - y0 + hh * y3, y0], -1),
        torch.stack([g, hh, one], -1),
    ], -2)


def _sample_cells(img: torch.Tensor, corners_yx: torch.Tensor, samples_per_cell: int = 3):
    """Mean intensity of each of the 6x6 marker cells (margin 0.33): (N, 6, 6)."""
    dev = img.device
    xy = torch.stack([corners_yx[..., 1], corners_yx[..., 0]], dim=-1)
    h_mat = _homography_unit_square(xy)
    margin = 0.33
    inner = (torch.arange(samples_per_cell, dtype=torch.float32, device=dev) + 0.5) / samples_per_cell
    inner = margin + inner * (1.0 - 2 * margin)
    cell = torch.arange(6, dtype=torch.float32, device=dev)
    u = (cell[:, None] + inner[None, :]).reshape(-1) / 6.0
    vv, uu = torch.meshgrid(u, u, indexing="ij")
    p = torch.stack([uu, vv, torch.ones_like(uu)], dim=-1) @ h_mat[:, None].transpose(-1, -2)  # (N, n, n, 3)
    xy_img = p[..., :2] / p[..., 2:3]
    vals = _sample_img(img, torch.stack([xy_img[..., 1], xy_img[..., 0]], dim=-1))
    n = corners_yx.shape[0]
    return vals.reshape(n, 6, samples_per_cell, 6, samples_per_cell).mean(dim=(2, 4))


def _otsu_split(cells: torch.Tensor) -> torch.Tensor:
    """Optimal 2-class split threshold over each (N, 6, 6) set of cell means."""
    v = torch.sort(cells.reshape(cells.shape[0], -1), dim=1).values
    n = v.shape[1]
    csum = torch.cumsum(v, dim=1)
    total = csum[:, -1:]
    k = torch.arange(1, n, device=v.device)
    mean_lo = csum[:, :-1] / k
    mean_hi = (total - csum[:, :-1]) / (n - k)
    between = (k * (n - k)) * (mean_hi - mean_lo) ** 2
    i = torch.argmax(between, dim=1)
    return (torch.gather(v, 1, i[:, None]) + torch.gather(v, 1, i[:, None] + 1))[:, 0] / 2.0


def _decode_candidate(img: torch.Tensor, corners_yx: torch.Tensor, p: DetectorParams,
                      table: torch.Tensor | None = None):
    """Decode quads: (id, rotation, border_ok, hamming), each (N,); ``table``
    as :func:`~apse_uav_torch.aruco.dictionary.match_dictionary` takes it."""
    cells = _sample_cells(img, corners_yx)
    bits = (cells > _otsu_split(cells)[:, None, None]).to(torch.int64)
    border = torch.cat([bits[:, 0, :], bits[:, 5, :], bits[:, 1:5, 0], bits[:, 1:5, 5]], dim=1)
    border_ok = border.sum(1) <= math.floor(20 * p.max_border_errors)
    weights = 2 ** torch.arange(15, -1, -1, device=img.device)
    packed = (bits[:, 1:5, 1:5].reshape(-1, 16) * weights).sum(1)
    ids, rot, dist = dict_mod.match_dictionary(packed, p.error_correction_rate, table)
    return torch.where(border_ok, ids, torch.full_like(ids, -1)), rot, border_ok, dist


# ---------------------------------------------------------------------------
# Candidate stage
# ---------------------------------------------------------------------------


def binarized_windows(gray: torch.Tensor, centers: torch.Tensor, sizes: torch.Tensor, p: DetectorParams):
    """The candidate stage before K1: patch, window and 2-means mask of every
    slot, per patch-size group.

    gray (B, H, W) u8 or f32, sampled as f32 -> ([per group: (patch,
    p_origin, window, scale, origin, hi - lo) over its B * n candidates],
    darks (B * K, win, win) bool in slot order -- the input of the
    component labeling, kernel K1).
    """
    g = gray.to(torch.float32)
    bsz, h, w = g.shape
    win_n = p.window
    pres, darks = [], []
    for a, b, ps in _patch_groups(h, w, p):
        patch, p_origin = _extract_patch(g, centers[:, a:b], ps)  # (B, n, ps, ps)
        n = bsz * (b - a)
        patch = patch.reshape(n, ps, ps)
        p_origin = p_origin.reshape(n, 2)
        center_rel = centers[:, a:b].reshape(n, 2) - p_origin
        win, scale, origin = _extract_window(patch, center_rel, sizes[:, a:b].reshape(n), win_n)
        dark, lo, hi = _binarize(win)
        pres.append((patch, p_origin, win, scale, origin, hi - lo))
        darks.append(dark.reshape(bsz, -1, win_n, win_n))
    return pres, torch.cat(darks, dim=1).reshape(-1, win_n, win_n)


def candidates_from_labels(labels: torch.Tensor, pres: list, scores: torch.Tensor, valid: torch.Tensor,
                           hw: tuple[int, int], p: DetectorParams, covered: torch.Tensor | None = None,
                           table: torch.Tensor | None = None):
    """The candidate stage after K1: the labels (B * K, win, win) of the dark
    masks and the groups ``pres`` of :func:`binarized_windows`, the (B, K)
    proposal scores and validity on frames of size ``hw`` -> corners
    (B, K, 4, 2) x,y and ids (B, K) (-1 = none).  ``covered`` as
    :func:`candidates` takes it; ``table`` as
    :func:`~apse_uav_torch.aruco.dictionary.match_dictionary` takes it.  Makes
    no host sync when ``table`` is given."""
    h, w = hw
    bsz, k_all = valid.shape
    if covered is not None:
        valid = valid & covered
    win_n = p.window
    masks = _largest_from_labels(labels, win_n).reshape(bsz, k_all, win_n, win_n)

    outs = []
    for (a, b, ps), pr in zip(_patch_groups(h, w, p), pres):
        patch, p_origin, win, scale, origin, diff = pr
        n = patch.shape[0]
        mask = masks[:, a:b].reshape(n, win_n, win_n)
        ok = valid[:, a:b].reshape(n)
        contrast_ok = diff >= p.min_white_black_diff
        coarse, quad_ok = _coarse_corners(mask, win, win_n)
        coarse_w = _order_clockwise(coarse)
        rough_w, _ = _refine_edges(win, coarse_w, p.edge_points, torch.ones_like(scale), step_scale=1.04, n_taps=11)
        drift0 = torch.linalg.vector_norm(rough_w - coarse_w, dim=-1).amax(dim=-1)
        rough_w = torch.where((drift0 < 6.0)[:, None, None], rough_w, coarse_w)
        rough = origin[:, None, :] + (rough_w + 0.5) * scale[:, None, None]
        refined, mse = _refine_edges(patch, rough, p.edge_points, scale, step_scale=0.8)
        drift = torch.linalg.vector_norm(refined - rough, dim=-1).amax(dim=-1)
        good_refine = drift < 6.0
        corners = torch.where(good_refine[:, None, None], refined, rough)
        mse_ok = (mse < p.max_line_fit_mse) & good_refine
        marker_id, rot, bits_ok, ham = _decode_candidate(patch, corners, p, table)
        corners = corners + p_origin[:, None, :]
        # Canonical corner order: roll by -rot (OpenCV's top-left first).
        order = (torch.arange(4, device=labels.device)[None, :] + rot[:, None].to(torch.int64)) % 4
        corners = torch.gather(corners, 1, order[..., None].expand(-1, -1, 2))
        side = torch.linalg.vector_norm(corners - torch.roll(corners, 1, dims=1), dim=-1).mean(dim=1)
        floor_ok = side >= p.min_marker_perimeter_rate * max(h, w) / 4.0
        is_valid = ok & quad_ok & contrast_ok & bits_ok & mse_ok & floor_ok & (marker_id >= 0)
        ids = torch.where(is_valid, marker_id, torch.full_like(marker_id, -1))
        outs.append((corners.reshape(bsz, -1, 4, 2), ids.reshape(bsz, -1), side.reshape(bsz, -1),
                     ham.reshape(bsz, -1)))
    corners = torch.cat([o[0] for o in outs], dim=1)
    ids = torch.cat([o[1] for o in outs], dim=1)
    sides = torch.cat([o[2] for o in outs], dim=1)
    hams = torch.cat([o[3] for o in outs], dim=1)

    # Dedup overlapping candidates: larger quad, then cleaner match, then
    # proposal score, then slot order.
    cen = corners.mean(dim=2)  # (B, K, 2)
    d2 = ((cen[:, :, None, :] - cen[:, None, :, :]) ** 2).sum(-1)
    radius2 = (torch.maximum(sides[:, :, None], sides[:, None, :]) * 0.55) ** 2
    overlap = d2 < radius2
    rank = (-hams.to(torch.float32) * 1e6 + sides * 1e2 + scores
            - torch.arange(k_all, dtype=torch.float32, device=labels.device) * 1e-3)
    rank = torch.where(ids >= 0, rank, torch.full_like(rank, -math.inf))
    better = rank[:, None, :] > rank[:, :, None]
    suppressed = (overlap & better & (ids[:, None, :] >= 0)).any(dim=2)
    ids = torch.where(suppressed, torch.full_like(ids, -1), ids)
    return torch.stack([corners[..., 1], corners[..., 0]], dim=-1), ids


def candidates(gray: torch.Tensor, centers: torch.Tensor, sizes: torch.Tensor, scores: torch.Tensor,
               valid: torch.Tensor, p: DetectorParams, covered: torch.Tensor | None = None):
    """The candidate stage for a batch: gray (B, H, W) u8 and the (B, K)
    proposal slots -> corners (B, K, 4, 2) x,y and ids (B, K) (-1 = none).

    ``covered`` (B, K) bool: two-pass coverage mask; candidates whose patch
    tiles were not recomputed are invalidated before the overlap dedup.
    Each patch group copies the dictionary's table from the host.
    :func:`binarized_windows`, component labeling through
    :func:`apse_uav_torch.aruco.cuda_labeling.labels` (kernel K1 on the card,
    :func:`_label_sweeps` on the CPU), then :func:`candidates_from_labels`.
    """
    from apse_uav_torch.aruco import cuda_labeling

    pres, darks = binarized_windows(gray, centers, sizes, p)
    labels = cuda_labeling.labels(darks)
    return candidates_from_labels(labels, pres, scores, valid, tuple(gray.shape[1:]), p, covered)


class ArucoDetector:
    """Fixed-shape ArUco detector on one device (cuda unless asked for cpu).

    ``detect(gray)`` takes (H, W) or (B, H, W) gray on that device and returns
    corners (..., K, 4, 2) x,y and ids (..., K) (-1 = none), K proposal
    slots: pool, proposals (K2), the candidate stage (K1).
    """

    def __init__(self, params: DetectorParams | None = None, device="cuda"):
        self.params = params or DetectorParams()
        self.device = resolve_device(device)

    def detect(self, gray: torch.Tensor):
        if gray.device != self.device:
            raise ValueError(f"gray is on {gray.device}, the detector on {self.device}")
        if gray.dim() not in (2, 3):
            raise ValueError(f"gray must be (H, W) or (B, H, W), got {tuple(gray.shape)}")
        p = self.params
        g3 = gray[None] if gray.dim() == 2 else gray
        h, w = g3.shape[1:]
        corners, ids = candidates(g3, *proposals(pool_gray(g3, p.proposal_stride), h, w, p), p)
        return (corners[0], ids[0]) if gray.dim() == 2 else (corners, ids)
