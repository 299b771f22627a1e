"""COCO-compatible RLE masks in numpy (the ``pycocotools.mask`` surface).

The port's own codec, counterpart of the JAX reference's
``evaluation/rle.py`` (which wraps a C++ library and keeps a numpy
fallback): ``encode``, ``decode``, ``area``, ``iou`` (with ``iscrowd``),
``merge`` and ``toBbox``.  RLE objects are dicts ``{"size": [h, w],
"counts": bytes}`` with COCO's compressed string; masks are (H, W) uint8
arrays scanned in column-major (Fortran) order.  The count strings are
byte-identical to the reference's.

Overlaps are computed on the runs themselves (sorted interval arithmetic),
never on decoded masks, so a 4K frame's masks cost what their runs cost.
"""

from __future__ import annotations

import numpy as np

RLE = dict  # {"size": [h, w], "counts": bytes}


# ---- counts <-> masks and strings ------------------------------------------


def _counts_encode(flat: np.ndarray) -> np.ndarray:
    """Column-major flat mask -> run lengths, starting with a (possibly empty) run of zeros."""
    v = flat.astype(bool)
    if v.size == 0:
        return np.zeros(1, np.uint32)
    edges = np.concatenate([[0], np.nonzero(v[1:] != v[:-1])[0] + 1, [v.size]])
    runs = np.diff(edges)
    if v[0]:
        runs = np.concatenate([[0], runs])
    return runs.astype(np.uint32)


def _counts_decode(counts: np.ndarray, n: int) -> np.ndarray:
    """Run lengths -> flat uint8 mask of length n (cut or zero-padded to n)."""
    vals = np.zeros(len(counts), np.uint8)
    vals[1::2] = 1
    out = np.repeat(vals, counts.astype(np.int64))[:n]
    return np.pad(out, (0, n - len(out)))


def _string_encode(counts: np.ndarray) -> bytes:
    """COCO's compressed counts: 5-bit groups with a continuation bit, offset
    by 48; counts after the second stored as differences to the one two back."""
    out = bytearray()
    counts = counts.astype(np.int64)
    for i, x in enumerate(counts.tolist()):
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(c + 48)
    return bytes(out)


def _string_decode(s: bytes) -> np.ndarray:
    counts: list[int] = []
    p = 0
    while p < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = s[p] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return np.asarray(counts, np.int64).astype(np.uint32)


def _counts_of(rle: RLE) -> np.ndarray:
    c = rle["counts"]
    if isinstance(c, str):
        c = c.encode()
    if isinstance(c, (bytes, bytearray)):
        return _string_decode(bytes(c))
    return np.asarray(c, np.uint32)  # the uncompressed list form


def _rle(counts: np.ndarray, h: int, w: int) -> RLE:
    return {"size": [int(h), int(w)], "counts": _string_encode(counts)}


# ---- runs as sorted intervals of ones ---------------------------------------


def _intervals(counts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(starts, ends) int64 of the runs of ones: [pos[1], pos[2]), [pos[3], pos[4]), ..."""
    pos = np.concatenate([[0], np.cumsum(counts.astype(np.int64))])
    m = len(counts)
    return pos[1:m:2], pos[2 : m + 1 : 2]


def _ones_before(starts: np.ndarray, ends: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Pixels of the (non-empty list of) intervals that lie below each position x."""
    k = np.searchsorted(starts, x, side="right") - 1  # the last interval starting at or below x
    kk = np.maximum(k, 0)
    before = np.concatenate([[0], np.cumsum(ends - starts)])
    partial = np.clip(x - starts[kk], 0, ends[kk] - starts[kk])
    return np.where(k >= 0, before[kk] + partial, 0)


def _counts_from_intervals(starts: np.ndarray, ends: np.ndarray, n: int) -> np.ndarray:
    """Sorted, disjoint, non-touching intervals of ones over n pixels -> run
    lengths as ``encode`` makes them (a leading zero run, possibly empty; no
    trailing empty run)."""
    if len(starts) == 0:
        return np.asarray([n], np.uint32)
    bounds = np.empty(2 * len(starts), np.int64)
    bounds[0::2], bounds[1::2] = starts, ends
    counts = np.diff(np.concatenate([[0], bounds]))
    if ends[-1] < n:
        counts = np.concatenate([counts, [n - ends[-1]]])
    return counts.astype(np.uint32)


def _union(sa, ea, sb, eb):
    s, e = np.concatenate([sa, sb]), np.concatenate([ea, eb])
    order = np.argsort(s, kind="stable")
    s, e = s[order], e[order]
    if len(s) == 0:
        return s, e
    reach = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > reach[:-1]  # a gap before it: touching runs join
    first = np.nonzero(new)[0]
    return s[first], np.maximum.reduceat(e, first)


def _intersect(sa, ea, sb, eb):
    lo = np.searchsorted(eb, sa, side="right")  # the first b ending after a starts
    hi = np.searchsorted(sb, ea, side="left")  # past the last b starting before a ends
    reps = np.maximum(hi - lo, 0)
    ia = np.repeat(np.arange(len(sa)), reps)
    ib = np.concatenate([np.arange(a, b) for a, b in zip(lo, hi) if b > a] or [np.zeros(0, np.int64)])
    s, e = np.maximum(sa[ia], sb[ib]), np.minimum(ea[ia], eb[ib])
    keep = e > s
    return s[keep], e[keep]


def _intersection(a: np.ndarray, b: np.ndarray) -> int:
    sa, ea = _intervals(a)
    sb, eb = _intervals(b)
    if len(sa) == 0 or len(sb) == 0:
        return 0
    return int((_ones_before(sb, eb, ea) - _ones_before(sb, eb, sa)).sum())


# ---- public API (pycocotools.mask surface) ----------------------------------


def encode(mask: np.ndarray) -> RLE:
    """Binary (H, W) mask -> compressed RLE (column-major scan order)."""
    h, w = mask.shape
    return _rle(_counts_encode(np.asarray(mask).ravel(order="F")), h, w)


def decode(rle: RLE) -> np.ndarray:
    """RLE -> binary (H, W) uint8 mask."""
    h, w = rle["size"]
    return _counts_decode(_counts_of(rle), h * w).reshape((h, w), order="F")


def area(rle: RLE) -> int:
    return int(_counts_of(rle)[1::2].astype(np.int64).sum())


def iou(dt: list[RLE], gt: list[RLE], iscrowd: list[int] | None = None) -> np.ndarray:
    """Pairwise IoU matrix (len(dt), len(gt)), float64; a crowd GT
    (``iscrowd[j]``) gives intersection over the detection's area."""
    if iscrowd is None:
        iscrowd = [0] * len(gt)
    dts = [_counts_of(r) for r in dt]
    gts = [_counts_of(r) for r in gt]
    a_dt = [int(c[1::2].astype(np.int64).sum()) for c in dts]
    a_gt = [int(c[1::2].astype(np.int64).sum()) for c in gts]
    out = np.zeros((len(dt), len(gt)))
    for i, dc in enumerate(dts):
        for j, gc in enumerate(gts):
            inter = _intersection(dc, gc)
            u = a_dt[i] if iscrowd[j] else a_dt[i] + a_gt[j] - inter
            out[i, j] = inter / u if u > 0 else 0.0
    return out


def merge(rles: list[RLE], intersect: bool = False) -> RLE:
    """Union (or intersection) of RLEs of one extent."""
    assert rles, "merge of empty list"
    h, w = rles[0]["size"]
    s, e = _intervals(_counts_of(rles[0]))
    s, e = s[e > s], e[e > s]
    for r in rles[1:]:
        sb, eb = _intervals(_counts_of(r))
        s, e = (_intersect if intersect else _union)(s, e, sb[eb > sb], eb[eb > sb])
    return _rle(_counts_from_intervals(s, e, h * w), h, w)


def toBbox(rle: RLE) -> np.ndarray:
    """RLE -> tight (x, y, w, h) box, float64; zeros for an empty mask."""
    h = int(rle["size"][0])
    starts, ends = _intervals(_counts_of(rle))
    keep = ends > starts
    starts, ends = starts[keep], ends[keep] - 1
    if len(starts) == 0:
        return np.zeros(4)
    x0, x1 = starts // h, ends // h
    one_col = x0 == x1
    ymin = min(int((starts[one_col] % h).min(initial=h)), 0 if (~one_col).any() else h)
    ymax = max(int((ends[one_col] % h).max(initial=-1)), h - 1 if (~one_col).any() else -1)
    return np.asarray([x0.min(), ymin, x1.max() - x0.min() + 1, ymax - ymin + 1], np.float64)
