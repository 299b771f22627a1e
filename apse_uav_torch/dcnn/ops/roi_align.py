"""ROIAlign and ROIPool, as row gathers on channels-last feature maps.

Counterpart of the JAX reference's ``dcnn/ops/roi_align.py``
(``roi_align_hwc``, the channels-first ``roi_align`` over it, and
``roi_pool``; torchvision's ``roi_align`` semantics):

* each output bin averages ``sampling_ratio**2`` bilinear samples on a
  regular grid inside the bin;
* ``aligned=True`` shifts by half a pixel (detectron2 "ROIAlignV2"); without
  it a ROI is at least 1 px wide and tall (torchvision's legacy rule);
* torchvision's border band: samples with y or x in [-1, H] / [-1, W] are
  clamped to the border, samples outside it return 0.

Each sample gathers one contiguous C-vector of the (H, W, C) map.
"""

from __future__ import annotations

import torch


def bilinear_gather_hwc(feat_hwc: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                        plane: torch.Tensor | None = None) -> torch.Tensor:
    """feat (H, W, C); ys/xs (S,) sample coordinates -> (S, C).

    ``plane`` (H, W), if given, scales the features texel by texel: the
    result is that of ``feat * plane[..., None]``, computed as the reference
    does, by gathering the plane at the same taps and scaling each tap's
    weight (no (H, W, C) product is made)."""
    h, w, c = feat_hwc.shape
    out_of_range = (ys < -1.0) | (ys > h * 1.0) | (xs < -1.0) | (xs > w * 1.0)
    y = ys.clamp(0.0, h - 1.0)
    x = xs.clamp(0.0, w - 1.0)
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    y1 = torch.clamp(y0 + 1, max=h - 1.0)
    x1 = torch.clamp(x0 + 1, max=w - 1.0)
    ly = y - y0
    lx = x - x0
    y0i, x0i, y1i, x1i = (t.to(torch.int64) for t in (y0, x0, y1, x1))
    flat = feat_hwc.reshape(h * w, c)
    idx = (y0i * w + x0i, y0i * w + x1i, y1i * w + x0i, y1i * w + x1i)
    wts = [(1 - ly) * (1 - lx), (1 - ly) * lx, ly * (1 - lx), ly * lx]
    if plane is not None:
        pf = plane.reshape(-1)
        wts = [wt * pf[i] for wt, i in zip(wts, idx)]
    val = flat[idx[0]] * wts[0][:, None]
    for i, wt in zip(idx[1:], wts[1:]):
        val = val + flat[i] * wt[:, None]
    return torch.where(out_of_range[:, None], torch.zeros((), dtype=val.dtype, device=val.device), val)


def sample_grid(n: int, s: int, device) -> torch.Tensor:
    """(n * s,) float32 sample offsets in bins: bin i, sample a at i + (a + 0.5) / s."""
    return (torch.arange(n, dtype=torch.float32, device=device)[:, None]
            + (torch.arange(s, dtype=torch.float32, device=device)[None, :] + 0.5) / s).reshape(-1)


def roi_align_hwc(feat_hwc: torch.Tensor, boxes: torch.Tensor, output_size, spatial_scale: float = 1.0,
                  sampling_ratio: int = 2, aligned: bool = False, plane: torch.Tensor | None = None) -> torch.Tensor:
    """feat (H, W, C), boxes (N, 4) xyxy in image coordinates -> (N, C, oh, ow).
    ``plane`` (H, W) optionally scales the features texel by texel: exactly
    ROIAlign of ``feat * plane[..., None]`` (see :func:`bilinear_gather_hwc`)."""
    oh, ow = (output_size, output_size) if isinstance(output_size, int) else output_size
    s = max(int(sampling_ratio), 1)
    offset = 0.5 if aligned else 0.0
    c = feat_hwc.shape[-1]
    n = boxes.shape[0]
    x1 = boxes[:, 0] * spatial_scale - offset
    y1 = boxes[:, 1] * spatial_scale - offset
    x2 = boxes[:, 2] * spatial_scale - offset
    y2 = boxes[:, 3] * spatial_scale - offset
    rw = x2 - x1
    rh = y2 - y1
    if not aligned:  # torchvision legacy: ROIs are at least 1 px
        rw = rw.clamp(min=1.0)
        rh = rh.clamp(min=1.0)
    bin_h = rh / oh
    bin_w = rw / ow
    ys = y1[:, None] + sample_grid(oh, s, boxes.device)[None, :] * bin_h[:, None]  # (N, oh*s)
    xs = x1[:, None] + sample_grid(ow, s, boxes.device)[None, :] * bin_w[:, None]  # (N, ow*s)
    yy = ys[:, :, None].expand(n, oh * s, ow * s).reshape(-1)
    xx = xs[:, None, :].expand(n, oh * s, ow * s).reshape(-1)
    vals = bilinear_gather_hwc(feat_hwc, yy, xx, plane)  # (N*S, C)
    vals = vals.reshape(n, oh, s, ow, s, c).mean(dim=(2, 4))  # (N, oh, ow, C)
    return vals.permute(0, 3, 1, 2)


def roi_align(feat: torch.Tensor, boxes: torch.Tensor, output_size, spatial_scale: float = 1.0,
              sampling_ratio: int = 2, aligned: bool = False) -> torch.Tensor:
    """feat (C, H, W), boxes (N, 4) -> (N, C, oh, ow): :func:`roi_align_hwc`
    on the channels-last view (torchvision's layout)."""
    return roi_align_hwc(feat.permute(1, 2, 0), boxes, output_size, spatial_scale, sampling_ratio, aligned)


def roi_pool(feat: torch.Tensor, boxes: torch.Tensor, output_size, spatial_scale: float = 1.0) -> torch.Tensor:
    """Quantised max ROI pooling, feat (C, H, W), boxes (N, 4) -> (N, C, oh, ow).

    torchvision's bins (box corners rounded, a box at least 1 px, bin edges
    floored / ceiled) snapped with the reference's 1e-4 epsilon, each bin
    the maximum over the reference's fixed lattice of K x K taps from its
    corner (K = min(side, 16)) that fall inside it; an empty bin is 0.
    Where the lattice is smaller than a bin, the result is the reference's,
    not torchvision's."""
    oh, ow = (output_size, output_size) if isinstance(output_size, int) else output_size
    c, h, w = feat.shape
    kh, kw = min(h, 16), min(w, 16)
    dev = feat.device
    hwc = feat.permute(1, 2, 0)
    corners = torch.round(boxes * spatial_scale)
    ii = torch.arange(oh, dtype=torch.float32, device=dev)
    jj = torch.arange(ow, dtype=torch.float32, device=dev)
    eps = 1e-4
    out = []
    for x1, y1, x2, y2 in corners:
        bin_h = torch.clamp(y2 - y1 + 1, min=1.0) / oh
        bin_w = torch.clamp(x2 - x1 + 1, min=1.0) / ow
        hstart = (torch.floor(ii * bin_h + eps) + y1).clamp(0, h)
        hend = (torch.ceil((ii + 1) * bin_h - eps) + y1).clamp(0, h)
        wstart = (torch.floor(jj * bin_w + eps) + x1).clamp(0, w)
        wend = (torch.ceil((jj + 1) * bin_w - eps) + x1).clamp(0, w)
        ys = hstart[:, None] + torch.arange(kh, device=dev)  # (oh, kh)
        xs = wstart[:, None] + torch.arange(kw, device=dev)  # (ow, kw)
        inside = (ys < hend[:, None])[:, :, None, None] & (xs < wend[:, None])[None, None]
        yi = ys.clamp(0, h - 1).to(torch.int64)
        xi = xs.clamp(0, w - 1).to(torch.int64)
        taps = hwc[yi[:, :, None, None], xi[None, None]]  # (oh, kh, ow, kw, C)
        val = torch.where(inside[..., None], taps, float("-inf")).amax(dim=(1, 3))  # (oh, ow, C)
        empty = (hend <= hstart)[:, None] | (wend <= wstart)[None, :]
        out.append(torch.where(empty[..., None], 0.0, val).permute(2, 0, 1))
    if not out:
        return feat.new_zeros((0, c, oh, ow))
    return torch.stack(out)
