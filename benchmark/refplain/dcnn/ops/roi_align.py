"""The sample grid of ROIAlign bins (torchvision's ``roi_align`` semantics:
each output bin averages ``sampling_ratio**2`` bilinear samples on a regular
grid inside the bin).  The gathers themselves are in
:func:`~refplain.dcnn.models.roi_heads.fpn_roi_align` and the tracker's
embedding crop.
"""

from __future__ import annotations

import torch


def sample_grid(n: int, s: int, device) -> torch.Tensor:
    """(n * s,) float32 sample offsets in bins: bin i, sample a at i + (a + 0.5) / s."""
    return (torch.arange(n, dtype=torch.float32, device=device)[:, None]
            + (torch.arange(s, dtype=torch.float32, device=device)[None, :] + 0.5) / s).reshape(-1)
