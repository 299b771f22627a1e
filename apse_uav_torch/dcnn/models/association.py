"""Re-ID embedding head (the reference's ``dcnn/models/association.py``).

One linear map from flattened ROI features (channel-major) to an
``embedding_dim`` vector, L2-normalised with a 1e-12 floor on the norm.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from apse_uav_torch.dcnn.flax_init import dense_init


class AssociationHead(nn.Module):
    def __init__(self, in_dim: int, embedding_dim: int = 128):
        super().__init__()
        self.fc = nn.Linear(in_dim, embedding_dim)

    def forward(self, roi_features: torch.Tensor) -> torch.Tensor:
        """roi_features (N, C, R, R) or (N, D) -> (N, embedding_dim), unit norm."""
        x = self.fc(roi_features.reshape(roi_features.shape[0], -1))
        return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-12)


def init_weights(in_dim: int, embedding_dim: int = 128, seed: int = 1) -> dict[str, np.ndarray]:
    """The reference's AssociationHead without trained weights: its flax init
    under ``PRNGKey(seed)`` (the JAX CLIs take seed 1), computed without JAX
    (:mod:`apse_uav_torch.dcnn.flax_init`): a truncated LeCun-normal kernel,
    transposed to ``fc.weight``, and a zero bias."""
    kernel, bias = dense_init(seed, ("fc",), in_dim, embedding_dim)
    return {"fc.weight": np.ascontiguousarray(kernel.T), "fc.bias": bias}


def head_weights(path: str | None, in_dim: int, embedding_dim: int = 128) -> dict:
    """The re-ID head's state dict for a CLI's ``--assoc_weights``: ``params``
    of the port's checkpoint at ``path`` (``directory/name``,
    :mod:`apse_uav_torch.train.checkpoint`), or the reference's default head
    (:func:`init_weights`, seed 1) when ``path`` is None or names no
    checkpoint, as the reference falls back (with a warning here)."""
    from apse_uav_torch.train.checkpoint import load_state

    if path:
        state = load_state(os.path.dirname(path) or ".", os.path.basename(path))
        if state is not None:
            return state["params"]
        print(f"warning: no association head checkpoint at {path}: using the default head")
    return init_weights(in_dim, embedding_dim)
