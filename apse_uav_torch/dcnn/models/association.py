"""Re-ID embedding head (the reference's ``dcnn/models/association.py``).

One linear map from flattened ROI features (channel-major) to an
``embedding_dim`` vector, L2-normalised with a 1e-12 floor on the norm.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


class AssociationHead(nn.Module):
    def __init__(self, in_dim: int, embedding_dim: int = 128):
        super().__init__()
        self.fc = nn.Linear(in_dim, embedding_dim)

    def forward(self, roi_features: torch.Tensor) -> torch.Tensor:
        """roi_features (N, C, R, R) or (N, D) -> (N, embedding_dim), unit norm."""
        x = self.fc(roi_features.reshape(roi_features.shape[0], -1))
        return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-12)


def init_weights(in_dim: int, embedding_dim: int = 128, seed: int = 1) -> dict[str, np.ndarray]:
    """A seeded AssociationHead state dict for running without trained weights:
    LeCun-normal kernel (std 1/sqrt(in_dim)), zero bias (flax Dense's init
    rule; the numbers differ from the reference's, drawn from its own RNG)."""
    rng = np.random.default_rng(seed)
    return {"fc.weight": (rng.standard_normal((embedding_dim, in_dim)) / np.sqrt(in_dim)).astype(np.float32),
            "fc.bias": np.zeros(embedding_dim, np.float32)}
