"""Online-mined triplet losses of the re-ID association head.

Counterpart of the JAX reference's ``dcnn/losses.py``: ``batch_hard`` takes
the hardest positive and the hardest negative of each anchor, ``batch_all``
the mean over the valid triplets with a positive loss.  Distances use the
Gram-matrix trick with the reference's zero clamp and masked square root,
so the gradient at a zero distance is 0, not NaN.  Reductions that pick a
maximum or a minimum share the gradient among ties (``amax`` / ``amin``), as
JAX's reductions do, and ``maximum`` splits it at a tie (:func:`max0`), as
``jnp.maximum`` does.
"""

from __future__ import annotations

import torch


def max0(x: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum(x, 0)``: half the gradient where x is exactly 0 (``clamp`` passes all of it)."""
    return torch.maximum(x, x.new_zeros(()))


def pairwise_distances(embeddings: torch.Tensor, squared: bool = False) -> torch.Tensor:
    """(N, D) -> (N, N) pairwise euclidean distances."""
    dot = embeddings @ embeddings.T
    sq = torch.diagonal(dot)
    d2 = max0(sq[:, None] - 2.0 * dot + sq[None, :])
    if squared:
        return d2
    zero = d2 == 0.0
    d = torch.sqrt(d2 + torch.where(zero, 1e-16, 0.0))
    return torch.where(zero, 0.0, d)


def _positive_mask(labels: torch.Tensor) -> torch.Tensor:
    not_self = ~torch.eye(labels.shape[0], dtype=torch.bool, device=labels.device)
    return (labels[:, None] == labels[None, :]) & not_self


def _negative_mask(labels: torch.Tensor) -> torch.Tensor:
    return labels[:, None] != labels[None, :]


def batch_hard_triplet_loss(labels: torch.Tensor, embeddings: torch.Tensor, margin: float, squared: bool = False,
                            valid: torch.Tensor | None = None) -> torch.Tensor:
    """max(hardest_pos - hardest_neg + margin, 0), the mean over the (valid) anchors."""
    d = pairwise_distances(embeddings, squared)
    pos_mask = _positive_mask(labels)
    neg_mask = _negative_mask(labels)
    if valid is not None:
        both = valid[:, None] & valid[None, :]
        pos_mask = pos_mask & both
        neg_mask = neg_mask & both
    hardest_pos = torch.where(pos_mask, d, 0.0).amax(dim=1)
    max_d = d.amax(dim=1, keepdim=True)
    hardest_neg = torch.where(neg_mask, d, max_d + 1.0).amin(dim=1)
    loss = max0(hardest_pos - hardest_neg + margin)
    if valid is None:
        return loss.mean()
    return torch.where(valid, loss, 0.0).sum() / valid.sum().clamp(min=1)


def batch_all_triplet_loss(labels: torch.Tensor, embeddings: torch.Tensor, margin: float, squared: bool = False,
                           valid: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean over the triplets with a positive loss, that share of the valid triplets)."""
    d = pairwise_distances(embeddings, squared)
    loss = d[:, :, None] - d[:, None, :] + margin  # (A, P, N): d(a, p) - d(a, n)
    same = labels[:, None] == labels[None, :]
    not_self = ~torch.eye(labels.shape[0], dtype=torch.bool, device=labels.device)
    valid_triplet = (same & not_self)[:, :, None] & (~same)[:, None, :]
    if valid is not None:
        vv = valid[:, None] & valid[None, :]
        valid_triplet = valid_triplet & vv[:, :, None] & valid[None, None, :]
    loss = torch.where(valid_triplet, max0(loss), 0.0)
    num_positive = (loss > 1e-16).sum()
    num_valid = valid_triplet.sum().clamp(min=1)
    return loss.sum() / num_positive.clamp(min=1), num_positive / num_valid
