"""Small tensor helpers shared by the plain versions of the kernels."""

from __future__ import annotations

import torch


def div_const(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as an IEEE division on every backend.

    PyTorch's CUDA backend turns ``tensor / python_scalar`` into a
    multiplication by the reciprocal, which rounds differently from the IEEE
    division that the CPU, XLA and the CUDA kernels do; dividing by a 0-d
    tensor on the operand's device keeps the division.
    """
    return x / torch.full((), c, dtype=x.dtype, device=x.device)
