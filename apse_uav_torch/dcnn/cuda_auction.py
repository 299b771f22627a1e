"""Wrapper of the gated auction kernel (``csrc/auction.cu``): the tracker's association solver.

Replaces the JAX reference's ``dcnn/hungarian.py`` ``gated_auction_match``, a
``lax.while_loop`` that runs on the device (no Pallas kernel).  On a CPU
tensor it runs the plain version,
:func:`apse_uav_torch.dcnn.hungarian.gated_auction_sweeps`; on a CUDA tensor
it launches the kernel, one launch a problem and no host sync, or raises.
The result is bit-identical either way: the kernel runs the plain version's
float32 operations in its order, with its ties to the lower index.

The sweep count of each call stays on the tensor's device: :func:`solve`
returns it and :data:`last_sweeps` holds the last one.  Nothing here reads
it back.
"""

from __future__ import annotations

import ctypes

import torch

from apse_uav_torch import _build
from apse_uav_torch.dcnn.hungarian import gated_auction_sweeps

NAME = "auction"
# The kernel's limits (csrc/auction.cu); the CLIs' TrackerConfig is 32 x 32.
MAX_ROWS = 1024
MAX_COLS = 1024

# The last call's sweep count, (1,) int32 on the input's device.
last_sweeps: torch.Tensor | None = None


def solve(cost: torch.Tensor, row_valid: torch.Tensor, col_valid: torch.Tensor, threshold: float,
          max_sweeps: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """cost (R, D) float32, row_valid (R,) bool, col_valid (D,) bool, all on
    one device -> (col_of_row (R,) int64 with -1 = unmatched, sweeps (1,)
    int32), the matching of :func:`gated_auction_match` and its sweep count."""
    global last_sweeps
    if cost.dtype != torch.float32 or cost.dim() != 2:
        raise ValueError(f"cost must be (R, D) float32, got {tuple(cost.shape)} {cost.dtype}")
    n_rows, n_cols = cost.shape
    for name, t, n in (("row_valid", row_valid, n_rows), ("col_valid", col_valid, n_cols)):
        if t.dtype != torch.bool or tuple(t.shape) != (n,):
            raise ValueError(f"{name} must be ({n},) bool, got {tuple(t.shape)} {t.dtype}")
        if t.device != cost.device:
            raise ValueError(f"{name} is on {t.device}, cost on {cost.device}")
    if not (1 <= n_rows <= MAX_ROWS and 1 <= n_cols <= MAX_COLS):
        raise ValueError(f"cost {n_rows} x {n_cols}: the auction takes 1..{MAX_ROWS} rows and 1..{MAX_COLS} columns")
    if cost.device.type == "cpu":
        col_of_row, sweeps, _ = gated_auction_sweeps(cost, row_valid, col_valid, threshold, max_sweeps)
    else:
        if not (cost.is_contiguous() and row_valid.is_contiguous() and col_valid.is_contiguous()):
            raise ValueError("cost, row_valid and col_valid must be contiguous")
        col_of_row = torch.empty(n_rows, dtype=torch.int64, device=cost.device)
        sweeps = torch.empty(1, dtype=torch.int32, device=cost.device)
        fn = _build.load(NAME).auction_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        err = fn(_build.ptr(cost), _build.ptr(row_valid), _build.ptr(col_valid), n_rows, n_cols, float(threshold),
                 int(max_sweeps), _build.ptr(col_of_row), _build.ptr(sweeps), _build.stream_ptr(cost.device))
        _build.check(err, "auction_kernel")
        _build.count(NAME)
    last_sweeps = sweeps
    return col_of_row, sweeps


def gated_auction_match(cost: torch.Tensor, row_valid: torch.Tensor, col_valid: torch.Tensor, threshold: float,
                        max_sweeps: int = 128) -> torch.Tensor:
    """The tracker's threshold-gated matching (see
    :func:`apse_uav_torch.dcnn.hungarian.gated_auction_match`): col_of_row
    (R,) int64, -1 = unmatched."""
    return solve(cost, row_valid, col_valid, threshold, max_sweeps)[0]
