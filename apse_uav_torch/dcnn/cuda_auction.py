"""Wrapper of the gated auction kernels (``csrc/auction.cu``): the tracker's association solver.

Replaces the JAX reference's ``dcnn/hungarian.py`` ``gated_auction_match``, a
``lax.while_loop`` that runs on the device (no Pallas kernel).  On a CPU
tensor it runs the plain version,
:func:`apse_uav_torch.dcnn.hungarian.gated_auction_sweeps`; on a CUDA tensor
it launches a kernel, one launch a problem and no host sync, or raises.
Two kernels compute the function, chosen by shape (:func:`kernel_for`): the
warp kernel (one warp a problem) up to 32 x 32, the tracker's size, and the
block kernel (one block a problem) above it, up to 1,024 x 1,024.  The
result is bit-identical either way: each kernel runs the plain version's
float32 operations in its order, with its ties to the lower index.

The sweep count of each call stays on the tensor's device: :func:`solve`
returns it and :data:`last_sweeps` holds the last one.  Nothing here reads
it back.  Launches are counted per kernel (``_build.launches[WARP]``,
``[BLOCK]``).
"""

from __future__ import annotations

import ctypes

import torch

from apse_uav_torch import _build
from apse_uav_torch.dcnn.hungarian import gated_auction_sweeps

# The source, csrc/auction.cu.
NAME = "auction"
# Its kernels, by their launch-count names: the warp kernel and the block kernel.
WARP = "auction_warp"
BLOCK = "auction_block"
KERNELS = (WARP, BLOCK)
# Each kernel's C entry point and its name in a profiler trace.
ENTRY = {WARP: "auction_warp_launch", BLOCK: "auction_launch"}
DEVICE_NAME = {WARP: "auction_warp_kernel", BLOCK: "auction_kernel"}
# The kernels' limits; the CLIs' TrackerConfig is 32 x 32.
WARP_MAX = 32
MAX_ROWS = 1024
MAX_COLS = 1024

# The last call's sweep count, (1,) int32 on the input's device.
last_sweeps: torch.Tensor | None = None
# The kernels' C entry points, their argument types set (see _entry).
_entries: dict = {}


def kernel_for(rows: int, cols: int) -> str:
    """The kernel that solves a rows x cols problem on the card: WARP up to
    32 x 32, BLOCK above in either dimension."""
    return WARP if rows <= WARP_MAX and cols <= WARP_MAX else BLOCK


def _entry(kernel: str):
    """The C entry point of ``kernel`` (WARP or BLOCK), loaded once."""
    fn = _entries.get(kernel)
    if fn is None:
        fn = getattr(_build.load(NAME), ENTRY[kernel])
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        _entries[kernel] = fn
    return fn


def solve(cost: torch.Tensor, row_valid: torch.Tensor, col_valid: torch.Tensor, threshold: float,
          max_sweeps: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """cost (R, D) float32, row_valid (R,) bool, col_valid (D,) bool, all on
    one device -> (col_of_row (R,) int64 with -1 = unmatched, sweeps (1,)
    int32), the matching of :func:`gated_auction_match` and its sweep count.
    On a CUDA tensor it launches the kernel :func:`kernel_for` names."""
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
        kernel = kernel_for(n_rows, n_cols)
        err = _entry(kernel)(_build.ptr(cost), _build.ptr(row_valid), _build.ptr(col_valid), n_rows, n_cols,
                             float(threshold), int(max_sweeps), _build.ptr(col_of_row), _build.ptr(sweeps),
                             _build.stream_ptr(cost.device))
        _build.check(err, DEVICE_NAME[kernel])
        _build.count(kernel)
    last_sweeps = sweeps
    return col_of_row, sweeps


def gated_auction_match(cost: torch.Tensor, row_valid: torch.Tensor, col_valid: torch.Tensor, threshold: float,
                        max_sweeps: int = 128) -> torch.Tensor:
    """The tracker's threshold-gated matching (see
    :func:`apse_uav_torch.dcnn.hungarian.gated_auction_match`): col_of_row
    (R,) int64, -1 = unmatched."""
    return solve(cost, row_valid, col_valid, threshold, max_sweeps)[0]
