"""Wrapper of kernel K1 (``csrc/labeling.cu``): component labels of candidate windows.

Replaces the JAX reference's ``aruco/pallas_labeling.py`` (``labels_batched``).  On
a CPU tensor it runs the plain version,
:func:`apse_uav_torch.aruco.detector._label_sweeps`; on a CUDA tensor it
launches the kernel or raises.  Output is bit-identical either way: the
schedule is integer arithmetic and a prefix min does not depend on the scan
order.  ``_largest_from_labels`` stays plain PyTorch after the kernel, as
the reference keeps it in XLA outside its Pallas call.
"""

from __future__ import annotations

import ctypes

import torch

from apse_uav_torch import _build
from apse_uav_torch.aruco.detector import _label_sweeps

NAME = "labeling"
MAX_WIN = 64


def labels(dark: torch.Tensor, rounds: int = 3, mop: int = 8) -> torch.Tensor:
    """dark (K, win, win) bool -> (K, win, win) int32 labels (root y*win + x;
    sentinel win*win on non-dark cells)."""
    if dark.dtype != torch.bool or dark.dim() != 3 or dark.shape[1] != dark.shape[2]:
        raise ValueError(f"dark must be (K, win, win) bool, got {tuple(dark.shape)} {dark.dtype}")
    if dark.device.type == "cpu":
        return _label_sweeps(dark, rounds, mop)
    k, win, _ = dark.shape
    if win > MAX_WIN:
        raise ValueError(f"window {win} exceeds the kernel's {MAX_WIN}")
    if not dark.is_contiguous():
        raise ValueError("dark must be contiguous")
    out = torch.empty((k, win, win), dtype=torch.int32, device=dark.device)
    if k == 0:
        return out
    lib = _build.load("labeling")
    fn = lib.labels_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    err = fn(_build.ptr(dark), _build.ptr(out), k, win, rounds, mop, _build.stream_ptr(dark.device))
    _build.check(err, "labels_kernel")
    _build.count(NAME)
    return out
