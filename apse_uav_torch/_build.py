"""Build and load the hand-written Hopper kernels in ``csrc/``.

Each ``csrc/<name>.cu`` exposes plain C entry points that take device
pointers (``tensor.data_ptr()``), ``int`` sizes and the CUDA stream, launch
their kernel and return ``cudaGetLastError()``.  They are compiled with
``nvcc`` for ``sm_90a`` into a shared library under ``apse_uav_torch/_build/``
(git-ignored) on first use, keyed by a hash of the source and the flags, and
loaded with ``ctypes`` -- no PyTorch headers, so a build takes seconds.

``-fmad=false`` keeps ``a*b + c`` as two IEEE roundings, the same as the
plain PyTorch versions (one elementwise op per rounding), which is what the
bit-exactness contracts of the kernels rely on.

Every wrapper calls :func:`count` right after a launch succeeded; the
counts are ``launch.<kernel>`` in :data:`apse_uav_torch.utils.profiling.counters`,
so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

from apse_uav_torch.utils import profiling

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
)
SOURCES = ("auction", "gconv", "labeling", "pool", "proposals", "remap")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def count(name: str) -> None:
    profiling.count("launch." + name)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return path


def _target(name: str) -> str:
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}_{key}.so")


def build(names=SOURCES) -> dict[str, str]:
    """Compile the named sources that are not built yet, one nvcc each, all
    started together.  Returns {name: nvcc/ptxas log} for what was built.
    Raises RuntimeError with the compiler output if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out)
    logs, errors = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(_target(name))
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError_t {err}")


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
