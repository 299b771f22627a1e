#!/usr/bin/env python3
"""Time kernel K1 of the PyTorch port (``apse_uav_torch/csrc/labeling.cu``) on one GPU.

Run from the repository root on a machine with an NVIDIA GPU and nvcc:

    python3 scripts/bench_torch_labeling.py [--windows 600] [--iters 50] [SOURCE.cu ...]

Builds each source (default: the package's ``labeling.cu``) with the package's
nvcc flags, one nvcc each, all started together, and prints its ptxas line.
Checks every source bit for bit against the plain version
(``detector._label_sweeps``) on the windows below, then times each with CUDA
events (launches back to back, the best of 5 runs of ``--iters``), sources in
turns, at the full schedule (3 rounds, 8 mop steps) and at its parts: sweeps
only (mop 0), mop steps only (rounds 0) and neither (mask load, label
initialisation and store).  Windows: 64x64, the hard masks of
``utils.synthetic.labeling_masks`` and uniform noise of densities 0.3, 0.5 and
0.8 in turns, made from seed 0.  Prints one JSON line per source and the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARTS = {"full": (3, 8), "sweeps": (3, 0), "mop": (0, 8), "none": (0, 0)}


def build(sources: list[str]) -> dict[str, tuple[ctypes.CDLL, str]]:
    from apse_uav_torch import _build

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    procs = {}
    for src in sources:
        with open(src, "rb") as f:
            key = hashlib.sha256(f.read()).hexdigest()[:16]
        out = os.path.join(_build.BUILD_DIR, f"bench_labeling_{key}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, src]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for src, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")
        lib = ctypes.CDLL(out)
        lib.labels_launch.restype = ctypes.c_int
        lib.labels_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        libs[src] = (lib, " ".join(ln.strip() for ln in log.splitlines() if "registers" in ln))
    return libs


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="*", default=[os.path.join(REPO, "apse_uav_torch", "csrc", "labeling.cu")])
    ap.add_argument("--windows", type=int, default=600)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_torch_labeling: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from apse_uav_torch.aruco import detector as det
    from apse_uav_torch.utils.synthetic import labeling_masks

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    hard = list(labeling_masks(64).values())
    noise = [rng.random((64, 64)) < (0.3, 0.5, 0.8)[i % 3] for i in range(args.windows - len(hard))]
    dark = torch.from_numpy(np.stack(hard + noise)).to(dev).contiguous()
    k = dark.shape[0]
    out = torch.empty((k, 64, 64), dtype=torch.int32, device=dev)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    libs = build(args.sources)

    def launch(lib, rounds, mop):
        err = lib.labels_launch(ctypes.c_void_p(dark.data_ptr()), ctypes.c_void_p(out.data_ptr()), k, 64, rounds, mop,
                                stream)
        if err:
            raise RuntimeError(f"labels_launch: cudaError_t {err}")

    want = det._label_sweeps(dark)
    for src, (lib, _) in libs.items():
        launch(lib, 3, 8)
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise RuntimeError(f"{src}: {int((out != want).sum())} labels differ from the plain version")

    times = {src: {part: [] for part in PARTS} for src in libs}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(5):
        for src, (lib, _) in libs.items():
            for part, (rounds, mop) in PARTS.items():
                for _ in range(3):
                    launch(lib, rounds, mop)
                start.record()
                for _ in range(args.iters):
                    launch(lib, rounds, mop)
                end.record()
                torch.cuda.synchronize()
                times[src][part].append(start.elapsed_time(end) / args.iters)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    for src, (_, ptxas) in libs.items():
        print(json.dumps({"source": os.path.relpath(src, REPO), "windows": k, "bit_identical": True,
                          "ms": {part: min(v) for part, v in times[src].items()}, "ptxas": ptxas}), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
