#!/usr/bin/env python3
"""The tracker cell of ``chip_smoke.py`` (phase 7: ``track_uav``'s path at full
width) from two checkouts, in turns on one card.

    python3 scripts/tracker_ab.py BEFORE_DIR AFTER_DIR [--rounds 2]

Each run is a fresh process that imports one checkout's ``chip_smoke.py`` and
``apse_uav_torch``, builds its kernels, renders phase 2's 8 frames at
3840x2160 on the card and calls its ``tracker_phase`` (which runs its own
checks).  The runs go before, after, after, before (``--rounds 2``), so that
both checkouts meet the same card, host and clocks.  Prints one JSON line a
run: batch ms, frames/s, stage ms, host syncs and convergence tests a batch,
device busy ms, idle share and kernel launches of the profiled batch, the
card's name and power limit, and digests of the run's outputs (the
snapshots of every frame and the CSV that ``track_uav`` wrote); then the
mean of each checkout, and whether every run's outputs are the same bit for
bit (exit code 1 if not).  Needs a CUDA card; a checkout's phase 7 that
fails stops the script.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CHILD = r"""
import os, sys
root = sys.argv[1]
sys.path.insert(0, root)
os.chdir(root)
import torch
import chip_smoke as cs
from apse_uav_torch import _build
from apse_uav_torch.core import camera
from apse_uav_torch.utils.synthetic import render_scene

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.build()
dev = torch.device("cuda", 0)
mtx, dist = camera.load_camera_params(os.path.join(root, "data", "cam_params.json"))
frames = torch.stack([render_scene(mtx, dist, (cs.W, cs.H), cs.scene_specs(i), altitude=40.0, supersample=1,
                                   device=dev) for i in range(cs.BATCH)]).cpu().numpy()
t7 = cs.tracker_phase(frames, mtx, dist, cs.nvidia_smi(), dev)

import hashlib, json
import numpy as np
digest = hashlib.sha256()
for i in sorted(t7["snaps"]):
    for k in sorted(t7["snaps"][i]):
        a = np.ascontiguousarray(np.asarray(t7["snaps"][i][k]))
        digest.update(f"{i} {k} {a.dtype} {a.shape}".encode())
        digest.update(a.tobytes())
with open(os.path.join(cs.OUT_DIR, "chip_smoke_dcnn.csv"), "rb") as f:
    csv = hashlib.sha256(f.read()).hexdigest()
print(json.dumps({"phase": "outputs", "snapshots_sha256": digest.hexdigest(), "csv_sha256": csv}))
"""

KEYS = ("batch_ms", "frames_per_s", "syncs_per_batch", "convergence_checks_per_batch")
DIGESTS = ("snapshots_sha256", "csv_sha256")


def run(root: str) -> dict:
    """One process running ``root``'s phase 7; its tracker and profile lines
    and its outputs' digests."""
    proc = subprocess.run([sys.executable, "-c", CHILD, os.path.abspath(root)], capture_output=True, text=True,
                          timeout=900)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise SystemExit(f"phase 7 of {root} failed (rc {proc.returncode})")
    lines = {}
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            obj = json.loads(line)
            lines[obj.get("phase")] = obj
    t, p = lines["tracker"], lines["tracker_profile"]
    out = {k: t[k] for k in KEYS}
    out.update({"stage_ms": t["stage_ms"], "device_busy_ms": p["device_busy_ms"],
                "device_idle_share": p["device_idle_share"], "kernel_launches": p["kernel_launches"],
                "card": t["card"]})
    out.update({k: lines["outputs"][k] for k in DIGESTS})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("before")
    ap.add_argument("after")
    ap.add_argument("--rounds", type=int, default=2, help="before/after pairs, in the order ABBA...")
    args = ap.parse_args()
    order = []
    for r in range(args.rounds):
        order += [args.before, args.after] if r % 2 == 0 else [args.after, args.before]
    results: dict[str, list] = {args.before: [], args.after: []}
    for root in order:
        res = run(root)
        results[root].append(res)
        print(json.dumps({"checkout": root, **res}), flush=True)
    for root, runs in results.items():
        mean = {k: sum(r[k] for r in runs) / len(runs) for k in KEYS + ("device_busy_ms", "device_idle_share",
                                                                         "kernel_launches")}
        mean["association_ms"] = sum(r["stage_ms"]["association"] for r in runs) / len(runs)
        print(json.dumps({"checkout": root, "runs": len(runs), "mean": mean}), flush=True)
    digests = {tuple(r[k] for k in DIGESTS) for runs in results.values() for r in runs}
    print(json.dumps({"outputs_identical": len(digests) == 1, "digests": sorted(digests)}), flush=True)
    return 0 if len(digests) == 1 else 1


if __name__ == "__main__":
    sys.exit(main())
