"""Cells of the benchmark cut to a size the CPU runs in seconds, for the tests.

The configuration and traffic files are read as they are and then cut: the
frame to 960x544 (the camera matrix scaled with it, the drone at 12 m and
the vehicles closer together, so the markers keep their size in pixels),
fewer distinct frames, smaller batches; for the tracker R50-FPN on 320x192
frames resized to 64x128 with 100 proposals.  The widths of the tracker's
heads stay as they are."""

from __future__ import annotations

import copy
import os
import sys
import time

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)
sys.path.insert(1, os.path.dirname(BENCH))

import numpy as np  # noqa: E402

from benchkit import spec  # noqa: E402
from benchkit.context import RunContext  # noqa: E402


def small_cell(name: str):
    """(cell, config, traffic) of ``name`` cut to the CPU's size."""
    cell = spec.find_cell(name)
    cfg, tr = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
    w, h = (320, 192) if cfg["family"] == "tracker" else (960, 544)
    s = w / cfg["frame_wh"][0]
    mtx = np.array(cfg["camera"]["mtx"])
    mtx[:2] *= s
    cfg["camera"]["mtx"], cfg["frame_wh"] = mtx.tolist(), [w, h]
    tr["altitude_m"] = 12.0
    tr["distinct_frames"] = 4
    tr["batch"] = min(tr["batch"], 2)
    tr["jitter_xy_m"] = 0.1
    for mk in tr["markers"]:
        mk["xy"] = [mk["xy"][0] * 0.3, mk["xy"][1] * 0.3]
    tr["check_batches"] = 3
    if cfg["family"] == "tracker":
        m = cfg["model"]
        m["depth"] = 50
        m["input"]["min_size_test"], m["input"]["max_size_test"] = 64, 128
        m["rpn"]["pre_nms_topk_test"] = m["rpn"]["post_nms_topk_test"] = 100
    return cell, cfg, tr


def run_small(name: str, seed: int = 2 ** 33 + 5, seconds: float = 3.0, trace: bool = False, program: str = "port",
              break_program=None) -> dict:
    """One run of the cut cell on the CPU through its driver, as ``run.py`` drives it."""
    import torch

    cell, cfg, tr = small_cell(name)
    ctx = RunContext(cfg, tr, seed, seconds, trace, torch.device("cpu"), time.perf_counter(), program, break_program)
    return cell.driver.run(ctx)
