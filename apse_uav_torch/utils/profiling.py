"""Profiling and per-stage timing (the reference's tracing subsystem).

Counterpart of the JAX reference's ``utils/profiling.py``, which replaces the
reference's ``perf_counter`` + ``torch.cuda.synchronize`` brackets
(selective_rcnn.py:46-76, selective_rpn.py:55-85):

* :class:`StageTimer` -- wall-clock seconds per named stage, each stage
  ending with a synchronize of the device its result lies on;
* :func:`trace` -- a ``torch.profiler`` context (CPU and, on a card, CUDA
  activity) that writes a Chrome trace into ``logdir``;
* :func:`benchmark` -- warm-up and timed calls whose inputs depend serially
  on the previous call's output (the reference's seed chaining), ending in
  a synchronize.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable

import torch

from apse_uav_torch.device import synchronize


def _sync(result) -> None:
    """Wait for the device of the first tensor found in ``result`` (a tensor
    or a nested tuple / list / dict of them); nothing to wait for on the CPU."""
    if isinstance(result, torch.Tensor):
        synchronize(result.device)
        return
    items = result.values() if isinstance(result, dict) else result if isinstance(result, (list, tuple)) else ()
    for item in items:
        _sync(item)
        return


class StageTimer:
    """Accumulates wall-clock seconds per named stage, device-synchronized."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    def _add(self, name: str, dt: float) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    @contextlib.contextmanager
    def stage(self, name: str, result_ref: list | None = None):
        """Time the block; put its result in ``result_ref[0]`` to wait for
        that result's device before the clock stops."""
        t0 = time.perf_counter()
        yield
        if result_ref:
            _sync(result_ref[0])
        self._add(name, time.perf_counter() - t0)

    def timed(self, name: str, fn: Callable) -> Callable:
        """``fn`` wrapped to time each call up to a synchronize of its result's device."""

        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            _sync(out)
            self._add(name, time.perf_counter() - t0)
            return out

        return wrapped

    def summary(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name}: total {total * 1e3:.2f} ms, {n} calls, avg {total / n * 1e3:.2f} ms")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str):
    """A ``torch.profiler`` trace of the block (CPU activity, and CUDA
    activity when a card is visible) written to ``logdir/trace.json`` in
    Chrome's format (Perfetto and chrome://tracing open it).  Yields the
    profiler (``key_averages()`` sums by kernel)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _next_seed(out) -> torch.Tensor:
    """(first element of the output as uint32 % 251) + 1, on its device."""
    first = torch.as_tensor(out).reshape(-1)[0]
    return (first.to(torch.int64) % 251 + 1).to(torch.int32)


def benchmark(fn: Callable[[Any, torch.Tensor], torch.Tensor], example: Any, iters: int = 10,
              warmup: int = 1) -> float:
    """Seconds per call of ``fn(example, seed)``.

    ``fn`` folds the int32 tensor ``seed`` into its computation and returns
    a tensor from which the next seed is derived, so that every call is
    unique and serially dependent on the one before; the clock stops after
    a synchronize of the last seed's device."""
    seed = torch.ones((), dtype=torch.int32)
    for _ in range(warmup):
        seed = _next_seed(fn(example, seed))
    _sync(seed)
    t0 = time.perf_counter()
    for _ in range(iters):
        seed = _next_seed(fn(example, seed))
    _sync(seed)
    return (time.perf_counter() - t0) / iters
