"""Host clocks that end in a synchronize, and the tail statistic."""

from __future__ import annotations

import statistics
import time


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def wall_ms(fn, device, iters: int = 5) -> float:
    """Host-clock ms per call of fn(), after one call to warm up; the clock
    starts and ends on a synchronized device."""
    fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync(device)
    return (time.perf_counter() - t0) * 1e3 / iters


def p95(values) -> float:
    """The 95th percentile of ``values`` (Python's ``statistics.quantiles``,
    exclusive method, 20 parts: the 19th cut)."""
    return statistics.quantiles(values, n=20)[18]
