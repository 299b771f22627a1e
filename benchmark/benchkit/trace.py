"""One profiled stretch of a cell's timed path, read from ``torch.profiler``.

The record a stretch leaves is what the per-layer readers in ``metrics/``
read: the stretch's wall seconds, the device's busy seconds (the union of
kernel intervals), every kernel's name, start and length, and the longest
idle gaps named by what the host was doing (the benchmark's own span around
them, and the innermost PyTorch op)."""

from __future__ import annotations

import bisect
import time

from benchkit.clock import sync

# The profiler dropped the first kernel of its window until one small op ran ahead of it.
_PRIMER = "bench.primer"


def profile(fn, device) -> dict:
    """Run fn() once under torch.profiler (CPU and CUDA activity) and read the trace.

    Returns {"window_s", "busy_s", "kernels": [(name, start_us, dur_us)] (copies
    included), "launches" (kernels alone),
    "device_ops": [[name, seconds]] (10 largest by device time),
    "idle_gaps": [[what the host did, seconds]] (10 largest)}."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile, record_function

    sync(device)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with tprofile(activities=activities) as prof:
        with record_function(_PRIMER):
            torch.ones(1, device=device).add_(1)
            sync(device)
        t0 = time.perf_counter()
        fn()
        sync(device)
        window_s = time.perf_counter() - t0
    return read_events(prof.events(), window_s)


def read_events(events, window_s: float) -> dict:
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    primer_end = 0.0
    kernels, host = [], []
    for e in events:
        if e.name == _PRIMER:
            primer_end = max(primer_end, e.time_range.end)
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            annotation = getattr(e, "is_user_annotation", False) or e.name.startswith("bench.")
            if start >= primer_end and end > start and not annotation:
                kernels.append((e.name, start, end - start))
        elif start >= primer_end:
            host.append((start, end, e.name))
    kernels.sort(key=lambda k: k[1])
    busy_us, gaps = 0.0, []
    cur_s = cur_e = None
    for _, s, d in kernels:
        e = s + d
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    by_op: dict[str, float] = {}
    for name, _, d in kernels:
        by_op[name] = by_op.get(name, 0.0) + d * 1e-6
    launches = sum(1 for name, _, _ in kernels if not name.startswith(("Memcpy", "Memset")))
    return {"window_s": window_s, "busy_s": busy_us * 1e-6, "kernels": kernels, "launches": launches,
            "device_ops": top(by_op), "idle_gaps": top(name_gaps(gaps, host))}


def top(totals: dict, n: int = 10) -> list:
    return [[k[:120], v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:n]]


def name_gaps(gaps, host, longest: int = 500) -> dict:
    """Seconds of device idle by what the host was doing in the middle of each
    of the ``longest`` gaps: the benchmark's span (``bench.*``) around it and
    the innermost op; the shorter gaps are summed under one name."""
    host = sorted(host)
    starts = [h[0] for h in host]
    spans = [h for h in host if h[2].startswith("bench.")]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])
    out: dict[str, float] = {}
    for g0, g1 in gaps[:longest]:
        mid = (g0 + g1) / 2
        i = bisect.bisect_right(starts, mid)
        inner = None
        for j in range(i - 1, max(i - 500, -1), -1):
            s, e, name = host[j]
            if e >= mid and not name.startswith("bench.") and (inner is None or e - s < inner[1] - inner[0]):
                inner = (s, e, name)
        around = [sp for sp in spans if sp[0] <= mid <= sp[1]]
        span = min(around, key=lambda sp: sp[1] - sp[0]) if around else None
        label = ((span[2] + ": ") if span else "") + (inner[2] if inner else "host (python)")
        out[label] = out.get(label, 0.0) + (g1 - g0) * 1e-6
    rest = gaps[longest:]
    if rest:
        shorter = f"the {len(rest)} gaps shorter than {rest[0][1] - rest[0][0]:.1f} us"
        out[shorter] = sum(g1 - g0 for g0, g1 in rest) * 1e-6
    return out
