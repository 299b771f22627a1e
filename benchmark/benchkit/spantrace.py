"""One profiled stretch, as :func:`benchkit.trace.profile` reads it, plus the
device seconds of the kernels that the program launched inside some of its
own spans.

The program opens ``torch.profiler.record_function(name)`` for each of its
spans while spans are on and a profiler runs (``utils/profiling.py``), so a
span is a host interval in the profiler's events.  A kernel or copy belongs
to a span when the runtime call that queued it (matched by correlation id)
ran inside one of the span's intervals; its device time counts there,
wherever on the card's clock it ran.
"""

from __future__ import annotations

import bisect
import time

from benchkit import trace
from benchkit.clock import sync

# Runtime calls that queue work on the card (their correlation id is the kernel's).
QUEUING = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx", "cudaMemcpyAsync",
           "cudaMemsetAsync")


def profile(fn, device, spans) -> dict:
    """Run fn() once under torch.profiler: :func:`benchkit.trace.profile`'s
    record and ``span_device_s``, the device seconds launched inside each
    of the span names ``spans`` (0 for one that never opened or launched
    nothing, and on a machine with no card)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile, record_function

    sync(device)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with tprofile(activities=activities) as prof:
        with record_function(trace._PRIMER):
            torch.ones(1, device=device).add_(1)
            sync(device)
        t0 = time.perf_counter()
        fn()
        sync(device)
        window_s = time.perf_counter() - t0
    events = prof.events()
    return {**trace.read_events(events, window_s), "span_device_s": span_device_s(events, spans)}


def span_device_s(events, spans) -> dict[str, float]:
    """By span name: the device seconds of the kernels and copies whose
    runtime call ran while a span of that name was open."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    intervals = {name: [] for name in spans}
    launched, device = {}, []
    for e in events:
        if e.device_type == cuda:
            annotation = getattr(e, "is_user_annotation", False) or e.name in intervals
            if not annotation and e.time_range.end > e.time_range.start:
                device.append(e)
        elif e.name in intervals:
            intervals[e.name].append((e.time_range.start, e.time_range.end))
        elif e.name.startswith(QUEUING):
            launched[e.id] = e.time_range.start
    out = {}
    for name, ivs in intervals.items():
        ivs.sort()
        starts = [s for s, _ in ivs]
        total = 0.0
        for k in device:
            t = launched.get(k.id)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= ivs[i][1]:
                total += (k.time_range.end - k.time_range.start) * 1e-6
        out[name] = total
    return out
