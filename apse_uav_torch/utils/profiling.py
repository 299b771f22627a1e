"""Spans, counters and traces of the port (the reference's tracing subsystem).

Counterpart of the JAX reference's ``utils/profiling.py``, which replaces the
reference's ``perf_counter`` + ``torch.cuda.synchronize`` brackets
(selective_rcnn.py:46-76, selective_rpn.py:55-85) with one recorder:

* :func:`span` -- a named stretch of host time at a layer boundary of the
  main path (``track.features``, ``aruco.candidates``, ...).  Off by
  default, where it costs one flag test and returns a shared no-op context.
  On (:func:`enable_spans`), it keeps ``(name, start_ns, end_ns, parent,
  batch)`` in memory, stamped with ``time.time_ns()``: the Unix clock that
  ``torch.profiler`` also keeps (its trace starts at
  ``kineto_results.trace_start_ns()``), so a span can be set against the
  kernels and idle gaps of a trace.  Under an active ``torch.profiler`` it
  also opens ``record_function(name)``, so the span lands in the trace
  beside the kernels.  Spans are read at the end (:func:`spans`,
  :func:`summary`, :func:`self_ns`); one thread records them.
* :data:`counters` -- one dict of counts, always kept: ``launch.<kernel>``
  for every launch of a hand-written kernel (``_build.count``) and
  ``sync.<site>`` for every host sync of the main path on the card
  (:func:`sync`, which is also a span): the deliberate ones (convergence
  tests, copies to and from the host) and those an op makes by itself (a
  constant copied from the host, an index by a device scalar,
  ``linalg.inv``'s error check).  A span that waits on the device carries
  ``sync.`` in its name.
* :func:`trace` -- a ``torch.profiler`` context (CPU and, on a card, CUDA
  activity) that writes a Chrome trace into ``logdir``, spans on;
* :func:`benchmark` -- warm-up and timed calls whose inputs depend serially
  on the previous call's output (the reference's seed chaining), ending in
  a synchronize.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, NamedTuple

import torch

from apse_uav_torch.device import synchronize

# -- counters ------------------------------------------------------------------

counters: dict[str, int] = {}


def count(name: str, n: int = 1) -> None:
    counters[name] = counters.get(name, 0) + n


def reset_counters() -> None:
    counters.clear()


def counted(prefix: str) -> dict[str, int]:
    """The counters named ``<prefix>.<rest>``, by ``rest`` (``counted("launch")``:
    launches by kernel)."""
    head = prefix + "."
    return {k[len(head):]: v for k, v in counters.items() if k.startswith(head)}


# -- spans ---------------------------------------------------------------------


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int  # 0 while the span is open
    parent: int  # index of the enclosing span in spans(), -1 for none
    batch: int | None  # the call or batch the span belongs to (its parent's where not given)


_on = False
_spans: list[list] = []
_open: list[int] = []
_NOOP = contextlib.nullcontext()


class _Recording:
    __slots__ = ("name", "batch", "index", "fn")

    def __init__(self, name: str, batch):
        self.name, self.batch = name, batch

    def __enter__(self):
        parent = _open[-1] if _open else -1
        batch = self.batch if self.batch is not None or parent < 0 else _spans[parent][4]
        self.fn = None
        if torch.autograd._profiler_enabled():
            self.fn = torch.profiler.record_function(self.name)
            self.fn.__enter__()
        self.index = len(_spans)
        _spans.append([self.name, time.time_ns(), 0, parent, batch])
        _open.append(self.index)
        return self

    def __exit__(self, *exc):
        _spans[self.index][2] = time.time_ns()
        _open.pop()
        if self.fn is not None:
            self.fn.__exit__(*exc)
        return False


def span(name: str, batch: int | None = None):
    """A context that records the block as the span ``name`` when spans are
    on; off, the shared no-op context."""
    if not _on:
        return _NOOP
    return _Recording(name, batch)


def sync(site: str, n: int = 1):
    """``n`` host syncs at ``site``: counts ``sync.<site>`` by ``n`` and
    returns the span ``sync.<site>`` for the wait."""
    name = "sync." + site
    count(name, n)
    return span(name)


def enable_spans(on: bool = True) -> None:
    global _on
    _on = bool(on)


def reset_spans() -> None:
    """Forget every span recorded so far (none may be open)."""
    if _open:
        raise RuntimeError(f"{len(_open)} spans are open")
    _spans.clear()


def spans() -> list[Span]:
    """The spans recorded since the last reset, in the order they opened."""
    return [Span(*s) for s in _spans]


def self_ns(recorded: list[Span]) -> list[int]:
    """Each span's self time: its duration less what its child spans cover."""
    out = [s.end_ns - s.start_ns for s in recorded]
    for s in recorded:
        if s.parent >= 0:
            out[s.parent] -= s.end_ns - s.start_ns
    return out


def summary(recorded: list[Span] | None = None) -> dict[str, dict[str, int]]:
    """By span name: ``n`` spans, ``ns`` their host time, ``self_ns`` their
    self time and ``sync_ns`` the host time of the ``sync.*`` spans under
    them (the outermost where they nest), of the finished spans."""
    recorded = spans() if recorded is None else recorded
    selfs = self_ns(recorded)
    out: dict[str, dict[str, int]] = {}
    for s, own in zip(recorded, selfs):
        if s.end_ns == 0:
            continue
        row = out.setdefault(s.name, {"n": 0, "ns": 0, "self_ns": 0, "sync_ns": 0})
        row["n"] += 1
        row["ns"] += s.end_ns - s.start_ns
        row["self_ns"] += own
    for s in recorded:
        if s.end_ns == 0 or not s.name.startswith("sync."):
            continue
        chain, p = [], s.parent
        while p >= 0 and not recorded[p].name.startswith("sync."):
            chain.append(recorded[p].name)
            p = recorded[p].parent
        if p >= 0:
            continue  # inside another sync span, which counts it
        for name in set(chain):
            if name in out:
                out[name]["sync_ns"] += s.end_ns - s.start_ns
    return out


# -- traces and timed calls ----------------------------------------------------


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


@contextlib.contextmanager
def trace(logdir: str):
    """A ``torch.profiler`` trace of the block (CPU activity, and CUDA
    activity when a card is visible), spans on, written to
    ``logdir/trace.json`` in Chrome's format (Perfetto and chrome://tracing
    open it): the program's spans beside the ops and kernels they issued.
    Yields the profiler (``key_averages()`` sums by kernel)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(logdir, exist_ok=True)
    was_on = _on
    enable_spans(True)
    try:
        with profile(activities=activities) as prof:
            yield prof
    finally:
        enable_spans(was_on)
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
