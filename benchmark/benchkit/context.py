"""What a driver is given for one run, and the comparison it reports."""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass
class RunContext:
    """One run of one cell.

    ``program``: "port" runs the measured package; "control" puts the plain
    reference, one precision step down, in its place (the control of the
    comparison, never run by the benchmark's own runs).  ``break_program``,
    if given, is called with the built program before the warm-up (the
    tests' planted faults)."""

    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float
    program: str = "port"
    break_program: object = None


class Checks:
    """The numbers compared against the reference, each with its limit; a run
    is correct when every number is at most its limit (a NaN never is)."""

    def __init__(self, limits: dict[str, float]):
        self.limits = dict(limits)
        self.values = {k: 0.0 for k in limits}

    def note(self, name: str, value) -> None:
        v, cur = float(value), self.values[name]
        if not math.isnan(cur) and (math.isnan(v) or v > cur):
            self.values[name] = v

    def correct(self) -> bool:
        return all(v <= self.limits[k] for k, v in self.values.items())

    def as_dict(self) -> dict:
        return {k: {"value": v, "limit": self.limits[k]} for k, v in self.values.items()}


def check_sample(rng, n: int, k: int) -> list[int]:
    """``k`` of the ``n`` calls or batches of a window, drawn from ``rng``:
    the first (from the fresh state), the last, and the rest at random."""
    inner = rng.choice(np.arange(1, n - 1), size=min(max(k - 2, 0), n - 2), replace=False) if n > 2 else []
    return sorted({0, n - 1, *(int(v) for v in inner)})
