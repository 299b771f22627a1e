"""Device loops that run to a fixed point, testing convergence every few steps.

The reference runs its data-dependent loops (the NMS fixed point, the
auction) as ``lax.while_loop``s on the device.  In PyTorch each convergence
test is a device-to-host copy, which stalls the host until the device has
caught up.  Both loops have a step that maps a converged state to itself, so
running a few steps past convergence changes nothing: :func:`run_until`
tests only every ``every`` steps and returns the same bits as a loop that
tests after every step.  Each test is a host sync on the card, counted as
``sync.<site>`` in :data:`apse_uav_torch.utils.profiling.counters` and
recorded as that span.
"""

from __future__ import annotations

from typing import Callable, TypeVar

import torch

from apse_uav_torch.utils import profiling

S = TypeVar("S")


def run_until(step: Callable[[S], S], state: S, done: Callable[[S], torch.Tensor], max_steps: int,
              every: int = 8, *, site: str) -> S:
    """Apply ``step`` until ``done(state)`` (a 0-d bool tensor) holds or
    ``max_steps`` steps have run, testing ``done`` after every ``every`` steps
    (each test the sync ``site``).

    ``step`` must map a state for which ``done`` holds to itself; then the
    result equals that of testing after every step, with at most
    ``max_steps`` steps either way."""
    steps = 0
    while steps < max_steps:
        n = min(every, max_steps - steps)
        for _ in range(n):
            state = step(state)
        steps += n
        with profiling.sync(site):
            converged = bool(done(state))
        if converged:
            break
    return state
