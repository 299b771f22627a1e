"""Device loops that run to a fixed point, testing convergence every few steps.

The reference runs its data-dependent loops (the NMS fixed point, the
auction) as ``lax.while_loop``s on the device.  In PyTorch each convergence
test is a device-to-host copy, which stalls the host until the device has
caught up.  Both loops have a step that maps a converged state to itself, so
running a few steps past convergence changes nothing: :func:`run_until`
tests only every ``every`` steps and returns the same bits as a loop that
tests after every step.  ``checks`` counts the tests (each one host sync on
the card).
"""

from __future__ import annotations

from typing import Callable, TypeVar

import torch

S = TypeVar("S")

# Convergence tests made by run_until since the last reset (see reset_checks).
checks: dict[str, int] = {"count": 0}


def reset_checks() -> None:
    checks["count"] = 0


def run_until(step: Callable[[S], S], state: S, done: Callable[[S], torch.Tensor], max_steps: int,
              every: int = 8) -> S:
    """Apply ``step`` until ``done(state)`` (a 0-d bool tensor) holds or
    ``max_steps`` steps have run, testing ``done`` after every ``every`` steps.

    ``step`` must map a state for which ``done`` holds to itself; then the
    result equals that of testing after every step, with at most
    ``max_steps`` steps either way."""
    steps = 0
    while steps < max_steps:
        n = min(every, max_steps - steps)
        for _ in range(n):
            state = step(state)
        steps += n
        checks["count"] += 1
        if bool(done(state)):
            break
    return state
