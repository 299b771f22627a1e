"""What the benchmark may not load: JAX, its libraries and the JAX package.

Names are compared whole by their top-level part (before the first dot):
the measured package's name begins with the JAX package's, and is allowed."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "apse_uav_tpu")


def forbidden_loaded(modules=None) -> list[str]:
    """The loaded modules whose top-level name is in FORBIDDEN, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)
