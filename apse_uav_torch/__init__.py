"""PyTorch + CUDA port of apse-uav: the ArUco measurement pipeline, the
DCNN (Mask R-CNN) vehicle tracker, its training and tools, and frame / data
parallelism over several cards (``parallel/``).

The JAX package beside it in this repository is the reference; this package
mirrors its layout and names (``aruco/detector.py`` there is
``apse_uav_torch/aruco/detector.py`` here) so each counterpart is easy to
find.  It imports ``torch`` and ``numpy`` only: never ``jax`` and nothing of
the JAX package, keeping its own copy of what it needs.

Every entry point takes an explicit ``device`` and runs on ``"cuda"`` unless
the caller asks for ``"cpu"``; asking for CUDA where there is none raises
(see :mod:`apse_uav_torch.device`).  On a CUDA tensor each kernel wrapper
(``cuda_*.py``) launches its hand-written Hopper kernel (``csrc/*.cu``); on a
CPU tensor it runs the kernel's plain PyTorch version.  The DCNN package
(``dcnn/``) has no kernel of its own: its convolutions and matrix products
are library calls, the rest plain PyTorch.
"""

from apse_uav_torch.device import resolve_device

__all__ = ["resolve_device"]
