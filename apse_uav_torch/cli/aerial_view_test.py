"""Aerial-view detector smoke test on the PyTorch port (reference aerial_view_test.py:50-71).

The original script runs a 3-class Faster R-CNN (car/truck/bus, no mask
head) fine-tuned on aerial imagery over ``./test_images`` and shows each
annotated frame.  This CLI is the headless equivalent, as in the JAX
reference: ``detector_test`` with the aerial defaults -- 3 classes, R50, no
mask head -- and annotated copies written next to the inputs.  Explicit
flags win; ``--with_mask`` turns the mask head back on.  ``--device
cuda|cpu`` as in ``detector_test``.

Usage:
    python -m apse_uav_torch.cli.aerial_view_test \
        --images test_images/ --weights aerial_frcnn.pth
"""

from __future__ import annotations

import sys

from apse_uav_torch.cli import detector_test


def aerial_argv(argv: list[str]) -> list[str]:
    """``argv`` with the aerial defaults added where the user gave none."""
    argv = list(argv)
    if "--num_classes" not in argv:
        argv += ["--num_classes", "3"]
    if "--depth" not in argv:
        argv += ["--depth", "50"]
    if "--with_mask" in argv:
        argv.remove("--with_mask")
    elif "--no_mask" not in argv:
        argv.append("--no_mask")
    return argv


def main(argv=None) -> int:
    return detector_test.main(aerial_argv(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    raise SystemExit(main())
