"""The chip check, the device record of a result line and the card's power limit."""

from __future__ import annotations

import subprocess


class NoChip(RuntimeError):
    """Fewer CUDA devices than the cell asks for: the run prints no result."""


def require(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise NoChip("torch.cuda.is_available() is False")
    if torch.cuda.device_count() < chips:
        raise NoChip(f"the cell asks for {chips} CUDA devices, {torch.cuda.device_count()} visible")


def device_record(device, chips: int) -> dict:
    """``device`` of the result line: platform, the card's name, cards used,
    the peak of allocated memory on the card (``max_memory_allocated``)."""
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them, or "unknown"."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    lines = out.strip().splitlines()
    return lines[0].strip() if lines else "unknown"
