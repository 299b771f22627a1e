"""Device resolution (CUDA unless the caller asks for the CPU, never a
fallback) and waiting for a device."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return the torch device for ``device`` ("cuda", "cuda:N" or "cpu").

    Raises RuntimeError when CUDA is asked for and no card is visible: the
    port never silently runs a CUDA request on the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch.cuda.is_available() is False "
                "(pass device='cpu' to run the plain PyTorch path)"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}: use 'cuda' or 'cpu'")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for ``device`` to finish its queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
