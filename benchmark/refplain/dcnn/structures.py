"""Fixed-capacity track store (the reference's ``dcnn/structures.py``).

A dict of fixed-capacity tensors plus an ``active`` mask, so a tracker
update is a function of tensors with fixed shapes.  Masks are kept as (R, R)
probabilities in box coordinates (the mask head's output) and pasted at
full resolution on the host when a CSV row or an image needs them.
"""

from __future__ import annotations

import torch

from refplain.device import resolve_device


def init_track_state(max_tracks: int, embedding_dim: int = 128, mask_res: int = 28,
                     device="cuda") -> dict[str, torch.Tensor]:
    """Empty track store of capacity ``max_tracks`` on ``device``."""
    dev = resolve_device(device)
    t = max_tracks
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "active": torch.zeros(t, dtype=torch.bool, device=dev),
        "ids": torch.zeros(t, **i32),
        "detected_this_frame": torch.zeros(t, dtype=torch.bool, device=dev),
        "frames_since_detected": torch.zeros(t, **i32),
        "boxes": torch.zeros((t, 4), **f32),
        "scores": torch.zeros(t, **f32),
        "classes": torch.zeros(t, **i32),
        "masks": torch.zeros((t, mask_res, mask_res), **f32),
        "embeddings": torch.zeros((t, embedding_dim), **f32),
        "next_id": torch.ones((), **i32),  # ids start at 1
    }


def delete_undetected(state: dict, frames_threshold: int) -> dict:
    """Deactivate tracks unseen for more than ``frames_threshold`` frames."""
    drop = state["active"] & (state["frames_since_detected"] > frames_threshold)
    return {**state, "active": state["active"] & ~drop}


def finish_association(state: dict) -> dict:
    """Age the counters at the end of a frame."""
    fsd = torch.where(state["detected_this_frame"], torch.zeros_like(state["frames_since_detected"]),
                      state["frames_since_detected"] + 1)
    return {**state, "frames_since_detected": torch.where(state["active"], fsd, state["frames_since_detected"]),
            "detected_this_frame": torch.zeros_like(state["detected_this_frame"])}


def recent_objects(state: dict) -> dict:
    """Snapshot of the tracks detected this frame: the same capacity, with a
    ``valid`` mask instead of a shorter list."""
    return {"valid": state["active"] & state["detected_this_frame"],
            **{k: state[k] for k in ("ids", "boxes", "scores", "classes", "masks", "embeddings")}}
