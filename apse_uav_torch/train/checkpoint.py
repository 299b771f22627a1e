"""Checkpoints with the reference's last/bestAP/bestAR rules, as ``torch.save`` files.

Counterpart of the JAX reference's ``train/checkpoint.py``: a training state
is kept under three names in one directory -- ``last`` at every save,
``bestAP`` / ``bestAR`` whenever that validation metric reaches its best.
Each name is one file written by ``torch.save`` (the reference writes an
orbax directory of the same name).  The state is a dict:

* ``params``: the model's state dict (names -> tensors; the port's MaskRCNN
  is named as detectron2 names it, its AssociationHead ``fc.weight`` /
  ``fc.bias``);
* ``opt_state``: the optimizer's state
  (:meth:`apse_uav_torch.train.optim.SGD.state_dict`: the momentum traces,
  keyed like ``params``, the schedule count and the finite-check counters);
* ``iteration`` (``epoch`` for the association head), ``best_ap``, ``best_ar``;
* optionally ``results``: the text of the run's ``results.txt``.

``apse_uav_torch.convert.checkpoint_state`` turns a state the reference
saved (orbax, restored as nested arrays), its ``opt_state`` included, into
this one.  Files are read with ``weights_only=True``: tensors, numbers,
booleans and strings only.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch


def _path(directory: str, name: str) -> str:
    return os.path.join(os.path.abspath(directory), name)


def _tensors(x):
    """numpy arrays (and numpy scalars) in a nested state -> tensors / Python
    numbers; tensors detached and moved to the CPU."""
    if isinstance(x, dict):
        return {k: _tensors(v) for k, v in x.items()}
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.array(x))
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().clone()
    return x


def save_state(directory: str, name: str, state: dict[str, Any]) -> str:
    """Write ``state`` as ``directory/name`` (replacing it); returns the path."""
    os.makedirs(os.path.abspath(directory), exist_ok=True)
    path = _path(directory, name)
    tmp = path + ".tmp"
    torch.save(_tensors(state), tmp)
    os.replace(tmp, path)
    return path


def load_state(directory: str, name: str = "last") -> dict[str, Any] | None:
    """The state saved as ``directory/name`` (tensors on the CPU), or None if
    there is none."""
    path = _path(directory, name)
    if not os.path.exists(path):
        return None
    return torch.load(path, map_location="cpu", weights_only=True)


class CheckpointManager:
    """last / bestAP / bestAR in ``directory`` (the reference's finetune_uav.py:272-295 rules)."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.best_ap = -np.inf
        self.best_ar = -np.inf

    def resume(self) -> dict[str, Any] | None:
        """The ``last`` state, with the best metrics it carries taken over."""
        state = load_state(self.directory, "last")
        if state is not None:
            self.best_ap = float(state.get("best_ap", -np.inf))
            self.best_ar = float(state.get("best_ar", -np.inf))
        return state

    def save(self, state: dict[str, Any], ap: float | None = None, ar: float | None = None) -> list[str]:
        """Save ``state`` as ``last``, and as ``bestAP`` / ``bestAR`` when ``ap`` /
        ``ar`` reaches the best so far; returns the names written."""
        if ap is not None and ap > self.best_ap:
            self.best_ap = ap
        if ar is not None and ar > self.best_ar:
            self.best_ar = ar
        state = {**state, "best_ap": self.best_ap, "best_ar": self.best_ar}
        saved = ["last"]
        save_state(self.directory, "last", state)
        if ap is not None and ap >= self.best_ap:
            save_state(self.directory, "bestAP", state)
            saved.append("bestAP")
        if ar is not None and ar >= self.best_ar:
            save_state(self.directory, "bestAR", state)
            saved.append("bestAR")
        return saved


def append_results_line(path: str, iteration: int, stats: dict[str, float]) -> None:
    """One ``results.txt`` line: the iteration and the metrics, tab-separated,
    under a header written with the first line (finetune_uav.py:253-268)."""
    header_needed = not os.path.exists(path)
    with open(path, "a") as f:
        if header_needed:
            f.write("iteration\t" + "\t".join(stats.keys()) + "\n")
        f.write(f"{iteration}\t" + "\t".join(f"{v:.6g}" for v in stats.values()) + "\n")


def plot_training_results(results_path: str, out_png: str | None = None) -> str:
    """``results.txt`` -> a PNG of the metric curves (dcnn/utils/utils.py:92-134);
    needs matplotlib."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with open(results_path) as f:
        header = f.readline().strip().split("\t")
        rows = [[float(v) for v in line.strip().split("\t")] for line in f if line.strip()]
    data = np.asarray(rows)
    out_png = out_png or results_path.replace(".txt", ".png")
    fig, ax = plt.subplots(figsize=(10, 6))
    for i, name in enumerate(header[1:], start=1):
        ax.plot(data[:, 0], data[:, i], label=name)
    ax.set_xlabel("iteration")
    ax.legend(fontsize=7)
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
    return out_png
