"""Device meshes and data-parallel wrappers over frames.

Counterpart of the JAX reference's ``parallel/mesh.py``.  A "mesh" here is an
ordered list of ``torch.device``s (one data axis): there is no partitioner,
so each wrapper runs one replica per device on its own chunk of the batch's
leading axis, with no collective on the forward path, and concatenates the
results in device order.  The batch must be a multiple of the mesh size, as
in the reference.  The reference's ``batch_sharding`` (a ``NamedSharding``
that XLA's partitioner applies) is here :func:`batch_sharding`, the explicit
map of rows to devices that :func:`shard_batch` applies.

These wrappers split the work; they give no speedup.  The chunks run in turn
from the calling thread, and the port's inference waits on its device at its
NMS convergence tests, so the cards do not overlap: sharding 8-16 4K frames
over four H100s runs at one card's rate (``python3 chip_smoke.py
--all-cards``; a thread per card was slower still, the threads contending
for the interpreter lock on a launch-bound path).  Where the JAX reference
dispatches every device at once, throughput over cards needs one process per
card, as the data-parallel step has (:mod:`apse_uav_torch.parallel.dp`).
The cross-device reduction, :func:`mean_across_devices`, is a
``torch.distributed`` all-reduce over such a process group.

    mesh = data_mesh()                                   # every visible card
    replicas = [build(dev) for dev in mesh]              # one model per card
    infer = sharded_inference_fn(lambda m, x: m.inference(x), replicas, mesh)
    dets, feats = infer(frames)                          # frames split over the cards
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist


def data_mesh(n_devices: int | None = None) -> list[torch.device]:
    """The visible cards (the first ``n_devices`` of them), in index order.
    Raises where there is no card: a CPU mesh is a list the caller writes
    (``[torch.device("cpu")] * 2``)."""
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("data_mesh: no CUDA device is visible")
    devices = [torch.device("cuda", i) for i in range(n)]
    return devices[:n_devices] if n_devices is not None else devices


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def batch_sharding(mesh: list[torch.device], batch_size: int) -> list[tuple[torch.device, slice]]:
    """Which rows of a batch go to which device: one (device, rows) pair per
    device of ``mesh``, in order, each an equal contiguous chunk of the
    leading axis.  The counterpart of the reference's ``NamedSharding(mesh,
    P("data"))``: with no partitioner the sharding is this explicit row map,
    which :func:`shard_batch` applies."""
    n = len(mesh)
    if batch_size % n:
        raise ValueError(f"batch of {batch_size} is not a multiple of the mesh size {n}")
    per = batch_size // n
    return [(dev, slice(i * per, (i + 1) * per)) for i, dev in enumerate(mesh)]


def shard_batch(mesh: list[torch.device], tree: Any) -> list[Any]:
    """A batch (a tensor or numpy array, or a dict / list / tuple of them,
    all with the same leading size) -> one tree per device of ``mesh``: its
    rows of :func:`batch_sharding`, on that device."""
    sizes = set()
    _map(tree, lambda x: sizes.add(int(x.shape[0])))
    (b,) = sizes

    def chunk(dev, rows):
        return _map(tree, lambda x: torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)[
            rows].to(dev))

    return [chunk(dev, rows) for dev, rows in batch_sharding(mesh, b)]


def _concat(outs: list[Any], device: torch.device):
    """Per-device results (trees of tensors) -> one tree, concatenated along
    the leading axis in device order, on ``device``."""
    first = outs[0]
    if isinstance(first, dict):
        return {k: _concat([o[k] for o in outs], device) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_concat([o[i] for o in outs], device) for i in range(len(first)))
    return torch.cat([o.to(device) for o in outs])


def sharded_inference_fn(fn: Callable, params_per_device: list, mesh: list[torch.device]) -> Callable:
    """``run(batch)``: ``fn(params_per_device[i], chunk_i)`` on each device
    of ``mesh`` (one replica per device, no collective), the results
    concatenated in order on ``mesh[0]``."""
    if len(params_per_device) != len(mesh):
        raise ValueError(f"{len(params_per_device)} replicas for a mesh of {len(mesh)} devices")

    def run(batch):
        return _concat([fn(p, x) for p, x in zip(params_per_device, shard_batch(mesh, batch))], mesh[0])

    return run


def shard_map_batch(mesh: list[torch.device], fn: Callable) -> Callable:
    """``run(batch)``: ``fn(chunk)`` once per device on its chunk (which lies
    on that device: ``fn`` picks its per-device state by ``chunk.device``),
    the results concatenated in order on ``mesh[0]``.  This is how the ArUco
    front scales over frames."""

    def run(batch):
        return _concat([fn(x) for x in shard_batch(mesh, batch)], mesh[0])

    return run


def mean_across_devices(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of ``x`` over the ranks of the process group (one rank per
    device): an all-reduce of a copy, then a division by the world size."""
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out / dist.get_world_size(group)
