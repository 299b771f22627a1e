"""A data-parallel detector training step, and its CPU dry run.

Counterpart of the JAX reference's data-parallel step
(``__graft_entry__.dryrun_multichip``, ``tests/test_parallel.py``): there
XLA shards the batch over a mesh and inserts the gradient collectives; here
each rank of a ``torch.distributed`` process group (gloo on the CPU, NCCL on
cards, one rank per device) takes its shard of the batch, and the gradients
are all-reduce-averaged before the port's optimizer update, so that every
rank applies the same update as one process on the whole batch.  Each
image keeps the per-image key it has in the whole batch's split, and each
loss is the whole batch's (the mean over ranks of the ranks' means).

:func:`dp_detector_train_step` is the port's ``detector_train_step`` with
the rank's keys and :func:`mean_grads` as its gradient reduction.
:func:`dryrun_multichip` spawns ``n`` gloo processes on the CPU and returns
rank 0's losses of one such step; :func:`run_group` runs a step over gloo
processes or one NCCL process per card, :func:`plain_step` the same step in
one process, and ``python3 chip_smoke.py --all-cards`` compares the two at
``finetune_uav``'s defaults over every visible card.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import socket

import numpy as np
import torch
import torch.distributed as dist

from apse_uav_torch.dcnn.models.mask_rcnn import image_keys
from apse_uav_torch.parallel.mesh import mean_across_devices
from apse_uav_torch.train.optim import SGD
from apse_uav_torch.train.steps import detector_train_step, trainable_only


def rank_keys(key, b: int, rank: int, world: int, per_image: int) -> np.ndarray:
    """The keys of rank ``rank``'s ``b`` images in a batch of ``b * world``:
    its rows of the whole batch's anchor keys, then of its proposal keys."""
    whole = image_keys(key, b * world, per_image)
    total = b * world
    return np.concatenate([whole[rank * b:(rank + 1) * b], whole[total + rank * b:total + (rank + 1) * b]])


def mean_grads(group=None):
    """A ``reduce_grads`` for :func:`~apse_uav_torch.train.steps.detector_train_step`:
    the gradients (a missing one as zeros) all-reduce-averaged over the
    process group's ranks in one flat vector."""

    def reduce(grads, params):
        flat = torch.cat([(torch.zeros_like(p) if g is None else g).reshape(-1) for p, g in zip(params, grads)])
        flat = mean_across_devices(flat, group)
        return [g.view_as(p) for g, p in zip(flat.split([p.numel() for p in params]), params)]

    return reduce


def dp_detector_train_step(model, opt: SGD, images: torch.Tensor, gt: dict[str, torch.Tensor], key,
                           freeze_backbone: bool = False, group=None) -> dict[str, torch.Tensor]:
    """One data-parallel SGD step on this rank's shard (``images``, ``gt``:
    the rank's b images of a batch of b * world size, rank r holding images
    r*b .. r*b + b - 1; ``key`` the whole batch's (2,) key): the port's
    ``detector_train_step`` on the rank's keys with :func:`mean_grads`.
    Returns the whole batch's losses and ``loss_total`` (tensors on the
    rank's device).  ``model``'s convolutions see b images, so on a card
    they may take other cuDNN algorithms than the whole batch's: equal up
    to rounding."""
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    # The whole batch's split, not this shard's: rank r's images keep their keys.
    keys = rank_keys(key, images.shape[0], rank, world, model.keys_per_image)
    losses = detector_train_step(model, opt, images, gt, keys, freeze_backbone, reduce_grads=mean_grads(group))
    return dict(zip(losses, mean_across_devices(torch.stack(list(losses.values())), group).unbind()))


@dataclasses.dataclass
class DPJob:
    """One data-parallel step to run over a process group: the model config
    and its initial state dict, the whole batch (numpy), the key, the
    trained submodules and the learning rate."""

    cfg: object
    init: dict
    images: np.ndarray
    gt: dict
    key: np.ndarray
    to_train: tuple = ("proposal_generator", "roi_heads")
    lr: float = 0.01


def _build_step(job: DPJob, device):
    """``job``'s model on ``device`` and its optimizer, autograd tracking the trained tensors only."""
    from apse_uav_torch.train.loop import build_detector
    from apse_uav_torch.train.optim import build_finetune_optimizer

    model = build_detector(job.cfg, job.init, 0, device)
    tensors = model.state_dict(keep_vars=True)
    opt = build_finetune_optimizer(tensors, job.to_train, lr=job.lr)
    trainable_only(opt.trainable(), tensors.values())
    return model, opt


def _result(losses: dict, model) -> tuple[dict, dict]:
    return ({k: float(v) for k, v in losses.items()},
            {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()})


def run_step(job: DPJob, rank: int, world: int, device, group=None) -> tuple[dict, dict]:
    """This rank's part of ``job`` on ``device`` in an initialised process
    group: (losses as floats, the updated state dict as numpy arrays)."""
    model, opt = _build_step(job, device)
    b = job.images.shape[0] // world
    shard = slice(rank * b, (rank + 1) * b)
    images = torch.from_numpy(job.images[shard]).to(device)
    gt = {k: torch.from_numpy(np.ascontiguousarray(v[shard])).to(device) for k, v in job.gt.items()}
    return _result(dp_detector_train_step(model, opt, images, gt, job.key, "backbone" not in job.to_train, group),
                   model)


def plain_step(job: DPJob, device) -> tuple[dict, dict]:
    """``job``'s step in one process on ``device``, the whole batch at once
    (what the data-parallel step must equal): (losses as floats, the
    updated state dict as numpy arrays)."""
    model, opt = _build_step(job, device)
    losses = detector_train_step(model, opt, torch.from_numpy(job.images).to(device),
                                 {k: torch.from_numpy(v).to(device) for k, v in job.gt.items()}, job.key,
                                 "backbone" not in job.to_train)
    return _result(losses, model)


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(rank: int, world: int, port: int, job: DPJob, queue, backend: str) -> None:
    if backend == "nccl":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False  # float32 as the reference computes it
        torch.backends.cudnn.allow_tf32 = False
    else:
        device = torch.device("cpu")
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
    try:
        result = run_step(job, rank, world, device)
        if rank == 0:
            queue.put(result)
    finally:
        dist.destroy_process_group()


def run_group(world: int, job: DPJob, backend: str = "gloo", timeout: float = 600.0) -> tuple[dict, dict]:
    """``job`` over ``world`` spawned processes, one rank each: gloo on the
    CPU, or NCCL with rank r on card r.  Returns rank 0's (losses, updated
    state dict); the processes are joined (or killed) before it returns."""
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_worker, args=(r, world, port, job, queue, backend)) for r in range(world)]
    for p in procs:
        p.start()
    try:
        result = queue.get(timeout=timeout)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"data-parallel workers exited with {bad}")
    return result


def dryrun_job(n_images: int) -> DPJob:
    """The reference dry run's step (``__graft_entry__.dryrun_multichip``):
    a depth-26 R-FPN with 64 FPN channels, a 128-d box head and 32-channel
    mask head, 4 classes, halved budgets, ``n_images`` 64x64 zero images
    with one GT box each (the reference gives each device one), the flax
    init under ``PRNGKey(0)``, RPN and ROI heads trained at lr 0.01, key
    ``PRNGKey(1)``."""
    from apse_uav_torch.dcnn import flax_init
    from apse_uav_torch.dcnn.config import mask_rcnn_r50_fpn

    cfg = mask_rcnn_r50_fpn(num_classes=4)
    cfg = dataclasses.replace(
        cfg, depth=26, fpn_channels=64,
        rpn=dataclasses.replace(cfg.rpn, pre_nms_topk_test=128, post_nms_topk_test=64, pre_nms_topk_train=128,
                                post_nms_topk_train=64, batch_size_per_image=32),
        roi=dataclasses.replace(cfg.roi, num_classes=4, detections_per_image=16, batch_size_per_image=32,
                                box_fc_dim=128, mask_conv_dim=32))
    b, h, w, g = n_images, 64, 64, 4
    gt = {"boxes": np.tile(np.asarray([[8.0, 8.0, 30.0, 28.0]], np.float32), (b, g, 1)),
          "classes": np.zeros((b, g), np.int32),
          "valid": np.tile(np.asarray([True] + [False] * (g - 1)), (b, 1)),
          "masks": np.ones((b, g, h, w), np.float32)}
    return DPJob(cfg, flax_init.mask_rcnn_init(cfg, 0), np.zeros((b, h, w, 3), np.float32), gt,
                 flax_init.prng_key(1))


def dryrun_multichip(n_devices: int) -> dict[str, float]:
    """One full training step (forward, backward, all-reduce, SGD update)
    data-parallel over ``n_devices`` gloo processes on the CPU; returns rank
    0's losses (the whole batch's), all finite."""
    losses, _ = run_group(n_devices, dryrun_job(n_devices))
    bad = {k: v for k, v in losses.items() if not np.isfinite(v)}
    if bad:
        raise RuntimeError(f"dryrun_multichip({n_devices}): non-finite losses {bad}")
    return losses
