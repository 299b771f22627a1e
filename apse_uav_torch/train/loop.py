"""Training loops: the detector fine-tune and the association head.

Counterparts of the JAX reference's ``train/loop.py``:

* :func:`finetune_detector` (finetune_uav.py:159-297): the optimizer over a
  subset of the parameters with a linear warmup, periodic COCO evaluation,
  ``results.txt``, ``last`` / ``bestAP`` / ``bestAR`` checkpoints with the
  optimizer state, and resume from ``last``;
* :func:`train_association_head` (train_association_head.py:59-140): MOTS
  batches padded to a power of two with a validity mask, SGD 0.01 / 0.9, the
  batch-hard loss at margin 0.2, one checkpoint and one ``train_info.txt``
  line per epoch.

The random streams are the reference's: the detector's step keys come from
``split`` of ``PRNGKey(seed + 1)``, one split a step, and a model without
initial weights starts from the reference's flax init under
``PRNGKey(seed)`` (:func:`~apse_uav_torch.dcnn.flax_init.mask_rcnn_init`);
the association head from its flax init under ``PRNGKey(seed)``.

The reference's ``steps_per_call`` (several steps in one jitted call) only
spread the dispatch cost of a remote TPU; it is left out.  Its
double-buffered feed becomes :class:`_Prefetch`: the next batch is loaded
and uploaded (pinned memory, a side stream) in a thread while the current
step runs.
"""

from __future__ import annotations

import concurrent.futures
import importlib.util
import os
import time
from typing import Callable, Iterable

import numpy as np
import torch

from apse_uav_torch.dcnn import flax_init, weights
from apse_uav_torch.dcnn.config import ModelConfig
from apse_uav_torch.dcnn.models.association import AssociationHead, init_weights
from apse_uav_torch.dcnn.models.c4 import build_model
from apse_uav_torch.dcnn.models.mask_rcnn import MaskRCNN
from apse_uav_torch.device import resolve_device
from apse_uav_torch.evaluation.coco_eval import CocoEvaluator
from apse_uav_torch.train import checkpoint as ckpt
from apse_uav_torch.train.optim import SGD, build_finetune_optimizer, warmup_multistep_schedule
from apse_uav_torch.train.steps import association_train_step, detector_train_step, trainable_only


def to_device(batch, dev: torch.device, non_blocking: bool = False):
    """(images, gt dict) of numpy arrays -> tensors on ``dev``."""
    images, gt = batch

    def put(x):
        t = torch.from_numpy(np.ascontiguousarray(x))
        if dev.type == "cuda":
            t = t.pin_memory()
        return t.to(dev, non_blocking=non_blocking)

    return put(images), {k: put(v) for k, v in gt.items()}


class _Prefetch:
    """One batch ahead of the loop: a thread takes the next batch from the
    iterator and uploads it on a side stream (from pinned memory) while the
    caller's step runs; :meth:`get` makes the caller's stream wait for it."""

    def __init__(self, it, dev: torch.device):
        self.it, self.dev = it, dev
        self.pool = concurrent.futures.ThreadPoolExecutor(1)
        self.stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        self.pending = None

    def _load(self):
        try:
            batch = next(self.it)
        except StopIteration:
            return None
        if self.stream is None:
            return to_device(batch, self.dev), None
        with torch.cuda.stream(self.stream):
            out = to_device(batch, self.dev, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        return out, event

    def start(self) -> None:
        self.pending = self.pool.submit(self._load)

    def get(self):
        """The prefetched batch on the device, or None when the iterator ended."""
        res = self.pending.result()
        self.pending = None
        if res is None:
            return None
        (images, gt), event = res
        if event is not None:
            cur = torch.cuda.current_stream(self.dev)
            cur.wait_event(event)
            for t in (images, *gt.values()):
                t.record_stream(cur)
        return images, gt

    def close(self) -> None:
        self.pool.shutdown(wait=True)


def evaluate_detector(model: MaskRCNN, eval_batches: Iterable, max_images: int | None = None) -> dict[str, float]:
    """COCO AP of ``model`` over an evaluation loader (finetune_uav.py do_test:111-154)."""
    dev = model.pixel_mean.device
    ev = CocoEvaluator()
    image_id = 0
    for images, gt in eval_batches:
        dets, _ = model.inference(torch.from_numpy(np.ascontiguousarray(images)).to(dev))
        dets = {k: v.cpu().numpy() for k, v in dets.items()}
        for b in range(images.shape[0]):
            for g in range(gt["boxes"].shape[1]):
                if not gt["valid"][b, g]:
                    continue
                x1, y1, x2, y2 = gt["boxes"][b, g]
                ev.add_ground_truth([{"image_id": image_id, "category_id": int(gt["classes"][b, g]),
                                      "bbox": [float(x1), float(y1), float(x2 - x1), float(y2 - y1)]}])
            for d in range(dets["boxes"].shape[1]):
                if not dets["valid"][b, d]:
                    continue
                x1, y1, x2, y2 = dets["boxes"][b, d]
                ev.add_detections([{"image_id": image_id, "category_id": int(dets["classes"][b, d]),
                                    "bbox": [float(x1), float(y1), float(x2 - x1), float(y2 - y1)],
                                    "score": float(dets["scores"][b, d])}])
            image_id += 1
            if max_images is not None and image_id >= max_images:
                return ev.summarize()
    return ev.summarize()


def build_detector(model_cfg: ModelConfig, init_params: dict | None, seed: int, device) -> MaskRCNN:
    """The model of ``model_cfg`` (``build_model``: R-FPN or C4) on
    ``device`` with ``init_params`` (a state dict), or the reference's flax
    init under ``PRNGKey(seed)`` when None."""
    dev = resolve_device(device)
    model = build_model(model_cfg)
    if init_params is None:
        init_params = flax_init.mask_rcnn_init(model_cfg, seed, dev)
    weights.load_detectron2(model, init_params)
    return model.to(dev).eval()


def finetune_detector(model_cfg: ModelConfig, train_batches: Iterable, eval_batches_fn: Callable[[], Iterable],
                      workdir: str, max_iter: int = 1000, to_train=("proposal_generator", "roi_heads"),
                      lr: float = 0.02, test_period: int = 50, init_params: dict | None = None, resume: bool = True,
                      seed: int = 0, log_fn: Callable[[str], None] = print, device="cuda",
                      on_step: Callable[[int, dict], None] | None = None,
                      gt_proposals: bool = False) -> MaskRCNN:
    """Fine-tune on ``train_batches`` ((images (B, H, W, 3) f32, gt dict of
    numpy arrays), as :class:`~apse_uav_torch.data.loader.DetectionLoader`
    yields them); returns the trained model.  Checkpoints and
    ``results.txt`` land in ``workdir``.  ``on_step(iteration, losses)``, if
    given, sees each step's loss tensors (a test's or a benchmark's hook).
    ``gt_proposals`` trains the ROI heads on the GT boxes in place of the
    RPN's proposals (``finetune_segmentation``'s regime; the reference's CLI
    swaps the step for one that does so)."""
    dev = resolve_device(device)
    model = build_detector(model_cfg, init_params, seed, dev)
    tensors = model.state_dict(keep_vars=True)
    schedule = warmup_multistep_schedule(lr, steps=(), warmup_iters=min(500, max(max_iter // 10, 1)))
    opt = build_finetune_optimizer(tensors, to_train, lr=schedule)
    trainable_only(opt.trainable(), tensors.values())
    manager = ckpt.CheckpointManager(workdir)
    iteration = 0
    if resume:
        state = manager.resume()
        if state is not None:
            weights.load_detectron2(model, state["params"])
            opt.load_state_dict(state["opt_state"])
            iteration = int(state["iteration"])
            log_fn(f"resumed at iteration {iteration}")
    freeze_backbone = "backbone" not in to_train
    key = flax_init.prng_key(seed + 1)
    results_path = os.path.join(workdir, "results.txt")
    can_plot = importlib.util.find_spec("matplotlib") is not None
    t0 = time.time()

    def eval_and_checkpoint(losses):
        losses = {k: float(v) for k, v in sorted(losses.items())}  # the reference's (pytree) key order
        stats = {**evaluate_detector(model, eval_batches_fn()), **losses}
        ckpt.append_results_line(results_path, iteration, stats)
        manager.save({"params": model.state_dict(), "opt_state": opt.state_dict(), "iteration": iteration},
                     ap=stats["AP"], ar=stats["AR100"])
        if can_plot:  # the plot needs matplotlib; results.txt holds the same numbers
            ckpt.plot_training_results(results_path)
        log_fn(f"iter {iteration}: AP={stats['AP']:.4f} AR={stats['AR100']:.4f} "
               f"loss={losses['loss_total']:.4f} ({time.time() - t0:.1f}s)")

    feed = _Prefetch(iter(train_batches), dev)
    feed.start()
    batch = feed.get()
    try:
        while iteration < max_iter and batch is not None:
            images, gt = batch
            key, sub = flax_init.split(key)
            if iteration + 1 < max_iter:
                feed.start()
            losses = detector_train_step(model, opt, images, gt, sub, freeze_backbone, gt_proposals=gt_proposals)
            iteration += 1
            if on_step is not None:
                on_step(iteration, losses)
            batch = feed.get() if iteration < max_iter else None
            if batch is None:
                max_iter = iteration  # a finite iterable ran out
            if iteration % test_period == 0 or iteration == max_iter:
                eval_and_checkpoint(losses)
    finally:
        feed.close()
    return model


def train_association_head(batch_fn: Callable[[int], tuple[np.ndarray, np.ndarray]], num_batches: int, workdir: str,
                           epochs: int = 10, embedding_dim: int = 128,
                           roi_feature_shape: tuple[int, int, int] = (256, 8, 8), lr: float = 0.01,
                           momentum: float = 0.9, margin: float = 0.2, seed: int = 0,
                           log_fn: Callable[[str], None] = print, device="cuda") -> AssociationHead:
    """batch_fn(i) -> (ids (N,), rois (N, C, R, R)); returns the trained head
    (on ``device``).  Batches of fewer than 2 ROIs are skipped; the others are
    zero-padded to the largest power of two seen so far, with a validity mask."""
    dev = resolve_device(device)
    c, r, _ = roi_feature_shape
    head = AssociationHead(c * r * r, embedding_dim)
    head.load_state_dict({k: torch.from_numpy(v) for k, v in init_weights(c * r * r, embedding_dim, seed).items()})
    head = head.to(dev)
    opt = SGD(dict(head.named_parameters()), lr=lr, momentum=momentum, finetune=False)
    os.makedirs(workdir, exist_ok=True)
    info_path = os.path.join(workdir, "train_info.txt")
    cap = 0
    for epoch in range(epochs):
        epoch_losses = []
        for i in range(num_batches):
            ids, rois = batch_fn(i)
            n = len(ids)
            if n < 2:
                continue
            cap = max(cap, 1 << (n - 1).bit_length())  # pad to a power of two
            ids_p = np.zeros(cap, np.int64)
            rois_p = np.zeros((cap, *rois.shape[1:]), np.float32)
            valid = np.zeros(cap, bool)
            ids_p[:n], rois_p[:n], valid[:n] = ids, rois, True
            loss = association_train_step(head, opt, torch.from_numpy(rois_p).to(dev), torch.from_numpy(ids_p).to(dev),
                                          torch.from_numpy(valid).to(dev), margin)
            epoch_losses.append(float(loss))
        mean_loss = float(np.mean(epoch_losses)) if epoch_losses else float("nan")
        ckpt.save_state(workdir, f"epoch_{epoch}", {"params": head.state_dict(), "epoch": epoch})
        with open(info_path, "a") as f:
            f.write(f"epoch {epoch}: mean_loss {mean_loss:.6f}\n")
        log_fn(f"association epoch {epoch}: loss {mean_loss:.4f}")
    return head
