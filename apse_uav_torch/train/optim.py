"""Fine-tuning optimizer: SGD with momentum over a subset of the parameters.

Counterpart of the JAX reference's ``train/optim.py``, written as explicit
tensor code that follows its optax 0.2.6 chain step for step, on the
trainable tensors only (the others are never touched):

1. ``apply_if_finite``: a step whose trainable gradients are not all finite
   changes neither the parameters, nor the momentum, nor the schedule's
   count (unless more than ``max_consecutive_errors`` such steps ran in a
   row, as optax allows);
2. ``clip_by_global_norm(10)``: over the trainable gradients, ``g / norm *
   10`` when the norm reaches 10 (torch's ``clip_grad_norm_`` adds 1e-6 and
   scales every tensor);
3. ``add_decayed_weights``: ``g + weight_decay * p``;
4. the momentum trace ``t = g + momentum * t``;
5. ``p + (-lr(count)) * t``, the schedule computed in float32.

Everything stays on the parameters' device: no host sync.

Labels follow the reference's submodule selection: each name picks top-level
modules of the JAX model (``roi_heads`` is its ``box_head`` and
``mask_head``), and each port tensor belongs to the JAX module that holds its
counterpart.  In R-FPN the reference's ``box_head`` holds the class and box
predictors, which the port keeps in ``roi_heads.box_predictor``; in C4
(``MaskRCNNC4``) the predictor and ``res5`` are top-level modules of their
own, so ``roi_heads`` trains only the mask head there, as in the reference.
Only the frozen-BN statistics (``running_mean`` / ``running_var``, the
reference's ``mean`` / ``var``) are always frozen; the frozen-BN ``weight`` /
``bias`` train with the backbone, as in the reference's code (its module
docstring says otherwise).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

# Reference submodule names (build_finetune_optimizer(to_train=[...])) -> the
# JAX model's top-level modules they train.
SUBMODULES = {
    "backbone": ("backbone",),
    "proposal_generator": ("rpn_head",),
    "roi_heads": ("box_head", "mask_head"),
    "mask_head": ("mask_head",),
    "box_head": ("box_head",),
}
FROZEN_LEAVES = ("running_mean", "running_var")


def reference_module(name: str, c4: bool) -> str:
    """The JAX model's top-level module that holds the counterpart of the
    port's tensor ``name`` (R-FPN, or C4 when ``c4``)."""
    if name.startswith("backbone."):
        return "backbone"
    if name.startswith("proposal_generator."):
        return "rpn_head"
    part = name.split(".")[1]  # roi_heads.<box_head|box_predictor|mask_head|res5>
    return "box_head" if part == "box_predictor" and not c4 else part


def param_labels(names: Sequence[str], to_train: Sequence[str]) -> dict[str, str]:
    """'train' or 'frozen' for each state-dict name, of an R-FPN or (names
    under ``roi_heads.res5``) a C4 model."""
    modules = {m for name in to_train for m in SUBMODULES[name]}
    c4 = any(n.startswith("roi_heads.res5.") for n in names)
    return {n: "train" if reference_module(n, c4) in modules and n.rsplit(".", 1)[-1] not in FROZEN_LEAVES
            else "frozen" for n in names}


def warmup_multistep_schedule(base_lr: float, steps: Sequence[int], warmup_iters: int = 1000,
                              warmup_factor: float = 1e-3, gamma: float = 0.1) -> Callable:
    """detectron2's WarmupMultiStepLR as a function of the count tensor, in float32."""

    def schedule(count: torch.Tensor) -> torch.Tensor:
        frac = torch.clamp(count.to(torch.float32) / float(max(warmup_iters, 1)), max=1.0)
        warm = warmup_factor + (1.0 - warmup_factor) * frac
        decay = torch.ones_like(warm)
        for s in steps:
            decay = decay * torch.where(count >= s, gamma, 1.0)
        return base_lr * warm * decay

    return schedule


class SGD:
    """The reference's optimizer over the named tensors ``params`` (a state
    dict with ``keep_vars=True``: updated in place) whose label is 'train'.

    ``finetune=True`` is ``build_finetune_optimizer`` (finite check, clip,
    weight decay, momentum, schedule); ``finetune=False`` is plain
    ``optax.sgd(lr, momentum)`` (the association head's).  ``lr`` is a number
    or a schedule of the step count.
    """

    def __init__(self, params: dict[str, torch.Tensor], labels: dict[str, str] | None = None,
                 lr: float | Callable = 0.02, momentum: float = 0.9, weight_decay: float = 1e-4,
                 max_norm: float = 10.0, finetune: bool = True, max_consecutive_errors: int = 1000):
        labels = labels or {n: "train" for n in params}
        self.names = [n for n in params if labels[n] == "train"]
        self.params = {n: params[n] for n in self.names}
        self.lr, self.momentum, self.weight_decay, self.max_norm = lr, momentum, weight_decay, max_norm
        self.finetune, self.max_consecutive_errors = finetune, max_consecutive_errors
        dev = next(iter(params.values())).device
        self.trace = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        self.notfinite_count = torch.zeros((), dtype=torch.int32, device=dev)
        self.last_finite = torch.ones((), dtype=torch.bool, device=dev)
        self.total_notfinite = torch.zeros((), dtype=torch.int32, device=dev)

    def trainable(self) -> list[torch.Tensor]:
        return [self.params[n] for n in self.names]

    def _lr(self) -> torch.Tensor | float:
        return self.lr(self.count) if callable(self.lr) else self.lr

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor | None]) -> None:
        """Apply one update from the gradients of :meth:`trainable` (None = zero)."""
        ps = self.trainable()
        gs = [torch.zeros_like(p) if g is None else g for p, g in zip(ps, grads)]
        ts = [self.trace[n] for n in self.names]
        if not self.finetune:
            for p, g, t in zip(ps, gs, ts):
                t.copy_(g + self.momentum * t)
                p.add_(-self.lr * t)
            return
        finite = torch.stack([torch.isfinite(g).all() for g in gs]).all()
        self.notfinite_count = torch.where(finite, 0, self.notfinite_count + 1).to(torch.int32)
        apply = finite | (self.notfinite_count > self.max_consecutive_errors)
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in gs))
        keep = g_norm < self.max_norm
        step = -self._lr()
        for p, g, t in zip(ps, gs, ts):
            g = torch.where(keep, g, g / g_norm * self.max_norm)
            g = g + self.weight_decay * p
            new_t = g + self.momentum * t
            p.copy_(torch.where(apply, p + step * new_t, p))
            t.copy_(torch.where(apply, new_t, t))
        self.count += apply.to(torch.int32)
        self.last_finite = finite
        self.total_notfinite += (~finite).to(torch.int32)

    def state_dict(self) -> dict:
        """The optimizer state: the momentum traces keyed like the parameters,
        the schedule count and the finite-check counters."""
        return {"trace": dict(self.trace), "count": self.count, "notfinite_count": self.notfinite_count,
                "last_finite": self.last_finite, "total_notfinite": self.total_notfinite}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Restore :meth:`state_dict`'s output (tensors or numbers, any device)."""
        for n in self.names:
            self.trace[n].copy_(torch.as_tensor(state["trace"][n]))
        for key in ("count", "notfinite_count", "last_finite", "total_notfinite"):
            if key in state:
                cur = getattr(self, key)
                setattr(self, key, torch.as_tensor(state[key], dtype=cur.dtype).to(cur.device).reshape(()))


def build_finetune_optimizer(params: dict[str, torch.Tensor], to_train=("proposal_generator", "roi_heads"),
                             lr: float | Callable = 0.02, momentum: float = 0.9,
                             weight_decay: float = 1e-4) -> SGD:
    """SGD + momentum + weight decay on the selected submodules only
    (reference defaults: finetune_uav.py:161, utils.py:82-88)."""
    return SGD(params, param_labels(list(params), to_train), lr, momentum, weight_decay)
