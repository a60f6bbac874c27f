"""Optimizer and LR schedule (reference configure_optimizers,
simple_lstm.py:193-221: AdamW or SGD+momentum, optional per-epoch
CosineAnnealingLR with T_max=optim.max_epochs, eta_min=0).

Counterpart of ``multimodalreactiongeneration_tpu/train/optim.py``, on
``torch.optim``: ``adam`` is AdamW (decoupled weight decay, as
``optax.adamw``); ``sgd`` adds the L2 term to the gradient and then
applies momentum (the JAX package's ``add_decayed_weights`` + ``sgd``
chain), which is what ``torch.optim.SGD(weight_decay=...)`` does.
``accumulate_grad_batches`` k > 1 wraps it in ``MultiSteps``, the JAX
package's ``optax.MultiSteps`` (Lightning's
``trainer.accumulate_grad_batches``).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterable, Mapping

import torch


def cosine_annealing(base_lr: float, t_max: int) -> Callable[[int], float]:
    """torch CosineAnnealingLR(eta_min=0), stepped per EPOCH."""
    return lambda epoch: base_lr * 0.5 * (
        1.0 + math.cos(math.pi * min(epoch, t_max) / t_max))


class MultiSteps:
    """``optax.MultiSteps(inner, every_k_schedule=k)`` on a torch
    optimizer: ``step`` folds the parameters' gradients into their running
    mean (optax's ``acc + (g - acc) / (n + 1)``) and counts the micro-step;
    on every k-th call the inner optimizer steps once on that mean and the
    accumulation restarts; between them neither the parameters nor the
    inner state change (no weight decay either). A parameter without a
    gradient counts as zeros, as optax's tree of updates has one. The
    accumulation carries across epochs; ``state_dict`` holds it (the mean
    and the micro-step count) beside the inner state, as the MultiSteps
    ``opt_state`` of a JAX checkpoint does. ``param_groups`` are the
    inner optimizer's, so ``set_learning_rate`` acts on it."""

    def __init__(self, inner: torch.optim.Optimizer, every_k: int):
        if every_k < 1:
            raise ValueError(f"every_k must be >= 1, got {every_k}")
        self.inner = inner
        self.every_k = every_k
        self.mini_step = 0
        self.params = [p for g in inner.param_groups for p in g["params"]]
        self.acc_grads = [torch.zeros_like(p) for p in self.params]

    @property
    def param_groups(self):
        return self.inner.param_groups

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self) -> None:
        n = self.mini_step
        for p, acc in zip(self.params, self.acc_grads):
            grad = torch.zeros_like(p) if p.grad is None else p.grad
            acc.copy_(acc + (grad - acc) / (n + 1))
        if n < self.every_k - 1:
            self.mini_step = n + 1
            return
        for p, acc in zip(self.params, self.acc_grads):
            p.grad = acc.clone()
        self.inner.step()
        for acc in self.acc_grads:
            acc.zero_()
        self.mini_step = 0

    def state_dict(self) -> Dict[str, Any]:
        return {"inner": self.inner.state_dict(), "every_k": self.every_k,
                "mini_step": self.mini_step,
                "acc_grads": [a.clone() for a in self.acc_grads]}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        if "inner" not in state:
            raise ValueError(
                "the optimizer state holds no gradient accumulation: it was "
                "saved without accumulate_grad_batches")
        if int(state["every_k"]) != self.every_k:
            raise ValueError(
                f"the optimizer state accumulates {state['every_k']} "
                f"batches, this run {self.every_k}")
        self.inner.load_state_dict(state["inner"])
        self.mini_step = int(state["mini_step"])
        for acc, saved in zip(self.acc_grads, state["acc_grads"]):
            acc.copy_(saved)


def build_optimizer(
    params: Iterable[torch.nn.Parameter], optim_cfg: Mapping,
    accumulate_grad_batches: int = 1,
):
    """``optim`` group of the config (use_optimizer, lr, weight_decay,
    momentum) -> a torch optimizer over ``params``, wrapped in
    ``MultiSteps`` when ``accumulate_grad_batches`` > 1."""
    kind = optim_cfg["use_optimizer"]
    if kind == "adam":
        opt = torch.optim.AdamW(params, lr=optim_cfg["lr"],
                                weight_decay=optim_cfg["weight_decay"])
    elif kind == "sgd":
        opt = torch.optim.SGD(params, lr=optim_cfg["lr"],
                              momentum=optim_cfg["momentum"],
                              weight_decay=optim_cfg["weight_decay"])
    else:
        raise ValueError(f"invalid optimizer type {kind!r}")
    if accumulate_grad_batches > 1:
        return MultiSteps(opt, accumulate_grad_batches)
    return opt


def set_learning_rate(optimizer, lr: float) -> None:
    """Set every parameter group's learning rate (the per-epoch schedule
    step); a ``MultiSteps``' groups are its inner optimizer's."""
    for group in optimizer.param_groups:
        group["lr"] = lr
