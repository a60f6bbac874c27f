"""Optimizer and LR schedule (reference configure_optimizers,
simple_lstm.py:193-221: AdamW or SGD+momentum, optional per-epoch
CosineAnnealingLR with T_max=optim.max_epochs, eta_min=0).

Counterpart of ``multimodalreactiongeneration_tpu/train/optim.py``, on
``torch.optim``: ``adam`` is AdamW (decoupled weight decay, as
``optax.adamw``); ``sgd`` adds the L2 term to the gradient and then
applies momentum (the JAX package's ``add_decayed_weights`` + ``sgd``
chain), which is what ``torch.optim.SGD(weight_decay=...)`` does.
Gradient accumulation (the JAX ``accumulate_grad_batches``) comes with
the trainer.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Mapping

import torch


def cosine_annealing(base_lr: float, t_max: int) -> Callable[[int], float]:
    """torch CosineAnnealingLR(eta_min=0), stepped per EPOCH."""
    return lambda epoch: base_lr * 0.5 * (
        1.0 + math.cos(math.pi * min(epoch, t_max) / t_max))


def build_optimizer(
    params: Iterable[torch.nn.Parameter], optim_cfg: Mapping
) -> torch.optim.Optimizer:
    """``optim`` group of the config (use_optimizer, lr, weight_decay,
    momentum) -> a torch optimizer over ``params``."""
    kind = optim_cfg["use_optimizer"]
    if kind == "adam":
        return torch.optim.AdamW(params, lr=optim_cfg["lr"],
                                 weight_decay=optim_cfg["weight_decay"])
    if kind == "sgd":
        return torch.optim.SGD(params, lr=optim_cfg["lr"],
                               momentum=optim_cfg["momentum"],
                               weight_decay=optim_cfg["weight_decay"])
    raise ValueError(f"invalid optimizer type {kind!r}")


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set every parameter group's learning rate (the per-epoch schedule
    step)."""
    for group in optimizer.param_groups:
        group["lr"] = lr
