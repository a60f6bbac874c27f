"""Loss functions with torch-parity formulas.

Counterpart of ``multimodalreactiongeneration_tpu/train/losses.py``
(reference lossfun, lstm_with_sample.py:234-246 / lstmformer.py:313-325).
"""

from __future__ import annotations

import torch


def mse(x, y):
    return torch.mean(torch.square(x - y))


def mae(x, y):
    return torch.mean(torch.abs(x - y))


def huber(x, y, delta: float = 1.0):
    d = torch.abs(x - y)
    return torch.mean(
        torch.where(d < delta, 0.5 * d * d, delta * (d - 0.5 * delta))
    )


def smooth_l1(x, y, beta: float = 1.0):
    d = torch.abs(x - y)
    return torch.mean(torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta))


def build_loss(model_cfg):
    kind = model_cfg["loss_type"]
    if model_cfg.get("loss_reduction", "mean") != "mean":
        raise ValueError("only mean reduction supported (matches configs)")
    if kind == "mse":
        return mse
    if kind == "mae":
        return mae
    if kind == "huber":
        delta = model_cfg.get("huber_delta", 1.0)
        return lambda x, y: huber(x, y, delta)
    if kind == "smoothl1":
        beta = model_cfg.get("smoothl1_beta", 1.0)
        return lambda x, y: smooth_l1(x, y, beta)
    raise ValueError(f"invalid loss type {kind!r}")
