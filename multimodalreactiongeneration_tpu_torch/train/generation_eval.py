"""Validation-time generation evaluation (genrt_loss).

Counterpart of ``multimodalreactiongeneration_tpu/train/generation_eval.py``.
The reference's validation_step runs a full autoregressive generation and
logs genrt_loss beside val_loss (lstmformer.py:387-424,
lstm_with_sample.py:303-337). Here each validation batch goes through the
model's generation with the full sampling mask, as in the JAX package:
``generate_lws`` for lstm_with_sampling (on the card the sampler's
warmup runs the stacked-LSTM kernel, K9), ``generate_metaformer`` for the
lstmformer with f32 caches (the metric stays off the bf16 inference
default's rounding) and the shared raw-KV layout (on the card, with LSTM
embeddings, the encoder-stack kernel, K1, and the rollout kernel, K2;
with GRU embeddings the GRU recurrence kernel, K10, over the hoisted
encoders and the step-by-step rollout). The per-batch losses stay on the
device and are read back once.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from multimodalreactiongeneration_tpu_torch.infer.generate import (
    generate_lws,
    generate_metaformer,
    sampling_mask_for,
)
from multimodalreactiongeneration_tpu_torch.ops.masks import PADDING_VALUE
from multimodalreactiongeneration_tpu_torch.train.losses import build_loss


def generation_loss(pred: torch.Tensor, target: torch.Tensor,
                    lossfun: Callable) -> torch.Tensor:
    """Loss of a rollout against the target, padding zeroed on both sides
    (JAX ``infer/generate.py generation_loss``)."""
    mask = (target != PADDING_VALUE).to(pred.dtype)
    return lossfun(pred * mask, target * mask)


def make_generation_eval(model, model_type: str, model_cfg) -> Callable:
    """``generation_eval(val_loader) -> float``: the mean generation loss
    over the loader's batches (nan for an empty loader)."""
    if model_type == "lstm_with_sampling":
        gen = generate_lws
    elif model_type == "lstmformer":
        gen = functools.partial(generate_metaformer,
                                cache_dtype=torch.float32)
    else:
        raise NotImplementedError(
            f"no generation eval for {model_type!r}: the streaming models "
            "have one; simple_lstm trains without it, as in the JAX CLI")
    lossfun = build_loss(model_cfg)
    device = next(model.parameters()).device

    def generation_eval(val_loader) -> float:
        losses = []
        for batch in val_loader:
            data = [torch.as_tensor(b[0]).to(device) for b in batch]
            mask = sampling_mask_for(data[1].shape[1], "full", device=device)
            pred = gen(model, data, mask)
            losses.append(generation_loss(pred, data[-1], lossfun))
        if not losses:
            return float("nan")
        return float(torch.stack(losses).mean())

    return generation_eval
