"""Training step functions.

Counterpart of ``streaming_step_fns`` in ``multimodalreactiongeneration
_tpu/train/harness.py`` (reference training_step / validation_step,
lstmformer.py:357-424), for the Metaformer:

  * leading warmup frames are sliced off the prediction (y[:, lead:]);
  * prediction AND target are multiplied by the (target != -100) mask,
    then the loss takes the FULL-tensor mean: padding contributes zeros
    to the numerator and stays in the denominator;
  * the training loss scales the delta channels by sqrt(delta_loss_scale).

The step runs the model's modules eagerly; on CUDA the encoder stacks
and the self-motion LSTMs go through their kernels (``ops/mixer_stack.py``,
``ops/lstm_layer.py``). f32 only. The scheduled-sampling and windowed
steps and the fit loop (``Trainer``) come with later slices.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch

from multimodalreactiongeneration_tpu_torch.ops.masks import PADDING_VALUE
from multimodalreactiongeneration_tpu_torch.train.losses import build_loss
from multimodalreactiongeneration_tpu_torch.train.metrics import (
    gen_target_dict,
    per_slice_sq_err,
)

# the 7-tuple of (data, lengths) pairs: fbank_p, motion_p, motion_s,
# lead_fbank, lead_mp, lead_ms, target
Batch = Sequence[Tuple[torch.Tensor, torch.Tensor]]


def delta_scaler(feat_dim: int, delta_order: int, scale: float,
                 device=None) -> torch.Tensor:
    """1 on the static channels, sqrt(scale) on the delta channels."""
    s = torch.ones(feat_dim, device=device)
    s[feat_dim // (delta_order + 1):] = scale ** 0.5
    return s


def streaming_step_fns(
    model: torch.nn.Module,
    model_cfg: Dict[str, Any],
    metrics_cfg: Dict[str, Any],
    optimizer: torch.optim.Optimizer,
    mask_self_motion_input: bool,
    compute_dtype: torch.dtype = torch.float32,
    remat: bool = False,
):
    """(train_step, eval_step) for the Metaformer.

    ``train_step(batch) -> (loss, per_slice)`` runs forward, loss,
    backward and one optimizer step on ``model``'s parameters;
    ``eval_step(batch) -> (loss, per_slice)`` runs the forward without a
    gradient. ``per_slice`` maps each feature slice to (sum_sq_err,
    count), on the device."""
    if compute_dtype != torch.float32:
        raise NotImplementedError(
            "the port trains in f32 only (bf16 training comes later)")
    if remat:
        raise NotImplementedError("remat is not ported yet")
    lossfun = build_loss(model_cfg)
    target_dict = gen_target_dict(
        metrics_cfg["use_centroid"],
        metrics_cfg["use_angle"],
        metrics_cfg["delta_order"],
    )
    delta_order = metrics_cfg["delta_order"]
    dls = model_cfg.get("delta_loss_scale", 1.0)

    def forward(batch: Batch):
        a_p, m_p, m_s, la, lmp, lms, target = [b[0] for b in batch]
        if mask_self_motion_input:
            m_s = m_s * (m_s != PADDING_VALUE)
        y, _ = model(a_p, m_p, m_s, la, lmp, lms)
        y = y[:, lmp.shape[1]:].float()
        mask = (target != PADDING_VALUE).to(y.dtype)
        return y * mask, target * mask

    def train_step(batch: Batch):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        y, t = forward(batch)
        scaler = delta_scaler(y.shape[-1], delta_order, dls, y.device)
        y, t = y * scaler, t * scaler
        loss = lossfun(y, t)
        loss.backward()
        optimizer.step()
        return loss.detach(), per_slice_sq_err(y.detach(), t, target_dict)

    @torch.no_grad()
    def eval_step(batch: Batch):
        model.eval()
        y, t = forward(batch)
        return lossfun(y, t), per_slice_sq_err(y, t, target_dict)

    return train_step, eval_step
