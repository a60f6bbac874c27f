"""SimpleLSTM sliding-window autoregressive generation.

Counterpart of ``multimodalreactiongeneration_tpu/infer/simple_generate.py``
(reference gen_head_motion, mr_gen/utils/visualize/model_visualize.py:
104-253): per predicted frame, take the last context_size motion frames
and the matching audio window, predict one frame, rebuild its deltas
against the context (``split_and_form``, the reference's in-place delta
recompute, :229-232), append it to the context and slide forward.

Batch 1, one model call per predicted frame, as in the JAX package (which
runs the same steps as one ``lax.scan``). Each call runs the acoustic
encoder over the step's whole audio window, so on the card every step
launches the acoustic LSTMs' kernels: 4 forwards of K7 at simple_lstm's
size (K8 under ``MRGEN_FUSED_DW=0``).
"""

from __future__ import annotations

import torch

from multimodalreactiongeneration_tpu_torch import resolve_device
from multimodalreactiongeneration_tpu_torch.models.simple_lstm import (
    split_and_form,
)


def audio_windows(fbank: torch.Tensor, steps: int, frames_per_step: int,
                  window_frames: int) -> torch.Tensor:
    """(T, 81) full fbank -> (steps, window_frames, 81) sliding windows.

    Window for step s ends at (s + 1) * frames_per_step aligned to the
    context end, mirroring databuild v1's audio range arithmetic; indices
    before the start clamp to frame 0."""
    ends = (torch.arange(steps, device=fbank.device) + 1) * frames_per_step
    starts = ends - window_frames + (fbank.shape[0] - steps * frames_per_step)
    idx = starts[:, None] + torch.arange(window_frames,
                                         device=fbank.device)[None, :]
    return fbank[idx.clamp(0, fbank.shape[0] - 1)]


@torch.no_grad()
def sliding_window_generate(
    model: torch.nn.Module,
    fbank_windows: torch.Tensor,  # (steps, W, 81)
    context_init: torch.Tensor,   # (context_size, 18) delta-stacked features
    delta_order: int = 2,
    base_size: int = 6,
    device=None,
) -> torch.Tensor:
    """AR rollout -> (steps, 18) predicted feature frames, on ``device``
    (``cuda:0`` unless named; the model must be there). The model runs in
    eval mode for the call; the caller's mode is restored."""
    device = resolve_device(device)
    fb = torch.as_tensor(fbank_windows, dtype=torch.float32).to(device)
    ctx = torch.as_tensor(context_init, dtype=torch.float32).to(device)
    was_training = model.training
    model.eval()
    try:
        rows = []
        for s in range(fb.shape[0]):
            y = model(fb[s:s + 1], ctx[None])  # (1, 1, 18)
            row = split_and_form(ctx[None], y, delta_order, base_size)[0, 0]
            ctx = torch.cat([ctx[1:], row[None]], dim=0)
            rows.append(row)
        return torch.stack(rows)
    finally:
        model.train(was_training)
