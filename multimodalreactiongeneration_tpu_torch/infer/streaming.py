"""Streaming reaction generation: one Metaformer step per 80 ms of audio.

Counterpart of ``multimodalreactiongeneration_tpu/infer/streaming.py``.
A ``StreamingSession`` generates a 12.5 fps head-motion stream from live
partner audio and motion: per step it takes ``hop_samples`` new audio
samples (1280 at 16 kHz, ``ratio`` fbank hops) and one partner-motion
feature frame, and returns one self-motion feature frame.

Per step, on the session's device: the fbank of the kept left context
and the new hop (``ops/dsp.py logmel_with_power``), then one module step
on the in-loop layout of ``infer/generate.py`` (block 0 encodes the
step's audio and partner frame; the 8-frame chunks run the plain
recurrences). ``prime`` warms the states on a leading segment, which on
the card runs the mixer-stack kernel (K1) over the lead's audio.

The left context (``delta_order`` extra frames and the window-hop
overlap, rounded up to a hop multiple) puts the streamed frames on the
offline frame grid, so streamed features equal the offline features of
the whole signal.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from multimodalreactiongeneration_tpu_torch.infer.generate import (
    _init_metaformer_states,
    eval_mode,
)
from multimodalreactiongeneration_tpu_torch.models.lstmformer import (
    derived_sizes,
)
from multimodalreactiongeneration_tpu_torch.ops import dsp


def fbank_stream_geometry(cfg: dict):
    """(FbankParams, ratio, hop_samples, context_samples) for streaming."""
    fbp = dsp.FbankParams(
        sample_rate=cfg["sampling_rate"],
        n_fft=400,
        hop=cfg["shift"],
        n_mels=cfg["nmels"],
        delta_order=cfg["delta_order"],
    )
    acoustic_fps = cfg["sampling_rate"] / cfg["shift"]
    ratio = int(acoustic_fps / cfg["pred_fps"])
    hop_samples = ratio * fbp.hop
    raw_context = fbp.delta_order * fbp.hop + (fbp.n_fft - fbp.hop)
    context_samples = -(-raw_context // fbp.hop) * fbp.hop
    return fbp, ratio, hop_samples, context_samples


class MotionDeltaStream:
    """Incremental delta stacking for a raw pose stream: emits [x, d1,
    d2] (``ops/dsp.py delta_stack``) once ``delta_order`` earlier frames
    exist, None before."""

    def __init__(self, delta_order: int = 2):
        self.delta_order = delta_order
        self._prev: list = []

    def push(self, pose: np.ndarray) -> Optional[np.ndarray]:
        self._prev.append(np.asarray(pose, np.float32))
        if len(self._prev) < self.delta_order + 1:
            return None
        self._prev = self._prev[-(self.delta_order + 1):]
        x = self._prev
        if self.delta_order == 0:
            return x[-1]
        if self.delta_order == 1:
            return np.concatenate([x[-1], x[-1] - x[-2]])
        d1 = x[-1] - x[-2]
        d1_prev = x[-2] - x[-3]
        return np.concatenate([x[-1], d1, d1 - d1_prev])


def _as_input(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32)).to(device)


class StreamingSession:
    """Stateful 12.5 fps generation session for the Metaformer, on the
    device of the model's parameters.

    kv_layout: "shared" unless the config needs "per_block"
    (repeat_with_encoder), as in JAX. The rings are bf16, the
    ``_init_metaformer_states`` default; ``states`` may be replaced
    before the first call (f32 rings for a parity check)."""

    def __init__(self, model, batch: int = 1, kv_layout: str = None):
        self.model = model
        self.cfg = model.cfg
        self.batch = batch
        self.device = next(model.parameters()).device
        if kv_layout is None:
            kv_layout = (
                "per_block" if self.cfg["repeat_with_encoder"] else "shared"
            )
        self.kv_layout = kv_layout
        fbp, self.ratio, self.hop_samples, self.context_samples = (
            fbank_stream_geometry(self.cfg)
        )
        self.fb_params = fbp
        self.warmup_frames = self.context_samples // fbp.hop
        self.buf_samples = self.hop_samples + self.context_samples
        self._audio_tail = np.zeros((batch, self.context_samples), np.float32)
        self.states = _init_metaformer_states(
            self.cfg, batch, kv_layout=kv_layout, device=self.device
        )
        feat = derived_sizes(self.cfg)["motion_input_size"]
        self._prev = torch.zeros(batch, 1, feat, device=self.device)

    @torch.no_grad()
    def prime(self, lead_audio, lead_mp, lead_ms) -> None:
        """Warm the rings and states on a leading segment (feature-space
        inputs: (B, L*ratio, F), (B, L, D), (B, L, D)) and seed the AR
        loop with the last lead self-motion frame."""
        lead_ms = _as_input(lead_ms, self.device)
        with eval_mode(self.model):
            _, self.states = self.model(
                _as_input(lead_audio, self.device),
                _as_input(lead_mp, self.device),
                lead_ms,
                states=self.states,
                use_masks=True,
            )
        self._prev = lead_ms[:, -1:].clone()

    @torch.no_grad()
    def step(self, audio_samples: np.ndarray,
             partner_motion: np.ndarray) -> np.ndarray:
        """audio_samples (B, hop_samples) raw f32; partner_motion (B, 1, D)
        feature frame. Returns the predicted (B, 1, D) self-motion frame."""
        audio_samples = np.asarray(audio_samples, np.float32)
        if audio_samples.shape[-1] != self.hop_samples:
            raise ValueError(
                f"need {self.hop_samples} samples per step, "
                f"got {audio_samples.shape[-1]}"
            )
        buf = np.concatenate([self._audio_tail, audio_samples], axis=-1)
        self._audio_tail = buf[:, -self.context_samples:]
        feat = dsp.logmel_with_power(_as_input(buf, self.device),
                                     self.fb_params)
        with eval_mode(self.model):
            y, self.states = self.model(
                feat, _as_input(partner_motion, self.device), self._prev,
                states=self.states, use_masks=False,
            )
        self._prev = y
        return y.cpu().numpy()
