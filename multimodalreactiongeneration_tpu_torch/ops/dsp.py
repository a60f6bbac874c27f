"""Audio features: framing, mel fbank, log-power and deltas, as torch ops.

Counterpart of ``multimodalreactiongeneration_tpu/ops/dsp.py`` (XLA code
there, not a Pallas kernel), on the caller's device: the windowed DFT is
one framed matrix product against precomputed cos/sin bases, frames
(T, 400) @ basis (400, 201), followed by the mel projection (201, 26),
the log clamp, the un-windowed log frame energy and the delta stack.

Numeric targets (tests/test_dsp.py's goldens):
  * hann window: periodic torch.hann_window(n_fft)
  * mel scale: HTK, f_min 0, f_max sr/2, no filterbank norm
  * power spectrum |X|^2, log with clamp at 1e-6
  * log-power: un-windowed frame energy, clamp 1e-10
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

LOG_CLAMP_MEL = 1e-6
LOG_CLAMP_POWER = 1e-10


def hann_window(n: int) -> np.ndarray:
    """Periodic Hann window, identical to torch.hann_window(n)."""
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / n))


def hz_to_mel(freq):
    """HTK mel scale (torchaudio mel_scale='htk')."""
    return 2595.0 * np.log10(1.0 + np.asarray(freq, dtype=np.float64) / 700.0)


def mel_to_hz(mel):
    return 700.0 * (10.0 ** (np.asarray(mel, dtype=np.float64) / 2595.0) - 1.0)


def mel_filterbank(n_freqs: int, n_mels: int, sample_rate: int,
                   f_min: float = 0.0, f_max: float | None = None
                   ) -> np.ndarray:
    """Triangular HTK mel filterbank, (n_freqs, n_mels), norm=None
    (torchaudio.functional.melscale_fbanks)."""
    f_max = f_max if f_max is not None else sample_rate / 2.0
    all_freqs = np.linspace(0.0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(hz_to_mel(f_min), hz_to_mel(f_max), n_mels + 2)
    f_pts = mel_to_hz(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down_slopes = -slopes[:, :-2] / f_diff[:-1]
    up_slopes = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down_slopes, up_slopes))
    return fb.astype(np.float32)


@dataclass(frozen=True)
class FbankParams:
    """Static DSP configuration."""

    sample_rate: int = 16000
    n_fft: int = 400
    hop: int = 160
    n_mels: int = 26
    delta_order: int = 2

    @property
    def feat_dim(self) -> int:
        return (self.n_mels + 1) * (self.delta_order + 1)

    def num_frames(self, num_samples: int) -> int:
        return (num_samples - self.n_fft) // self.hop + 1

    def num_output_frames(self, num_samples: int) -> int:
        return self.num_frames(num_samples) - self.delta_order


@functools.lru_cache(maxsize=8)
def _bases_np(params: FbankParams):
    """(windowed DFT cos, sin, mel fb) as numpy f32 constants."""
    n_fft = params.n_fft
    n_freqs = n_fft // 2 + 1
    win = hann_window(n_fft)
    k = np.arange(n_fft)[:, None] * np.arange(n_freqs)[None, :]
    angle = 2.0 * np.pi * k / n_fft
    cos_b = (np.cos(angle) * win[:, None]).astype(np.float32)
    sin_b = (-np.sin(angle) * win[:, None]).astype(np.float32)
    mel_fb = mel_filterbank(n_freqs, params.n_mels, params.sample_rate)
    return cos_b, sin_b, mel_fb


def _bases(params: FbankParams, device):
    return [torch.from_numpy(b).to(device) for b in _bases_np(params)]


def frame_signal(wave: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(..., S) -> (..., T, n_fft) frame matrix, center=False."""
    return wave.unfold(-1, n_fft, hop)


def delta_stack(feat: torch.Tensor, delta_order: int) -> torch.Tensor:
    """First/second finite-difference stacking over the frame axis (-2):
    order 0 (T, D); 1 (T-1, 2D) [feat, d1]; 2 (T-2, 3D) [feat, d1, d2]."""
    if delta_order == 0:
        return feat
    d1 = feat[..., 1:, :] - feat[..., :-1, :]
    if delta_order == 1:
        return torch.cat([feat[..., 1:, :], d1], dim=-1)
    if delta_order == 2:
        d2 = d1[..., 1:, :] - d1[..., :-1, :]
        return torch.cat([feat[..., 2:, :], d1[..., 1:, :], d2], dim=-1)
    raise ValueError("delta_order must be 0, 1 or 2")


def logmel_with_power(wave: torch.Tensor, params: FbankParams
                      ) -> torch.Tensor:
    """(..., S) f32 -> (..., T - delta, (n_mels+1)(delta+1))."""
    cos_b, sin_b, mel_fb = _bases(params, wave.device)
    frames = frame_signal(wave.float(), params.n_fft, params.hop)
    re = frames @ cos_b
    im = frames @ sin_b
    mel = (re * re + im * im) @ mel_fb
    log_mel = torch.log(torch.clamp(mel, min=LOG_CLAMP_MEL))
    energy = torch.sum(frames * frames, dim=-1, keepdim=True)
    log_power = torch.log(torch.clamp(energy, min=LOG_CLAMP_POWER))
    feat = torch.cat([log_mel, log_power], dim=-1)
    return delta_stack(feat, params.delta_order)


def batched_logmel_masked(waves: torch.Tensor, frame_counts: torch.Tensor,
                          params: FbankParams, pad_value: float
                          ) -> torch.Tensor:
    """(B, S) + (B,) true frame counts -> (B, T - delta, D) with the rows
    past each sample's frame count set to ``pad_value``. Integer waves
    are raw PCM16, scaled by 1/2**15 (exact in f32)."""
    if not waves.is_floating_point():
        waves = waves.float() * (1.0 / 32768.0)
    feats = logmel_with_power(waves, params)
    t = feats.shape[1]
    frame_counts = torch.as_tensor(frame_counts, device=feats.device)
    mask = torch.arange(t, device=feats.device)[None, :] < frame_counts[:, None]
    return torch.where(mask[:, :, None], feats,
                       torch.tensor(pad_value, dtype=feats.dtype,
                                    device=feats.device))
