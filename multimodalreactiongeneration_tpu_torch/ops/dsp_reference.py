"""Kaldi-style FBANK / MFCC / SPEC extractor, batched over frames.

Counterpart of ``multimodalreactiongeneration_tpu/ops/dsp_reference.py``
(spec source: reference mr_gen/utils/tools/feature_extractor.py, its
from-scratch NumPy DSP): the frame-at-a-time loop becomes one batched
graph on the device ``resolve_device`` gives (the card unless the caller
names one):

  * dithering: uniform(-d, d) per sample, drawn from the caller's
    ``torch.Generator`` (on the wave's device) and only when one is given;
    JAX draws from a PRNG key, so the two share bits only without dither
  * DC cut per frame (:136), log frame power floored at 1e-10 (:139-144)
  * pre-emphasis 0.97 with the first-sample convention window[0] *= 0.03
    (:147-152)
  * Hamming window (:154-156), rFFT at the next power of two, power
    spectrum
  * mel triangles on 1127*ln(1+f/700), low/high cutoffs, floored at 0.1
    (:80-116, 192)
  * MFCC: orthonormal DCT-II, sinusoidal liftering, C0 replaced by the
    log power (:233-269)
  * SPEC: dB re 2e-5 magnitude spectrum (:202-231)
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from multimodalreactiongeneration_tpu_torch import resolve_device


def herz_to_mel(freq):
    return 1127.0 * np.log(1.0 + np.asarray(freq, dtype=np.float64) / 700.0)


@dataclass(frozen=True)
class KaldiParams:
    sample_frequency: float = 16000.0
    frame_length_ms: int = 25
    frame_shift_ms: int = 10
    num_mel_bins: int = 23
    num_ceps: int = 13
    lifter_coef: float = 22.0
    low_frequency: float = 20.0
    high_frequency: float = 8000.0
    dither: float = 1e-6

    @property
    def frame_size(self) -> int:
        return int(self.sample_frequency * self.frame_length_ms * 0.001)

    @property
    def frame_shift(self) -> int:
        return int(self.sample_frequency * self.frame_shift_ms * 0.001)

    @property
    def fft_size(self) -> int:
        n = 1
        while n < self.frame_size:
            n *= 2
        return n


@functools.lru_cache(maxsize=4)
def _constants(p: KaldiParams):
    """(mel filterbank, DCT, lifter, Hamming window) as float32 numpy."""
    dim_spectrum = p.fft_size // 2 + 1
    mel_points = np.linspace(
        herz_to_mel(p.low_frequency), herz_to_mel(p.high_frequency),
        p.num_mel_bins + 2,
    )
    freqs = np.arange(dim_spectrum) * p.sample_frequency / 2 / dim_spectrum
    mels = herz_to_mel(freqs)
    fb = np.zeros((p.num_mel_bins, dim_spectrum))
    for m in range(p.num_mel_bins):
        left, center, right = mel_points[m : m + 3]
        up = (mels - left) / (center - left)
        down = (right - mels) / (right - center)
        w = np.where(mels <= center, up, down)
        fb[m] = np.where((mels > left) & (mels < right), w, 0.0)

    n = p.num_mel_bins
    dct = np.zeros((p.num_ceps, n))
    dct[0] = 1.0 / np.sqrt(n)
    for k in range(1, p.num_ceps):
        dct[k] = np.sqrt(2.0 / n) * np.cos(
            (2.0 * np.arange(n) + 1) * k * np.pi / (2 * n)
        )

    lifter = 1.0 + 0.5 * p.lifter_coef * np.sin(
        np.pi * np.arange(p.num_ceps) / p.lifter_coef
    )
    hamming = np.hamming(p.frame_size)
    return (
        fb.astype(np.float32),
        dct.astype(np.float32),
        lifter.astype(np.float32),
        hamming.astype(np.float32),
    )


def _const(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(a).to(device)


def _rfft(frames: torch.Tensor, n: int) -> torch.Tensor:
    """rFFT of each frame at size n (no frames: an empty spectrum; the
    CPU's FFT refuses an empty batch)."""
    if frames.shape[0] == 0:
        return torch.zeros((0, n // 2 + 1), dtype=torch.complex64,
                           device=frames.device)
    return torch.fft.rfft(frames, n=n)


def _windows(wave, p: KaldiParams, generator, device):
    """(S,) -> preprocessed frames (T, frame_size) + log power (T,)."""
    wave = torch.as_tensor(wave, dtype=torch.float32, device=device)
    if wave.shape[-1] < p.frame_size:
        frames = wave.new_zeros((0, p.frame_size))
    else:
        frames = wave.unfold(0, p.frame_size, p.frame_shift)
    if p.dither > 0 and generator is not None:
        noise = torch.rand(frames.shape, generator=generator,
                           device=frames.device, dtype=frames.dtype)
        frames = frames + (noise * 2.0 - 1.0) * p.dither
    frames = frames - frames.mean(-1, keepdim=True)
    power = (frames * frames).sum(-1)
    log_power = torch.log(torch.clamp(power, min=1e-10))
    # pre-emphasis with the window[0] *= (1 - 0.97) convention
    shifted = torch.cat([frames[:, :1], frames[:, :-1]], -1)
    pre = frames - 0.97 * shifted
    pre[:, 0] = frames[:, 0] * (1.0 - 0.97)
    _, _, _, hamming = _constants(p)
    return pre * _const(hamming, frames.device), log_power


def compute_fbank(
    wave, p: KaldiParams, generator: Optional[torch.Generator] = None,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(S,) -> (fbank (T, num_mel_bins), log_power (T,))."""
    device = resolve_device(device)
    fb, _, _, _ = _constants(p)
    frames, log_power = _windows(wave, p, generator, device)
    spec = _rfft(frames, p.fft_size).abs() ** 2
    mel = spec @ _const(fb, device).T
    return torch.log(torch.clamp(mel, min=0.1)), log_power


def compute_mfcc(
    wave, p: KaldiParams, generator: Optional[torch.Generator] = None,
    device=None,
) -> torch.Tensor:
    """(S,) -> (T, num_ceps) with C0 = log power."""
    device = resolve_device(device)
    _, dct, lifter, _ = _constants(p)
    fbank, log_power = compute_fbank(wave, p, generator, device)
    mfcc = (fbank @ _const(dct, device).T) * _const(lifter, device)
    mfcc[:, 0] = log_power
    return mfcc


def compute_spec(
    wave, p: KaldiParams, generator: Optional[torch.Generator] = None,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(S,) -> (dB spectrum (T, fft/2+1), log_power (T,))."""
    device = resolve_device(device)
    frames, log_power = _windows(wave, p, generator, device)
    mag = _rfft(frames, p.fft_size).abs()
    return 20.0 * torch.log10(mag / 2e-5), log_power
