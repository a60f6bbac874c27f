"""FFT cross-correlation lag search for corpus audio alignment.

Counterpart of ``multimodalreactiongeneration_tpu/ops/xcorr.py``: the
reference's coarse->fine grid matching (reference mr_gen/utils/
data_analysis/data_alignment.py:92-227, an O(N*W) dot-product loop over
RMS grids) becomes the exact argmax-lag cross-correlation in O(N log N):
one ``torch.fft`` pass over 1/100 s RMS envelopes (coarse), then one
over a window at the full rate (fine). The envelopes are host numpy in
float64, as in JAX; the correlations run in float32 on the device
``resolve_device`` gives (the card unless the caller names one).

Two signals whose correlation has two near-equal peaks may take either
under another FFT: the lag is the argmax of a float32 correlation.
"""

from __future__ import annotations

import numpy as np
import torch

from multimodalreactiongeneration_tpu_torch import resolve_device


def rms_envelope(x: np.ndarray, grid: int) -> np.ndarray:
    """Reference make_grid_single: RMS over non-overlapping grid windows."""
    n = len(x) // grid
    if n == 0:
        return np.zeros((0,), np.float32)
    w = x[: n * grid].reshape(n, grid).astype(np.float64)
    return np.sqrt((w**2).mean(axis=-1)).astype(np.float32)


def best_lag(a: np.ndarray, b: np.ndarray, device=None) -> int:
    """Delay of b relative to a: returns s such that b[t] ~= a[t - s]
    (positive s: b starts later than a).

    With zero padding to n_fft >= len(a) + len(b), circular indices
    0..len(a)-1 are the positive lags of the correlation
    sum_t a[t] * b[t - l] and n_fft-len(b)+1..n_fft-1 wrap to the
    negative ones, so the index unwraps at len(a), not at n_fft // 2: a
    midpoint split misreads large positive lags of unequal-length
    signals as negative."""
    device = resolve_device(device)
    n_fft = int(2 ** np.ceil(np.log2(len(a) + len(b))))
    ta = torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)
    tb = torch.as_tensor(np.asarray(b), dtype=torch.float32, device=device)
    fa = torch.fft.rfft(ta, n_fft)
    fb = torch.fft.rfft(tb, n_fft)
    corr = torch.fft.irfft(fa * torch.conj(fb), n_fft)
    idx = int(torch.argmax(corr))
    return -(idx - n_fft if idx >= len(a) else idx)


def align_shift(
    target0: np.ndarray,
    target1: np.ndarray,
    sample_rate: int = 16000,
    coarse_div: int = 100,
    device=None,
) -> int:
    """Two-stage shift estimate (reference get_time_shift :179-227).

    Returns samples to shift target1 by (positive: target1 starts later).
    Stage 1: exact FFT xcorr on 1/coarse_div-second RMS envelopes.
    Stage 2: exact FFT xcorr on a +-2 coarse-cell window at full rate.
    """
    device = resolve_device(device)
    grid = max(sample_rate // coarse_div, 1)
    e0 = rms_envelope(target0, grid)
    e1 = rms_envelope(target1, grid)
    coarse = best_lag(e0, e1, device) * grid

    # fine: the residual lag between the coarsely aligned signals over
    # the loudest ~10 s window (exact, sample resolution); b delayed by
    # ~coarse: content b[coarse + t] ~ a[t]
    start0 = max(-coarse, 0)
    start1 = max(coarse, 0)
    n = min(len(target0) - start0, len(target1) - start1)
    if n <= 4 * grid:
        return coarse
    seg0 = target0[start0 : start0 + n]
    seg1 = target1[start1 : start1 + n]
    window = min(n, 10 * sample_rate)
    center = int(np.argmax(np.abs(seg0)))
    lo = max(min(center - window // 2, n - window), 0)
    fine = best_lag(seg0[lo : lo + window], seg1[lo : lo + window], device)
    if abs(fine) > 2 * grid:
        # the residual can only be sub-cell after a correct coarse pass;
        # a larger "fine" lag means the windowed xcorr locked onto a
        # repeat period (music bed, repeated utterance): keep coarse
        return coarse
    return int(coarse + fine)
