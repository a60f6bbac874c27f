"""Device-resident corpus audio: upload once, slice on the device.

Counterpart of ``multimodalreactiongeneration_tpu/data/audio_cache.py``:
each partner wav uploads ONCE as a row of a zero-padded int16 bank on the
device, and every batch gathers its sample slices there with one indexed
read, so no audio crosses the host link after the upload. The gather
equals the host read path: bank rows are zero past each file's data
(= read-past-EOF zeros), each gathered row is zeroed past its true slice
length (= the collate's tail rule), and the PCM16 -> f32 scale happens in
``ops/dsp.py batched_logmel_masked`` as for uploaded int16 waves.

The bank is a rectangular (n_files, max_file_len + max_slice) int16
tensor; ``build`` returns None when it would exceed ``budget_bytes``, and
the loader then reads slices on the host.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence

import numpy as np
import torch

from multimodalreactiongeneration_tpu_torch.utils import wavio

logger = logging.getLogger(__name__)


class DeviceAudioCache:
    """int16 wav bank on the device + batched slice gather."""

    def __init__(self, bank: torch.Tensor, index, file_lens):
        self._bank = bank            # (n_files, s_pad) int16 on the device
        self._index = index          # path -> row
        self._file_lens = file_lens  # true sample counts

    @property
    def nbytes(self) -> int:
        return self._bank.numel() * 2

    @property
    def device(self) -> torch.device:
        return self._bank.device

    @classmethod
    def build(cls, paths: Sequence[str], max_slice_samples: int,
              budget_bytes: int, device) -> Optional["DeviceAudioCache"]:
        """Upload ``paths`` (channel 0) to ``device`` once; None if over
        budget."""
        paths = sorted(set(paths))
        if not paths:
            return None
        lens = [wavio.wav_info(p)[1] for p in paths]
        s_pad = max(lens) + int(max_slice_samples)
        total = len(paths) * s_pad * 2
        if total > budget_bytes:
            logger.info(
                "audio cache disabled: %d files x %d samples = %.0f MB "
                "exceeds budget %.0f MB",
                len(paths), s_pad, total / 1e6, budget_bytes / 1e6,
            )
            return None
        host = np.zeros((len(paths), s_pad), np.int16)
        for i, p in enumerate(paths):
            data, _ = wavio.read_wav(p, 0, -1, dtype=np.int16)
            host[i, : data.shape[1]] = data[0]
        bank = torch.from_numpy(host).to(device)
        return cls(bank, {p: i for i, p in enumerate(paths)},
                   np.asarray(lens))

    @classmethod
    def build_for_dataset(cls, dataset, audio_cfg: dict,
                          pad_to_multiple: int, ratio: int,
                          budget_bytes: int, device
                          ) -> Optional["DeviceAudioCache"]:
        """Size the slice bound from the dataset's longest segment."""
        lengths = dataset.segment_lengths()
        if len(lengths) == 0:
            return None
        tm_max = int(lengths.max())
        tm_max = -(-tm_max // pad_to_multiple) * pad_to_multiple
        delta = int(audio_cfg.get("delta_order", 2))
        max_slice = ((tm_max * ratio + delta - 1) * int(audio_cfg["shift"])
                     + int(audio_cfg["nfft"]))
        return cls.build(dataset.audio_paths(), max_slice, budget_bytes,
                         device)

    def gather(self, paths: List[str], starts: List[int],
               true_lens: List[int], samples_needed: int
               ) -> Optional[torch.Tensor]:
        """(B, samples_needed) int16 rows on the device, or None on a
        miss (an unknown path, or a slice past the bank's right edge)."""
        try:
            rows = [self._index[p] for p in paths]
        except KeyError:
            return None
        if max(starts) + samples_needed > self._bank.shape[1]:
            return None
        dev = self._bank.device
        idx = torch.tensor(rows, device=dev)[:, None]
        cols = (torch.tensor(starts, device=dev)[:, None]
                + torch.arange(samples_needed, device=dev)[None, :])
        wave = self._bank[idx, cols]
        keep = (torch.arange(samples_needed, device=dev)[None, :]
                < torch.tensor(true_lens, device=dev)[:, None])
        return torch.where(keep, wave, torch.zeros((), dtype=wave.dtype,
                                                   device=dev))
