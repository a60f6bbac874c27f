"""Manifest builder v1: fixed windows for SimpleLSTM.

A host copy of ``multimodalreactiongeneration_tpu/data/databuild.py`` (the
port imports nothing of the JAX package). Behavior-matched to the
reference mr_gen/databuild/databuild.py:
  * walks the corpus for host/comp wavs, pairs each with its sibling
    .head directory (:179-187)
  * every ``sample_stride``-th frame emits a window manifest
    {head_dir, wav_file, context{start,end,stride}, target{...},
    audio{start,end}} with delta margins and the audio/head offset
    arithmetic preserved exactly (:198-285)
  * windows containing undetected-face frames are skipped by scanning
    the .head pickles (is_head_none, :158-168)
  * the same JSON-fingerprint cache protocol as the NX builder.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
from datetime import datetime
from typing import Any, Dict, List, Optional

from multimodalreactiongeneration_tpu_torch.data.head_io import load_head_file
from multimodalreactiongeneration_tpu_torch.utils.logging import DummyLogger
from multimodalreactiongeneration_tpu_torch.utils.wavio import wav_info

CACHE_DIRNAME = "temp"
DATAINFO_FILE = "datainfo.json"
DATASET_FILE = "dataset.json"
ZERO_PADDING = 5


@dataclasses.dataclass
class DataBuildConfig:
    """Validated v1 build config (reference DataBuildData :27-79)."""

    data_dir: str
    fps: float
    context_start: int
    sample_stride: int
    context_size: int
    context_stride: int
    target_type: str
    target_position: int
    target_size: int
    target_stride: int
    delta_order: int

    sample_rate: int
    nfft: int
    shift: int

    use_centroid: bool
    use_angle: bool

    def __post_init__(self):
        self.context_length = self.context_size * self.context_stride
        self.context_end = self.context_start + self.context_length
        self.target_length = self.target_size * self.target_stride
        self.target_end = self.target_position + self.target_length

        if self.target_type not in ("direct", "context"):
            raise ValueError("target_type must be 'direct' or 'context'")
        if self.target_type == "direct" and self.target_size != 1:
            raise ValueError("target_size must be 1 when target_type is 'direct'")
        if self.target_size < 1 or self.context_size < 1:
            raise ValueError("sizes must be positive")
        if self.context_start >= 0:
            raise ValueError("context_start must be negative")
        if self.context_stride < 1 or self.sample_stride < 1:
            raise ValueError("strides must be positive")

        self.fft_freq = self.sample_rate / self.shift
        self.sample_fps = self.fps / self.context_stride
        if self.fft_freq / self.sample_fps % 1 != 0:
            raise ValueError(
                "stft frequency (sample_rate/shift) must be a multiple of fps"
            )


class DataBuilder(DataBuildConfig):
    def __init__(self, cfg, logger=None, cache_root: str = "./data"):
        content = {
            k: cfg[k] for k in cfg if k not in ("no_cache_build", "clear_cache")
        }
        self.no_cache_build = cfg.get("no_cache_build", False)
        self.clear_cache = cfg.get("clear_cache", False)
        super().__init__(**content)

        self.logger = logger if logger is not None else DummyLogger()
        self.cache_path = os.path.join(cache_root, CACHE_DIRNAME)
        os.makedirs(self.cache_path, exist_ok=True)

        ymd = datetime.now().strftime("%Y%m%d%H%M%S%f")
        self.base_dir_name = os.path.split(self.data_dir.rstrip("/"))[-1]
        self.data_site = os.path.join(
            self.cache_path, f"{self.base_dir_name}_{ymd}"
        )

        if self.clear_cache:
            self.logger.info("Clear dataset cache.")
            shutil.rmtree(self.cache_path)
            os.makedirs(self.cache_path)

        if not self._judge_rebuild():
            self.data_site = self._check_cache()
            self.logger.info("Already built data.")
            return
        self.logger.info("No cache found (or rebuild requested).")

        self.data_file = os.path.join(self.data_site, DATASET_FILE)
        self.wav_list = self._collect_wavs()

        self.logger.info("Start building data.")
        self.build()
        self.logger.info("Finished building data.")

    def _collect_wavs(self) -> List[str]:
        out = []
        for root, _, files in os.walk(self.data_dir):
            for name in files:
                if name.endswith(".wav") and (
                    "host" in name or "comp" in name
                ):
                    out.append(os.path.join(root, name))
        return sorted(out)

    # -- cache protocol -------------------------------------------------------
    def _config_fingerprint(self) -> Dict[str, Any]:
        return {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(DataBuildConfig)
        }

    def _check_cache(self) -> Optional[str]:
        for entry in sorted(os.listdir(self.cache_path)):
            if entry.rsplit("_", maxsplit=1)[0] != self.base_dir_name:
                continue
            info = os.path.join(self.cache_path, entry, DATAINFO_FILE)
            if os.path.exists(info):
                with open(info, "r", encoding="utf-8") as f:
                    if json.load(f) == self._config_fingerprint():
                        return os.path.join(self.cache_path, entry)
        return None

    def _judge_rebuild(self) -> bool:
        prev = self._check_cache()
        if prev and not self.no_cache_build:
            return False
        if prev and self.no_cache_build:
            self.logger.info(f"Clear previous cache : {prev}")
            shutil.rmtree(prev)
        os.makedirs(self.data_site)
        with open(
            os.path.join(self.data_site, DATAINFO_FILE), "w", encoding="utf-8"
        ) as f:
            json.dump(self._config_fingerprint(), f)
        return True

    # -- window emission ------------------------------------------------------
    def is_head_none(self, head_dir: str, start: int, end: int, stride: int):
        base = os.path.split(head_dir)[1]
        for idx in range(start, end, stride):
            name = f"{base}_{str(idx).zfill(ZERO_PADDING)}.head"
            _, face = load_head_file(os.path.join(head_dir, name))
            if face is None:
                return True
        return False

    def build(self):
        for wav_file in self.wav_list:
            base_path, wav_name = os.path.split(wav_file)
            base_name = wav_name.rsplit(".", maxsplit=1)[0]
            head_dir = os.path.join(base_path, base_name)
            if not os.path.isdir(head_dir):
                continue
            self.make_segment(head_dir, wav_file)

    def make_segment(self, head_dir: str, wav_file: str):
        head_len = len(os.listdir(head_dir))

        # audio/head offset arithmetic (reference :202-204)
        audio_offset = (self.shift * self.delta_order) + (self.nfft - self.shift)
        head_offset = math.ceil(audio_offset * self.fps / self.sample_rate) + 1

        sample_rate, audio_samples, _ = wav_info(wav_file)
        if sample_rate != self.sample_rate:
            raise ValueError("sample rate of wav file does not match")

        path, dir_name = os.path.split(head_dir)
        _, base_name = os.path.split(path)
        target_name = os.path.join(base_name, dir_name)

        for i in range(0, head_len, self.sample_stride):
            minimum_start = (
                abs(self.context_start)
                + self.delta_order * self.context_stride
                + head_offset
            )
            if i < minimum_start:
                continue
            if i + self.target_position + self.target_length + 1 > head_len:
                break

            jdic = {
                "head_dir": head_dir,
                "wav_file": wav_file,
                "fps": self.fps,
                "sample_fps": self.sample_fps,
                "idx": i,
            }

            cntx_start = (
                i + self.context_start - self.delta_order * self.context_stride
            )
            cntx_end = i + self.context_end
            if self.is_head_none(head_dir, cntx_start, cntx_end, self.context_stride):
                continue
            jdic["context"] = {
                "start": cntx_start,
                "end": cntx_end,
                "stride": self.context_stride,
            }

            trgt_start = (
                i + self.target_position - self.delta_order * self.target_stride
            )
            trgt_end = i + self.target_end
            if self.is_head_none(head_dir, trgt_start, trgt_end, self.target_stride):
                continue
            jdic["target"] = {
                "start": trgt_start,
                "end": trgt_end,
                "stride": self.target_stride,
            }

            fft_length = int(self.context_size * self.fft_freq / self.sample_fps)
            sample_length = fft_length * self.shift + audio_offset
            audio_end = int(cntx_end * self.sample_rate / self.fps)
            audio_start = audio_end - sample_length
            if audio_start < 0 or audio_end > audio_samples:
                continue
            jdic["audio"] = {"start": audio_start, "end": audio_end}
            jdic["delta_order"] = self.delta_order

            ext_name = "_".join(os.path.split(target_name)) + str(i) + ".json"
            output_path = (
                self.data_file.rsplit(".", maxsplit=1)[0] + "_" + ext_name
            )
            with open(output_path, "w", encoding="utf-8") as f:
                f.write(json.dumps(jdic) + "\n")
