"""Manifest builder v2 ("NX"): turn-windowed streaming segments.

A copy of ``multimodalreactiongeneration_tpu/data/databuild_nx.py``,
importing the port's own segmentation and logging. Behavior-matched to
the reference's mr_gen/databuild/databuild_nx.py:
  * per session, pair {host,comp} x {wav, npz[]}, run two-party turn
    segmentation on both channels (:159-214)
  * build an ignore mask from npz section gaps (:344-389)
  * slide [max_len, min_len, shift_len] windows inside partner-turn
    sections with leading warmup and target shift; all the index
    arithmetic — audio_offset = (nfft - shift) + shift*delta_order,
    motion_offset, delta margins, pred_shift phase — preserved exactly
    (:391-442); see utils/timebase.py for the shared arithmetic
  * emit per-segment one-line JSON manifests
    {partner_motion, partner_audio, self_motion, self_audio, target}
    (:252-342) with identical key layout so reference-built manifests and
    ours interchange
  * config-keyed cache: a build is reusable iff the full build config is
    equal (:132-157); we compare the config dict (JSON) instead of
    pickling the builder object

Host-side by design: runs once per corpus; the heavy DSP (VAD energy) is
vectorized numpy, everything else is file IO and control flow.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
from datetime import datetime
from typing import Dict, Generator, List, Optional, Tuple

import numpy as np

from multimodalreactiongeneration_tpu_torch.data.segmentation import get_utterance_section
from multimodalreactiongeneration_tpu_torch.utils.logging import DummyLogger

CACHE_DIRNAME = "temp"
DATAINFO_FILE = "datainfo.json"
DATASET_FILE = "dataset.json"
ZERO_PADDING = 5


@dataclasses.dataclass
class DataBuildConfigNX:
    """Validated build config (reference DataBuildDataNX :27-84)."""

    data_dir: str
    fps: float
    pred_fps: Optional[float]
    pred_shift: Optional[int]
    max_len: int
    min_len: int
    shift_len: int
    leading_len: int

    sample_rate: int
    nfft: int
    shift: int

    threshold: float
    minimum_utterance_length: float
    pause_with_voice: float
    pause_without_voice: float
    mergin: float

    use_partner_motion: bool
    use_partner_audio: bool
    use_self_motion: bool
    use_self_audio: bool

    target_shift: int

    use_centroid: bool
    use_angle: bool
    delta_order: int

    def __post_init__(self):
        if self.pred_fps is None and self.pred_shift is None:
            raise ValueError("Specify either pred_fps or pred_shift.")
        if self.pred_fps is not None:
            if (self.fps / self.pred_fps) % 1 != 0:
                raise ValueError("pred_fps must divide fps")
            if (self.sample_rate / self.shift) / self.pred_fps % 1 != 0:
                raise ValueError("pred_fps must divide sample_rate/shift")
        if self.pred_shift is not None:
            if (self.sample_rate / self.shift) / self.pred_shift % 1 != 0:
                raise ValueError("pred_shift must divide sample_rate/shift")
        if self.max_len < self.min_len:
            raise ValueError("max_len must be >= min_len")

        if self.pred_fps is None:
            self.pred_fps = self.fps / self.pred_shift
        if self.pred_shift is None:
            self.pred_shift = int(self.fps / self.pred_fps)
        self.fft_rate = self.sample_rate / self.shift
        self.target_shift_real = self.target_shift * self.pred_shift
        # leading length snapped down to a pred_shift multiple (:69-70)
        self.leading_len -= self.leading_len % self.pred_shift


def collect_motion_ignore(
    host_motion: List[str], comp_motion: List[str]
) -> np.ndarray:
    """1 = frame unusable on either channel (reference :344-389).

    npz `section` fields are [start, stop) frame ranges with valid motion;
    gaps between sections and any tail difference are marked ignored.
    """

    def channel_mask(paths: List[str]) -> np.ndarray:
        mask = np.zeros((0,), np.int32)
        for path in paths:
            with np.load(path) as z:
                section = z["section"]
            if len(mask) < section[-1]:
                start, end = int(section[0]), int(section[1])
                gap = np.ones(start - len(mask), np.int32)
                body = np.zeros(end - start, np.int32)
                mask = np.concatenate([mask, gap, body])
        return mask

    m_host = channel_mask(host_motion)
    m_comp = channel_mask(comp_motion)
    max_len = max(len(m_host), len(m_comp))
    out = np.zeros(max_len, np.int32)
    tail = max_len - min(len(m_host), len(m_comp))
    if tail > 0:
        out[-tail:] = 1
    out[: len(m_host)] |= m_host
    out[: len(m_comp)] |= m_comp
    return out


class DataBuilderNX(DataBuildConfigNX):
    """Builds (or reuses) a manifest directory under <cache_root>/temp."""

    def __init__(self, cfg, logger=None, cache_root: str = "./data",
                 n_jobs: int = 1):
        content = {k: cfg[k] for k in cfg if k not in ("no_cache_build", "clear_cache")}
        self.no_cache_build = cfg.get("no_cache_build", False)
        self.clear_cache = cfg.get("clear_cache", False)
        super().__init__(**content)

        self.logger = logger if logger is not None else DummyLogger()
        self.n_jobs = n_jobs
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

        self.fft_fps_freq_rate = int(self.sample_rate / self.shift / self.fps)
        self.session_dirs = self._collect_sessions()
        if not self.session_dirs:
            raise AssertionError(f"Not found data under {self.data_dir}")

        self.logger.info("Start building data.")
        self.build()
        self.logger.info("Finished building data.")

    # -- cache protocol (reference :132-157) --------------------------------
    def _config_fingerprint(self) -> Dict:
        return {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(DataBuildConfigNX)
        }

    def _check_cache(self) -> Optional[str]:
        for entry in sorted(os.listdir(self.cache_path)):
            if entry.rsplit("_", maxsplit=1)[0] != self.base_dir_name:
                continue
            info = os.path.join(self.cache_path, entry, DATAINFO_FILE)
            if os.path.exists(info):
                with open(info, "r", encoding="utf-8") as f:
                    prev = json.load(f)
                if prev == self._config_fingerprint():
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

    # -- corpus walk (reference :159-191) ------------------------------------
    def _collect_sessions(self) -> List[str]:
        """Terminal directories whose path mentions 'data' (dfcon filter)."""
        sessions = []
        for root, dirs, files in os.walk(self.data_dir):
            if dirs:
                continue
            if "data" not in os.path.basename(root) and "data" not in root:
                continue
            sessions.append(root)
        return sorted(sessions)

    def build(self):
        from multimodalreactiongeneration_tpu_torch.utils.parallel import (
            parallel_launcher,
        )

        arg_list = []
        for session in self.session_dirs:
            wav_file = {"host": "", "comp": ""}
            motion_npz: Dict[str, List[str]] = {"host": [], "comp": []}
            for name in os.listdir(session):
                path = os.path.join(session, name)
                for who in ("host", "comp"):
                    if name.startswith(who) and name.endswith(".npz"):
                        motion_npz[who].append(path)
                    elif name.startswith(who) and name.endswith(".wav"):
                        wav_file[who] = path
            motion_npz["host"].sort()
            motion_npz["comp"].sort()
            if not (wav_file["host"] and wav_file["comp"]):
                continue
            arg_list.append((motion_npz, wav_file))
        parallel_launcher(
            self.make_segment_nx, arg_list, n_jobs=self.n_jobs, unpack=True
        )

    def make_segment_nx(
        self, motion_npz: Dict[str, List[str]], wav_file: Dict[str, str]
    ):
        ignore = collect_motion_ignore(motion_npz["host"], motion_npz["comp"])
        turn_comp, turn_host = get_utterance_section(
            wav_file["host"],
            wav_file["comp"],
            self.sample_rate,
            self.nfft,
            self.shift,
            self.threshold,
            self.minimum_utterance_length,
            self.pause_with_voice,
            self.pause_without_voice,
            self.mergin,
        )
        if len(turn_comp) == 0:
            self.logger.info(f"No utterance section: {wav_file['comp']}")
        if len(turn_host) == 0:
            self.logger.info(f"No utterance section: {wav_file['host']}")

        # self reacts while the PARTNER talks (reference :220-235)
        for who, partner in (("host", "comp"), ("comp", "host")):
            turns = turn_comp if partner == "comp" else turn_host
            if len(turns) == 0:
                continue
            data_name = os.path.split(os.path.dirname(wav_file[who]))[1]
            audio_name = os.path.basename(wav_file[who]).rsplit(".", 1)[0]
            out_name, out_ext = DATASET_FILE.rsplit(".", 1)
            output = os.path.join(
                self.data_site,
                f"{out_name}_{data_name}_{audio_name}.{out_ext}",
            )
            self.output_segment(
                output,
                turns,
                motion_npz[who],
                motion_npz[partner],
                ignore,
                wav_file[who],
                wav_file[partner],
            )

    # -- window emission (reference :252-342) --------------------------------
    def output_segment(
        self,
        output_path: str,
        turn_partner: np.ndarray,
        npz_self: List[str],
        npz_partner: List[str],
        ignores: np.ndarray,
        wav_self: str,
        wav_partner: str,
    ):
        def sections(paths):
            out = []
            for p in paths:
                with np.load(p) as z:
                    out.append(z["section"])
            return out

        sec_self = sections(npz_self)
        sec_partner = sections(npz_partner)

        for motion, audio in self.process_motion(turn_partner, ignores):
            start, end, s_lead, e_lead = motion
            s_audio, e_audio, sl_audio, el_audio = audio

            target_start = start + self.target_shift_real
            target_end = end + self.target_shift_real
            if ignores[target_start:target_end].sum() > 0:
                continue

            path_self, off_self = "", 0
            path_partner, off_partner = "", 0
            for i, sec in enumerate(sec_self):
                if sec[0] <= start and end <= sec[1]:
                    path_self, off_self = npz_self[i], int(sec[0])
                    break
            for i, sec in enumerate(sec_partner):
                if sec[0] <= start and end <= sec[1]:
                    path_partner, off_partner = npz_partner[i], int(sec[0])
                    break
            assert path_self and path_partner, (
                f"Cannot find motion data: {wav_self}\n"
                f"section: start={start}, end={end}\n"
                f"exist ignore: {ignores[start:end].sum() > 0}"
            )

            segment = {
                "partner_motion": {
                    "path": path_partner,
                    "seq": {"start": start, "end": end, "stride": self.pred_shift},
                    "lead": {
                        "start": s_lead,
                        "end": e_lead,
                        "stride": self.pred_shift,
                    },
                    "offset": off_partner,
                    "delta_order": self.delta_order,
                }
                if self.use_partner_motion
                else None,
                "partner_audio": {
                    "path": wav_partner,
                    "seq": {"start": s_audio, "end": e_audio, "stride": 1},
                    "lead": {"start": sl_audio, "end": el_audio, "stride": 1},
                    "delta_order": self.delta_order,
                }
                if self.use_partner_audio
                else None,
                "self_motion": {
                    "path": path_self,
                    "seq": {
                        "start": start,
                        "end": target_end,
                        "stride": self.pred_shift,
                    },
                    "lead": {
                        "start": s_lead,
                        "end": e_lead,
                        "stride": self.pred_shift,
                    },
                    "offset": off_self,
                    "delta_order": self.delta_order,
                }
                if self.use_self_motion
                else None,
                "self_audio": {
                    "path": wav_self,
                    "seq": {"start": s_audio, "end": e_audio, "stride": 1},
                    "lead": {"start": sl_audio, "end": el_audio, "stride": 1},
                    "delta_order": self.delta_order,
                }
                if self.use_self_audio
                else None,
                "target": {
                    "shift_real_seq": self.target_shift_real,
                    "shift_input_seq": self.target_shift,
                    "delta_order": self.delta_order,
                },
            }
            name, ext = output_path.rsplit(".", 1)
            out = f"{name}_{str(start).zfill(ZERO_PADDING)}.{ext}"
            with open(out, "w", encoding="utf-8") as f:
                f.write(json.dumps(segment, ensure_ascii=False) + "\n")

    def process_motion(
        self, turn_section: np.ndarray, motion_ignore: np.ndarray
    ) -> Generator[Tuple[Tuple[int, int, int, int], Tuple[int, int, int, int]], None, None]:
        """Window generator (reference :391-442), indices in video frames.

        TRANSCRIBED, SEMANTICS-BEARING: the offset/stride/margin
        arithmetic is carried over statement-for-statement from the
        reference's generator because it DEFINES which windows exist in
        the dataset — reference-built manifests and ours must agree
        exactly. Property tests in tests/test_databuild.py pin the
        window invariants.
        """
        turns = (turn_section * self.fps).astype(np.int64)
        delta_mergin = self.delta_order * self.pred_shift
        audio_offset = (self.nfft - self.shift) + (self.shift * self.delta_order)
        motion_offset = math.ceil(audio_offset * self.fps / self.sample_rate)

        for turn in turns:
            start = max(
                int(turn[0]), self.leading_len + delta_mergin + motion_offset
            )
            end = min(int(turn[1]), len(motion_ignore))
            if end - start < self.min_len:
                continue

            for i in range(start, end, self.shift_len):
                _start = i
                _end = min(end, i + self.max_len)
                _s_lead = _start - self.leading_len
                _e_lead = _start
                if _end - _start < self.min_len:
                    continue
                _end -= (_end - _start) % self.pred_shift

                a_start = int(_start * self.sample_rate / self.fps) - audio_offset
                a_end = int(_end * self.sample_rate / self.fps)
                a_s_lead = int(_s_lead * self.sample_rate / self.fps) - audio_offset
                a_e_lead = int(_e_lead * self.sample_rate / self.fps)

                _start -= delta_mergin
                _s_lead -= delta_mergin

                if motion_ignore[_start : _end + self.target_shift_real].sum() > 0:
                    continue
                if motion_ignore[_s_lead:_e_lead].sum() > 0:
                    continue

                yield (
                    (_start, _end, _s_lead, _e_lead),
                    (a_start, a_end, a_s_lead, a_e_lead),
                )
