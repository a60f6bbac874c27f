"""Data loading: manifest-driven datasets + bucketed batching.

Counterpart of the streaming path of ``multimodalreactiongeneration_tpu/
data/dataset.py``. Behavior-matched to the reference NX dataset/
datamodule (reference mr_gen/model/lstmformer/dataloader.py):
  * __getitem__ returns the 7-tuple (fbank_p, motion_p, motion_s,
    lead_fbank_p, lead_motion_p, lead_motion_s, target); target is
    motion_self shifted by target.shift_input_seq frames (:87-89)
  * padding value -100 (the "never in data" sentinel, :16-17)
  * 80/10/10 random split (:155-171)
Sequences pad to a BUCKET length (pad_to_multiple) as in the JAX package,
so batch shapes repeat. Batches are [(data, lengths), ...] with host
numpy lengths; motion data are numpy, the batched fbank entries of
``pad_collate_device`` tensors on the device. The fixed windows of
simple_lstm (``WindowDataset``, ``stack_collate``, ``WindowBatchLoader``)
are host numpy batches of stacked arrays (fbank, motion context,
target). ``HostRowShard`` (data-parallel training) is not ported.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

import torch

from multimodalreactiongeneration_tpu_torch import resolve_device
from multimodalreactiongeneration_tpu_torch.data.features import (
    AudioFeatureExtractor,
    MotionFeatureExtractor,
    MotionFeatureExtractorNX,
)
from multimodalreactiongeneration_tpu_torch.ops import dsp
from multimodalreactiongeneration_tpu_torch.utils.wavio import read_wav

PADDING_VALUE = -100.0

Sample = Tuple[np.ndarray, ...]
Batch = List[Tuple[np.ndarray, np.ndarray]]  # [(data (B,T,D), lengths (B,))]


class SegmentDatasetNX:
    """Reads one-line-JSON segment manifests (reference dataloader.py:20-111)."""

    def __init__(self, dataset_path: str, motion_cfg, audio_cfg):
        self.dataset_path = dataset_path
        self.data_list = sorted(
            os.path.join(dataset_path, p)
            for p in os.listdir(dataset_path)
            if p.endswith(".json") and p != "datainfo.json"
        )
        self.audio = AudioFeatureExtractor(audio_cfg)
        self.motion = MotionFeatureExtractorNX(motion_cfg)

    def __len__(self) -> int:
        return len(self.data_list)

    def segment_lengths(self) -> np.ndarray:
        """Motion frame count per segment, from manifests alone (no
        feature extraction) — the sort key for length bucketing."""
        if not hasattr(self, "_seg_lengths"):
            lengths = np.empty(len(self.data_list), np.int64)
            for i, p in enumerate(self.data_list):
                with open(p, "r", encoding="utf-8") as f:
                    seq = json.loads(f.readline())["self_motion"]["seq"]
                stride = seq.get("stride", 1)
                lengths[i] = -(-(seq["end"] - seq["start"]) // stride)
            self._seg_lengths = lengths
        return self._seg_lengths

    def audio_paths(self) -> List[str]:
        """Unique partner-audio wav paths across all manifests (the only
        audio the NX sample tuple reads) — the DeviceAudioCache build
        list."""
        paths = set()
        for p in self.data_list:
            with open(p, "r", encoding="utf-8") as f:
                paths.add(json.loads(f.readline())["partner_audio"]["path"])
        return sorted(paths)

    def raw_item(self, index: int, audio: str = "array"):
        """Host-only variant: motion features extracted on host, audio
        returned as RAW sample slices so the loader can run ONE batched
        device fbank call per batch (databuild-on-device; avoids a device
        round trip per segment).

        ``audio="spec"`` defers the wav read entirely: audio entries are
        ``(path, start, n_samples)`` tuples, letting the collate gather a
        whole batch of slices from the device-resident bank
        (data/audio_cache.py) or read them as raw PCM16.
        """
        with open(self.data_list[index], "r", encoding="utf-8") as f:
            jdic = json.loads(f.readline())
        pm, pa = jdic["partner_motion"], jdic["partner_audio"]
        sm, tgt = jdic["self_motion"], jdic["target"]
        off_p, off_s = pm["offset"], sm["offset"]

        def slice_wav(seg):
            if audio == "spec":
                return (pa["path"], seg["start"], seg["end"] - seg["start"])
            wave, _ = read_wav(
                pa["path"], seg["start"], seg["end"] - seg["start"]
            )
            return wave[0]

        motion_p = self.motion(
            pm["path"], pm["seq"]["start"] - off_p,
            pm["seq"]["end"] - off_p, pm["seq"]["stride"],
        )
        motion_s = self.motion(
            sm["path"], sm["seq"]["start"] - off_s,
            sm["seq"]["end"] - off_s, sm["seq"]["stride"],
        )
        lead_motion_p = self.motion(
            pm["path"], pm["lead"]["start"] - off_p,
            pm["lead"]["end"] - off_p, pm["lead"]["stride"],
        )
        lead_motion_s = self.motion(
            sm["path"], sm["lead"]["start"] - off_s,
            sm["lead"]["end"] - off_s, sm["lead"]["stride"],
        )
        shift = tgt["shift_input_seq"]
        target = motion_s[shift:]
        motion_s = motion_s[: len(motion_s) - shift]
        return {
            "audio_seq": slice_wav(pa["seq"]),
            "audio_lead": slice_wav(pa["lead"]),
            "motion_p": motion_p,
            "motion_s": motion_s,
            "lead_motion_p": lead_motion_p,
            "lead_motion_s": lead_motion_s,
            "target": target,
        }

    def __getitem__(self, index: int) -> Sample:
        with open(self.data_list[index], "r", encoding="utf-8") as f:
            jdic = json.loads(f.readline())

        pm, pa = jdic["partner_motion"], jdic["partner_audio"]
        sm, tgt = jdic["self_motion"], jdic["target"]
        off_p, off_s = pm["offset"], sm["offset"]

        fbank = self.audio(pa["path"], pa["seq"]["start"], pa["seq"]["end"])
        motion_p = self.motion(
            pm["path"],
            pm["seq"]["start"] - off_p,
            pm["seq"]["end"] - off_p,
            pm["seq"]["stride"],
        )
        motion_s = self.motion(
            sm["path"],
            sm["seq"]["start"] - off_s,
            sm["seq"]["end"] - off_s,
            sm["seq"]["stride"],
        )
        lead_fbank = self.audio(pa["path"], pa["lead"]["start"], pa["lead"]["end"])
        lead_motion_p = self.motion(
            pm["path"],
            pm["lead"]["start"] - off_p,
            pm["lead"]["end"] - off_p,
            pm["lead"]["stride"],
        )
        lead_motion_s = self.motion(
            sm["path"],
            sm["lead"]["start"] - off_s,
            sm["lead"]["end"] - off_s,
            sm["lead"]["stride"],
        )

        shift = tgt["shift_input_seq"]
        target = motion_s[shift:]
        motion_s = motion_s[: len(motion_s) - shift]

        return (
            fbank,
            motion_p,
            motion_s,
            lead_fbank,
            lead_motion_p,
            lead_motion_s,
            target,
        )


class WindowDataset:
    """v1 fixed-shape windows for SimpleLSTM (reference
    simple_lstm/dataloader.py:16-61): (fbank, motion_context,
    motion_target) from the manifests of ``data/databuild.py``."""

    def __init__(self, dataset_path: str, data_cfg, audio_cfg):
        self.dataset_path = dataset_path
        self.data_list = sorted(
            os.path.join(dataset_path, p)
            for p in os.listdir(dataset_path)
            if p.endswith(".json") and p != "datainfo.json"
        )
        self.audio = AudioFeatureExtractor(audio_cfg)
        self.motion = MotionFeatureExtractor(data_cfg)

    def __len__(self) -> int:
        return len(self.data_list)

    def __getitem__(self, index: int):
        with open(self.data_list[index], "r", encoding="utf-8") as f:
            jdic = json.loads(f.readline())
        fbank = self.audio(
            jdic["wav_file"], jdic["audio"]["start"], jdic["audio"]["end"]
        )
        context = self.motion(jdic["head_dir"], **jdic["context"])
        target = self.motion(jdic["head_dir"], **jdic["target"])
        return fbank, context, target


def stack_collate(samples: Sequence[Sample]) -> Tuple[np.ndarray, ...]:
    """Fixed-shape stack (reference simple_lstm/dataloader.py:56-61)."""
    return tuple(
        np.stack([s[m] for s in samples], axis=0)
        for m in range(len(samples[0]))
    )


class WindowBatchLoader:
    """Epoch iterator for fixed-shape v1 windows: stacked host arrays,
    reshuffled each epoch from ``seed + epoch``. Like the JAX package's it
    has no ``len``, so a ``Trainer`` validates at the end of each epoch."""

    def __init__(self, dataset, indices, batch_size, shuffle=True, seed=0,
                 drop_last=False):
        self.dataset = dataset
        self.indices = np.asarray(indices)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0

    def __iter__(self):
        order = self.indices.copy()
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
            self._epoch += 1
        for i in range(0, len(order), self.batch_size):
            chunk = order[i:i + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                break
            yield stack_collate([self.dataset[int(j)] for j in chunk])


def random_split_indices(
    n: int, train_rate: float, valid_rate: float, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """80/10/10-style split (reference dataloader.py:159-171)."""
    train_size = int(train_rate * n)
    valid_size = int(valid_rate * n)
    test_size = n - train_size - valid_size
    if test_size <= 0:
        raise ValueError(f"test size is negative or zero: {test_size}")
    perm = np.random.default_rng(seed).permutation(n)
    return (
        perm[:train_size],
        perm[train_size : train_size + valid_size],
        perm[train_size + valid_size :],
    )


def _round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def pad_collate(
    samples: Sequence[Sample],
    pad_to_multiple: int = 16,
    ratio: int = 8,
    pad_value: float = PADDING_VALUE,
) -> Batch:
    """Pad each modality to a bucketed length (motion-frame aligned).

    Motion modalities (indices 1, 2, 6) pad to the same bucketed motion
    length Tm; the audio modality (0) pads to Tm * ratio so the model's
    rate invariant (sampled audio == motion frames) survives padding.
    Leads are constant-length by construction (fixed leading_len); they
    pad to the batch-max lead motion length, audio tied at ratio x, with
    NO bucket rounding — rounding leads independently would break the tie.
    Returns [(data, lengths), ...] like the reference collate (:114-121).
    """
    n_modal = len(samples[0])
    motion_like = {1, 2, 6}
    audio_like = {0}
    lead_audio_like = {3}
    lead_motion_like = {4, 5}

    tm = max(s[2].shape[0] for s in samples)
    tm = _round_up(tm, pad_to_multiple)
    lead_tm = max(s[4].shape[0] for s in samples)

    out: Batch = []
    for m in range(n_modal):
        arrs = [s[m] for s in samples]
        lengths = np.array([a.shape[0] for a in arrs], np.int64)
        if m in motion_like:
            max_len = tm
        elif m in audio_like:
            max_len = tm * ratio
        elif m in lead_motion_like:
            max_len = lead_tm
        elif m in lead_audio_like:
            max_len = lead_tm * ratio
        else:
            max_len = _round_up(max(lengths), pad_to_multiple)
        dim = arrs[0].shape[-1]
        batch = np.full((len(arrs), max_len, dim), pad_value, np.float32)
        for b, a in enumerate(arrs):
            batch[b, : a.shape[0]] = a
        out.append((batch, lengths))
    return out


def pad_collate_device(
    raws,
    audio_cfg,
    pad_to_multiple: int = 16,
    ratio: int = 8,
    pad_value: float = PADDING_VALUE,
    audio_cache=None,
    device=None,
) -> Batch:
    """Batched-on-device feature collation.

    Motion features pad on the host (numpy); raw audio slices zero-pad to
    the bucket sample count and go through ONE batched fbank call per
    segment group (seq + lead) on ``device`` (the audio cache's device
    when one is given). Frames beyond each sample's true frame count take
    the -100 sentinel, so the result equals per-sample extraction +
    feature padding. The fbank entries are tensors on the device.
    """
    params = dsp.FbankParams(
        sample_rate=audio_cfg["sample_rate"],
        n_fft=audio_cfg["nfft"],
        hop=audio_cfg["shift"],
        n_mels=audio_cfg["nmels"],
        delta_order=audio_cfg["delta_order"],
    )
    if audio_cache is not None:
        device = audio_cache.device
    device = resolve_device(device)

    tm = max(r["motion_s"].shape[0] for r in raws)
    tm = _round_up(tm, pad_to_multiple)
    lead_tm = max(r["lead_motion_p"].shape[0] for r in raws)

    def pad_motion(key, max_len):
        arrs = [r[key] for r in raws]
        lengths = np.array([a.shape[0] for a in arrs], np.int64)
        out = np.full((len(arrs), max_len, arrs[0].shape[-1]), pad_value,
                      np.float32)
        for b, a in enumerate(arrs):
            out[b, : a.shape[0]] = a
        return out, lengths

    def batched_fbank(key, frame_budget):
        arrs = [r[key] for r in raws]
        # sample count that yields exactly frame_budget + delta frames
        samples_needed = (
            (frame_budget + params.delta_order - 1) * params.hop
            + params.n_fft
        )
        if arrs and isinstance(arrs[0], tuple):
            # (path, start, n_samples) specs: gathered from the device
            # bank, else read as raw PCM16 (zero past EOF) and uploaded;
            # samples past each slice's true length are zero either way,
            # as on the array path (slice, then zero-pad)
            true_lens = [min(a[2], samples_needed) for a in arrs]
            frame_counts = [params.num_output_frames(a[2]) for a in arrs]
            wave = None
            if audio_cache is not None:
                wave = audio_cache.gather(
                    [a[0] for a in arrs], [a[1] for a in arrs],
                    true_lens, samples_needed,
                )
            if wave is None:
                host = np.zeros((len(arrs), samples_needed), np.int16)
                for b, (a, n) in enumerate(zip(arrs, true_lens)):
                    data, _ = read_wav(a[0], a[1], n, dtype=np.int16)
                    host[b, : data.shape[1]] = data[0]
                wave = torch.from_numpy(host).to(device)
        else:
            host = np.zeros((len(arrs), samples_needed), np.float32)
            frame_counts = []
            for b, a in enumerate(arrs):
                n = min(len(a), samples_needed)
                host[b, :n] = a[:n]
                frame_counts.append(params.num_output_frames(len(a)))
            wave = torch.from_numpy(host).to(device)
        feats = dsp.batched_logmel_masked(
            wave, torch.tensor(frame_counts, device=device), params,
            float(pad_value),
        )
        return feats, np.array(frame_counts, np.int64)

    fbank = batched_fbank("audio_seq", tm * ratio)
    motion_p = pad_motion("motion_p", tm)
    motion_s = pad_motion("motion_s", tm)
    lead_fbank = batched_fbank("audio_lead", lead_tm * ratio)
    lead_motion_p = pad_motion("lead_motion_p", lead_tm)
    lead_motion_s = pad_motion("lead_motion_s", lead_tm)
    target = pad_motion("target", tm)
    return [
        fbank, motion_p, motion_s,
        lead_fbank, lead_motion_p, lead_motion_s, target,
    ]


class BatchLoader:
    """Epoch iterator: shuffle, length-bucket, batch, collate.

    Length bucketing (bucket_windows > 1): after the epoch shuffle, each
    window of ``batch_size * bucket_windows`` consecutive samples is
    sorted by manifest motion length before chunking, and the resulting
    batch order is re-shuffled. Batches then hold similar lengths, so
    padding waste drops materially (random batches nearly always pad to
    the longest sample in the shard) while batch composition still
    varies per epoch; the distinct batch shapes stay bounded by the
    pad_to_multiple rounding either way. ``audio_cfg`` given ->
    batched-on-device feature extraction on ``device`` (``cuda:0``
    unless named), one fbank call per segment group and batch.
    """

    def __init__(
        self,
        dataset: SegmentDatasetNX,
        indices: np.ndarray,
        batch_size: int,
        pad_to_multiple: int = 16,
        ratio: int = 8,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
        audio_cfg=None,
        bucket_windows: int = 8,
        audio_cache=None,
        device=None,
    ):
        self.dataset = dataset
        self.indices = np.asarray(indices)
        self.batch_size = batch_size
        self.pad_to_multiple = pad_to_multiple
        self.ratio = ratio
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.audio_cfg = audio_cfg
        self.bucket_windows = bucket_windows
        self.audio_cache = audio_cache
        self.device = resolve_device(
            audio_cache.device if audio_cache is not None else device)
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.indices)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _epoch_batches(self) -> List[np.ndarray]:
        order = self.indices.copy()
        rng = None
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
            self._epoch += 1
        # bucketing only under shuffle: unshuffled iteration (eval) must
        # keep the given order so consumers can pair batch rows back to
        # dataset indices (infer/cli.py manifest lookup)
        if (
            self.shuffle
            and self.bucket_windows > 1
            and hasattr(self.dataset, "segment_lengths")
        ):
            lengths = self.dataset.segment_lengths()
            window = self.batch_size * self.bucket_windows
            for i in range(0, len(order), window):
                sl = order[i : i + window]
                order[i : i + len(sl)] = sl[np.argsort(lengths[sl],
                                                       kind="stable")]
        batches = [
            order[i : i + self.batch_size]
            for i in range(0, len(order), self.batch_size)
        ]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        if rng is not None:
            rng.shuffle(batches)
        return batches

    def _collate(self, chunk: np.ndarray) -> Batch:
        if self.audio_cfg is not None:
            raws = [
                self.dataset.raw_item(int(j), audio="spec") for j in chunk
            ]
            return pad_collate_device(
                raws, self.audio_cfg, self.pad_to_multiple, self.ratio,
                audio_cache=self.audio_cache, device=self.device,
            )
        samples = [self.dataset[int(j)] for j in chunk]
        return pad_collate(samples, self.pad_to_multiple, self.ratio)

    def __iter__(self) -> Iterator[Batch]:
        for chunk in self._epoch_batches():
            yield self._collate(chunk)


class PrefetchLoader:
    """Background-thread prefetch over any batch loader.

    The reference overlaps host data work with the device step through
    DataLoader worker processes (lstmformer/dataloader.py:180-189); here
    a daemon thread keeps up to ``depth`` collated batches queued ahead
    of the training loop, so feature extraction and padding run while
    the device executes the previous step. The wrapped loader is
    consumed in its natural order — results are identical to iterating
    it directly.
    """

    def __init__(self, loader, depth: int = 2):
        if depth < 1:
            raise ValueError("prefetch depth must be >= 1")
        self.loader = loader
        self.depth = depth

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self) -> Iterator[Batch]:
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        END = object()
        cancelled = threading.Event()

        def put_polling(item) -> bool:
            # poll the flag instead of blocking forever on a full queue:
            # an abandoned consumer (exception in the train loop,
            # KeyboardInterrupt) would otherwise leak this thread plus
            # `depth` collated batches per fit() retry
            while not cancelled.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for batch in self.loader:
                    if not put_polling(batch):
                        return
                put_polling(END)
            except BaseException as exc:  # surfaced on the consumer side
                put_polling(exc)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is END:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
            thread.join()
        finally:
            cancelled.set()
