"""Session audio/video time alignment.

A copy of ``multimodalreactiongeneration_tpu/corpus/alignment.py`` on the
port's ``ops/xcorr.py``. Behavior-matched to the reference's
mr_gen/utils/data_analysis/data_alignment.py:230-287 (alignment):
estimate the sample shift between each mono channel and the session mix
by cross-correlation (the FFT lag search on the device ``resolve_device``
gives: the card unless the caller names one), then trim every stream to
the common span.

Reference ingestion parity:
  * the session mix may arrive as an .m4a recording — decoded through an
    ffmpeg subprocess and decimated [::2] (the reference's 32k -> 16k
    every-other-sample rule, data_alignment.py:44-53, NOT a resample)
  * a session movie is trimmed to the aligned span
    (data_alignment.py:269-287 via infer/video.py trim_video)

Skip-if-populated resume matches the reference's --overwrite gate
(:325-329). For hosts without ffmpeg, ``main`` takes the ``.m4a``
decoder and the movie trimmer as keyword arguments (an argv -> s16le
bytes callable, a ``subprocess.run``-like runner), as the functions do.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from multimodalreactiongeneration_tpu_torch import resolve_device
from multimodalreactiongeneration_tpu_torch.ops.xcorr import align_shift
from multimodalreactiongeneration_tpu_torch.utils.wavio import read_wav, write_wav


def _ffmpeg_pcm(cmd) -> bytes:
    return subprocess.run(cmd, stdout=subprocess.PIPE, check=True).stdout


def load_m4a(
    path: str,
    decoder: Callable[[list], bytes] = _ffmpeg_pcm,
) -> Tuple[np.ndarray, int]:
    """Decode an .m4a mix to mono float32 + 2:1 decimation.

    Matches reference load_m4a (data_alignment.py:44-53): decode at the
    container's native rate, scale int16 -> [-1, 1), then keep every
    other sample (their fixed 32k -> 16k decimation). Returns
    (wave, decimated_rate). ``decoder`` maps an ffmpeg argv to raw
    s16le bytes and is injectable for tests / other decoders.
    """
    import shutil

    if decoder is _ffmpeg_pcm and (
        shutil.which("ffmpeg") is None or shutil.which("ffprobe") is None
    ):
        raise RuntimeError(
            "ffmpeg/ffprobe not found on PATH; cannot decode m4a session "
            "mixes"
        )
    probe = decoder(
        ["ffprobe", "-v", "error", "-select_streams", "a:0",
         "-show_entries", "stream=sample_rate",
         "-of", "default=nw=1:nk=1", path]
    )
    native_sr = int(probe.strip())
    raw = decoder(
        ["ffmpeg", "-loglevel", "error", "-i", path,
         "-f", "s16le", "-acodec", "pcm_s16le", "-ac", "1", "pipe:1"]
    )
    wav = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    return wav[::2], native_sr // 2


def load_session_mix(
    session_dir: str,
    mix_name: str = "pair.wav",
    decoder: Callable[[list], bytes] = _ffmpeg_pcm,
) -> Tuple[np.ndarray, int]:
    """The session mix: pair.wav if present, else the session .m4a."""
    wav_path = os.path.join(session_dir, mix_name)
    if os.path.exists(wav_path):
        mix, sr = read_wav(wav_path)
        return mix.mean(axis=0), sr
    m4as = sorted(
        f for f in os.listdir(session_dir) if f.endswith(".m4a")
    )
    if not m4as:
        raise FileNotFoundError(
            f"{session_dir}: no {mix_name} and no .m4a session mix"
        )
    return load_m4a(os.path.join(session_dir, m4as[0]), decoder=decoder)


def align_session(
    session_dir: str,
    output_dir: str,
    mix_name: str = "pair.wav",
    overwrite: bool = False,
    decoder: Callable[[list], bytes] = _ffmpeg_pcm,
    video_runner=None,
    device=None,
) -> Optional[Dict[str, int]]:
    """Align comp/host mono wavs against the session mix and trim.

    Returns {"comp": shift, "host": shift} in samples (positive: channel
    starts later than the mix), or None if skipped. A session movie
    (*.mp4) is trimmed to the aligned span alongside the wavs.
    """
    device = resolve_device(device)
    if os.path.isdir(output_dir) and os.listdir(output_dir) and not overwrite:
        return None
    os.makedirs(output_dir, exist_ok=True)

    mix, sr = load_session_mix(session_dir, mix_name, decoder=decoder)
    shifts: Dict[str, int] = {}
    waves = {}
    for who in ("comp", "host"):
        wav, sr_w = read_wav(os.path.join(session_dir, f"{who}.wav"))
        assert sr_w == sr, "sample rates must match for alignment"
        waves[who] = wav[0]
        shifts[who] = align_shift(mix, wav[0], sr, device=device)

    # trim all streams to the common span. A channel delayed by ``shift``
    # has its content for mix time m at channel[m + shift]; the earliest
    # mix time representable in every stream is max(0, -min(shifts)).
    start_mix = max(0, *(-s for s in shifts.values()))
    spans = [len(mix) - start_mix]
    for who in ("comp", "host"):
        start_ch = start_mix + shifts[who]
        if start_ch < 0:
            raise ValueError(f"{who}: negative aligned start {start_ch}")
        spans.append(len(waves[who]) - start_ch)
    common = min(spans)

    for who in ("comp", "host"):
        start_ch = start_mix + shifts[who]
        write_wav(
            os.path.join(output_dir, f"{who}.wav"),
            waves[who][None, start_ch : start_ch + common],
            sr,
        )
    write_wav(
        os.path.join(output_dir, mix_name),
        mix[None, start_mix : start_mix + common],
        sr,
    )
    # trim the session movie over the aligned span
    # (reference data_alignment.py:269-287)
    movies = sorted(
        f for f in os.listdir(session_dir) if f.endswith(".mp4")
    )
    if movies:
        from multimodalreactiongeneration_tpu_torch.infer.video import trim_video

        kwargs = {} if video_runner is None else {"runner": video_runner}
        trim_video(
            os.path.join(session_dir, movies[0]),
            os.path.join(output_dir, movies[0]),
            start_s=start_mix / sr,
            stop_s=(start_mix + common) / sr,
            **kwargs,
        )
    with open(os.path.join(output_dir, "alignment.json"), "w") as f:
        json.dump({"shifts": shifts, "start_mix": start_mix, "span": common}, f)
    return shifts


def main(argv=None, *, decoder: Callable[[list], bytes] = _ffmpeg_pcm,
         video_runner=None):
    """python -m multimodalreactiongeneration_tpu_torch.corpus.alignment
    --target <raw_root> --output <aligned_root> [--overwrite]
    [--device cpu]"""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--target", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--overwrite", action="store_true")
    parser.add_argument("--device", default=None,
                        help="where the lag search runs (default cuda:0)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    total = 0.0
    for session in sorted(os.listdir(args.target)):
        sdir = os.path.join(args.target, session)
        if not os.path.isdir(sdir):
            continue
        out = os.path.join(args.output, session)
        shifts = align_session(sdir, out, overwrite=args.overwrite,
                               decoder=decoder, video_runner=video_runner,
                               device=device)
        if shifts is not None:
            wav, sr = read_wav(os.path.join(out, "comp.wav"))
            total += wav.shape[1] / sr / 3600
            print(f"{session}: shifts={shifts}")
    print(f"aligned corpus hours: {total:.2f}")


if __name__ == "__main__":
    main()
