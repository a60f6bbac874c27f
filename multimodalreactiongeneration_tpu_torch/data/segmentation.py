"""Energy VAD + two-party utterance/turn segmentation (host pipeline).

A copy of ``multimodalreactiongeneration_tpu/data/segmentation.py`` for
the corpus build: the framewise energy is the numpy sliding window (not
the JAX package's ctypes library), and the debug plot and its command
line are left out. Semantics-exact port of the reference's speech
segmentation (reference mr_gen/databuild/utterance_analysis/
speech_segmentation.py):

  * framewise log power, window 400 / hop 160, threshold -4 (:30-48)
  * two-party recursive utterance sectioning: pauses shorter than
    ``pause_with_voice`` with interlocutor speech inside may end a turn,
    pauses >= ``pause_without_voice`` always end it (:51-206)
  * turn sections = utterance sections +- ``mergin`` seconds (:291-313)

``detect_utterance_section`` and ``collect_utterance_section`` are
transcribed from the reference: the recursive two-party merge/split
rules are semantics-bearing, and any deviation in the index bookkeeping
changes which windows exist in the dataset.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from multimodalreactiongeneration_tpu_torch.utils.wavio import read_wav


def compute_log_power(
    wave: np.ndarray, n_fft: int = 400, n_shift: int = 160
) -> np.ndarray:
    """Framewise log energy, float32 (reference :30-38, loop-free); the
    JAX package's native frame energy computes the identical sum of
    squared samples per frame (tests/test_native_io.py)."""
    num_frames = (len(wave) - n_fft) // n_shift + 1
    if num_frames <= 0:
        return np.zeros((0,), np.float32)
    sq = (wave.astype(np.float32) ** 2)
    frames = np.lib.stride_tricks.sliding_window_view(sq, n_fft)[::n_shift]
    with np.errstate(divide="ignore"):  # silent frames -> -inf, unvoiced
        return np.log(frames.sum(axis=-1, dtype=np.float32))


def collect_voiced_section(log_power: np.ndarray, threshold: float) -> np.ndarray:
    """Run-length [start, stop) frame sections where power > threshold
    (reference :41-48)."""
    voiced = (log_power > threshold).astype(np.int32)
    edges = np.concatenate([[0], voiced, [0]])
    edges = edges[1:] - edges[:-1]
    return np.nonzero(edges)[0].reshape(-1, 2)


def detect_utterance_section(
    voiced_first: np.ndarray,
    voiced_second: np.ndarray,
    first_index: int,
    second_index: int,
    fft_rate: float,
    pause_with_voice: float,
    pause_without_voice: float,
    min_length: float,
) -> Tuple[int, int, int, int]:
    """Merge one speaker's voiced runs into an utterance (reference :51-117).

    TRANSCRIBED, SEMANTICS-BEARING: this recursive two-party state
    machine is a deliberate near-line transcription of the reference's
    speech_segmentation.py:51-117 (torch->numpy, renames) because its
    index arithmetic DEFINES the dataset's turn boundaries — any
    "improvement" here silently changes every derived segment. Property
    tests in tests/test_databuild.py pin its invariants.

    Walks the "first" speaker's voiced sections, merging across pauses,
    recursing into the interlocutor's stream to test whether a mid-length
    pause contains a real (>= min_length) utterance by the other party.
    Returns (start, end, new_first_index, new_second_index) in frames.
    """
    first_progress = 0
    second_progress = 0
    first_length = len(voiced_first)
    second_length = len(voiced_second)

    first = lambda idx: voiced_first[first_index + idx]
    second = lambda idx: voiced_second[second_index + idx]

    # reference quirk kept bug-for-bug (:70-71): the SECOND-unit params
    # are shadowed with FRAME-unit ints and the recursion below receives
    # the frame values, so recursive levels re-scale by fft_rate again
    # (1 s -> 100 frames -> 10,000 frames at depth 1). The interlocutor
    # probe therefore merges far more aggressively than the top level.
    # Intentional: these thresholds DEFINE the dataset's turn boundaries;
    # reference-built manifests and ours must interchange.
    pause_v = int(fft_rate * pause_with_voice)
    pause_nv = int(fft_rate * pause_without_voice)

    while (
        first_progress + first_index < first_length
        and second_progress + second_index < second_length
    ):
        if first_progress + first_index + 1 >= first_length:
            break
        pause_length = first(first_progress + 1)[0] - first(first_progress)[1]
        # advance the interlocutor pointer past our current section end
        # (single-step with early break, as the reference does, :81-84)
        while second(second_progress)[0] < first(first_progress)[1]:
            if second_progress + second_index + 1 < second_length:
                second_progress += 1
            break
        in_pause = second(second_progress)[0] < first(first_progress + 1)[0]
        if in_pause and (pause_v <= pause_length < pause_nv):
            _start, _end, _fi, _si = detect_utterance_section(
                voiced_second,
                voiced_first,
                second_index + second_progress,
                first_index + first_progress + 1,
                fft_rate,
                pause_v,
                pause_nv,
                min_length,
            )
            if _end - _start < int(fft_rate * min_length):
                in_pause = False
        else:
            in_pause = False

        if pause_length >= pause_v and in_pause:
            break
        elif pause_length >= pause_nv:
            break
        else:
            first_progress += 1

    new_first_index = first_index + first_progress + 1
    new_second_index = second_index + second_progress
    start = int(first(0)[0])
    end = int(first(first_progress)[1])
    return start, end, new_first_index, new_second_index


def collect_utterance_section(
    voiced_comp: np.ndarray,
    voiced_host: np.ndarray,
    fft_rate: float,
    min_length: float,
    pause_with_voice: float,
    pause_without_voice: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """Alternating two-party utterance collection (reference :120-206)."""
    utter_comp: List[List[int]] = []
    utter_host: List[List[int]] = []
    comp_index, host_index = 0, 0
    comp_length, host_length = len(voiced_comp), len(voiced_host)

    while comp_index < comp_length and host_index < host_length:
        comp_first = voiced_comp[comp_index][0] < voiced_host[host_index][0]
        if comp_first:
            first_arr, second_arr = voiced_comp, voiced_host
            first_idx, second_idx = comp_index, host_index
        else:
            first_arr, second_arr = voiced_host, voiced_comp
            first_idx, second_idx = host_index, comp_index

        start, end, first_idx, second_idx = detect_utterance_section(
            first_arr,
            second_arr,
            first_idx,
            second_idx,
            fft_rate,
            pause_with_voice,
            pause_without_voice,
            min_length,
        )

        if end - start >= int(fft_rate * min_length):
            if comp_first:
                utter_comp.append([start, end])
                comp_index, host_index = first_idx, second_idx
            else:
                utter_host.append([start, end])
                host_index, comp_index = first_idx, second_idx
        else:
            # too short: merge mode — only the leading speaker advances
            if comp_first:
                comp_index = first_idx
            else:
                host_index = first_idx

    return (
        np.array(utter_comp, np.float64).reshape(-1, 2),
        np.array(utter_host, np.float64).reshape(-1, 2),
    )


def utterance_to_turn_section(
    utterance_sections: np.ndarray,
    mergin: float,
    samplerate: int,
    stride: int,
    length: float,
) -> np.ndarray:
    """Frame sections -> second-unit turn sections +- mergin (:291-313)."""
    secs = utterance_sections / samplerate * stride
    if len(secs) == 0:
        return np.zeros((0, 2))
    starts = np.maximum(secs[:, 0] - mergin, 0.0)
    ends = np.minimum(secs[:, 1] + mergin, length)
    return np.stack([starts, ends], axis=1)


def get_utterance_section(
    host_path: str,
    comp_path: str,
    sampling_rate: int,
    window_size: int = 400,
    stride: int = 160,
    threshold: float = -4,
    minimum_utterance_length: float = 1.0,
    pause_with_voice: float = 1.0,
    pause_without_voice: float = 2.0,
    mergin: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Turn sections (seconds) for (comp, host) — reference :316-425."""
    wave_comp, sr_comp = read_wav(comp_path)
    wave_host, sr_host = read_wav(host_path)
    assert sr_comp == sr_host == sampling_rate
    assert wave_comp.shape[-1] == wave_host.shape[-1]
    wave_comp, wave_host = wave_comp[0], wave_host[0]

    lp_comp = compute_log_power(wave_comp, window_size, stride)
    lp_host = compute_log_power(wave_host, window_size, stride)
    voiced_comp = collect_voiced_section(lp_comp, threshold)
    voiced_host = collect_voiced_section(lp_host, threshold)

    utter_comp, utter_host = collect_utterance_section(
        voiced_comp,
        voiced_host,
        sampling_rate / stride,
        minimum_utterance_length,
        pause_with_voice,
        pause_without_voice,
    )

    audio_length = len(wave_comp) / sampling_rate
    turn_comp = utterance_to_turn_section(
        utter_comp, mergin, sampling_rate, stride, audio_length
    )
    turn_host = utterance_to_turn_section(
        utter_host, mergin, sampling_rate, stride, audio_length
    )
    return turn_comp, turn_host
