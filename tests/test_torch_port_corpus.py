"""PyTorch port: the offline corpus pipeline's array functions and IO vs
the JAX package, on the CPU.

Seeded numpy inputs go through the JAX function and its port
counterpart (``device="cpu"``):
  * ``ops/rotations.py`` ``calc_R`` (<= 1e-6), ``landmarks_to_pose``
    (angles <= 1e-3 degrees, centroids <= 1e-5) on synthetic faces
    within +-40 degrees;
  * ``ops/xcorr.py``: the envelopes bit for bit, the lags equal to JAX's
    on JAX's own cases (tests/test_corpus_ops.py) and on seeded dialogue
    sessions with planted shifts (signals with one clear correlation
    peak: a near tie may take either peak under another FFT);
  * ``ops/dsp_reference.py`` FBANK / MFCC / SPEC with no dither <= 1e-4
    (SPEC as the magnitude its dB encode, relative to the largest: the
    dB of a near-zero bin is the log of FFT rounding);
  * ``utils/native_io.py``: ``read_slice``, ``read_batch`` (f32 and raw
    int16, zero past EOF) and ``frame_energy_native`` bit for bit, the
    library built into the port's ``_build/`` and nothing written under
    ``native/``, a failed build raising;
  * ``data/segmentation.py``: the log power, the turn sections, the
    debug plots and the VAD command line;
  * the loader's native PCM16 batch read against JAX's batches;
  * ``utils/profiling.py``.
"""

import ctypes
import json
import os

import numpy as np
import pytest
import torch

from multimodalreactiongeneration_tpu.data import dataset as jds
from multimodalreactiongeneration_tpu.data import segmentation as jseg
from multimodalreactiongeneration_tpu.data.databuild_nx import (
    DataBuilderNX as JaxBuilder,
)
from multimodalreactiongeneration_tpu.ops import dsp_reference as jdsp
from multimodalreactiongeneration_tpu.ops import rotations as jrot
from multimodalreactiongeneration_tpu.ops import xcorr as jx
from multimodalreactiongeneration_tpu.utils import native_io as jnio
from multimodalreactiongeneration_tpu.utils import profiling as jprof
from multimodalreactiongeneration_tpu_torch import _build
from multimodalreactiongeneration_tpu_torch.data import dataset as pds
from multimodalreactiongeneration_tpu_torch.data import segmentation as pseg
from multimodalreactiongeneration_tpu_torch.data.databuild_nx import (
    DataBuilderNX,
)
from multimodalreactiongeneration_tpu_torch.ops import dsp_reference as pdsp
from multimodalreactiongeneration_tpu_torch.ops import rotations as prot
from multimodalreactiongeneration_tpu_torch.ops import xcorr as px
from multimodalreactiongeneration_tpu_torch.utils import native_io as pnio
from multimodalreactiongeneration_tpu_torch.utils import profiling as pprof
from multimodalreactiongeneration_tpu_torch.utils import wavio
from tests.fixtures import AUDIO_CFG, DATA_CFG, MOTION_CFG, make_synthetic_corpus
from tests.test_corpus_ops import SR, _noise_burst_wave
from tests.test_landmarks import synthetic_face

import chip_smoke

torch.set_num_threads(1)
CPU = "cpu"
ANGLE_TOL, CENTROID_TOL = 1e-3, 1e-5


def _faces(n, seed):
    """n synthetic faces (tests/test_landmarks.py) at random poses within
    +-40 degrees and random centers."""
    rng = np.random.default_rng(seed)
    angles = rng.uniform(-40.0, 40.0, (n, 3))
    centers = np.c_[rng.uniform(0.3, 0.7, (n, 2)), rng.uniform(-0.1, 0.1, n)]
    return np.stack([synthetic_face(a, c) for a, c in zip(angles, centers)])


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


# ---- rotations ------------------------------------------------------------

@pytest.mark.parametrize("as_tensor", [False, True])
def test_calc_R_and_centroid_match_jax(as_tensor):
    lms = _faces(64, 0)
    want = np.asarray(jrot.calc_R(lms, 640.0, 480.0))
    got = prot.calc_R(torch.from_numpy(lms) if as_tensor else lms,
                      640.0, 480.0)
    got = got.numpy() if as_tensor else got
    assert got.dtype == np.float32 and got.shape == (64, 3, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    cen = prot.centroid(torch.from_numpy(lms) if as_tensor else lms)
    np.testing.assert_allclose(np.asarray(cen), np.asarray(jrot.centroid(lms)),
                               rtol=0, atol=CENTROID_TOL)


@pytest.mark.parametrize("frames,w,h", [(300, 640, 480), (1, 1920, 1080)])
def test_landmarks_to_pose_matches_jax(frames, w, h):
    lms = _faces(frames, frames)
    ja, jc = jrot.landmarks_to_pose(lms, float(w), float(h))
    pa, pc = prot.landmarks_to_pose(lms, w, h, device=CPU)
    assert pa.dtype == pc.dtype == torch.float32
    assert pa.device.type == "cpu" and tuple(pa.shape) == (frames, 3)
    assert float(np.abs(pa.numpy() - np.asarray(ja)).max()) <= ANGLE_TOL
    assert float(np.abs(pc.numpy() - np.asarray(jc)).max()) <= CENTROID_TOL
    # chunks of 256 give the same as one call
    if frames > 256:
        parts = [prot.landmarks_to_pose(lms[i:i + 256], w, h, device=CPU)
                 for i in range(0, frames, 256)]
        np.testing.assert_allclose(torch.cat([p[0] for p in parts]), pa,
                                   rtol=0, atol=1e-5)


def test_pose_recovers_the_planted_rotation():
    angles = np.array([[12.0, -25.0, 7.0], [-30.0, 10.0, -5.0]])
    lms = np.stack([synthetic_face(a) for a in angles])
    pa, _ = prot.landmarks_to_pose(lms, 1.0, 1.0, device=CPU)
    ja, _ = jrot.landmarks_to_pose(lms, 1.0, 1.0)
    np.testing.assert_allclose(pa.numpy(), np.asarray(ja), atol=ANGLE_TOL)


def test_pose_entry_point_takes_the_card_unless_named(monkeypatch):
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prot.landmarks_to_pose(_faces(2, 1), 640, 480)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        px.best_lag(np.ones(8, np.float32), np.ones(4, np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pdsp.compute_fbank(np.ones(800, np.float32), pdsp.KaldiParams())


# ---- xcorr ------------------------------------------------------------------

def test_rms_envelope_bitwise():
    x = np.random.default_rng(0).standard_normal(16037).astype(np.float32)
    for grid in (1, 160, 16000, 20000):
        np.testing.assert_array_equal(px.rms_envelope(x, grid),
                                      jx.rms_envelope(x, grid))


def _shifted(base, shift):
    if shift >= 0:
        return np.concatenate([np.zeros(shift, np.float32), base])
    return base[-shift:]


@pytest.mark.parametrize("shift", [0, 1234, -777, 16000])
def test_align_shift_matches_jax_on_its_known_lags(shift):
    base = _noise_burst_wave(np.random.default_rng(0))
    shifted = _shifted(base, shift)
    got = px.align_shift(base, shifted, SR, device=CPU)
    assert got == jx.align_shift(base, shifted, SR)
    assert abs(got - shift) <= 1


def test_align_shift_large_lag_unequal_lengths_matches_jax():
    rng = np.random.default_rng(7)
    base = np.zeros(60 * SR, np.float32)
    for start in rng.integers(0, 59 * SR, size=40):
        base[start : start + SR // 2] += (
            0.5 * rng.standard_normal(SR // 2)).astype(np.float32)
    lag = 40 * SR
    short = base[lag : lag + 10 * SR]
    got = px.align_shift(base, short, SR, device=CPU)
    assert got == jx.align_shift(base, short, SR)
    assert abs(got + lag) <= 2 * (SR // 100)


def test_best_lag_unwraps_at_len_a():
    rng = np.random.default_rng(8)
    a = (0.2 * rng.standard_normal(7000)).astype(np.float32)
    b = a[6000:6500]  # circular index 6000 > n_fft // 2 = 4096, < len(a)
    assert px.best_lag(a, b, CPU) == jx.best_lag(a, b) == -6000
    assert px.best_lag(b, a, CPU) == jx.best_lag(b, a) == 6000


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_align_shift_on_dialogue_sessions_matches_jax(seed):
    """The sessions of ``chip_smoke.py`` phase 38 (turns with
    backchannels), 120 s, shifts planted on both channels."""
    rng = np.random.default_rng(seed)
    comp, host, mix = chip_smoke.raw_channels(rng, 120.0)
    for who, clean in (("comp", comp), ("host", host)):
        planted = int(rng.integers(-8000, 8000))
        ch = chip_smoke.plant(clean, planted)
        got = px.align_shift(mix, ch, SR, device=CPU)
        assert got == jx.align_shift(mix, ch, SR) == planted, who


def _uneven_dialogue(rng, seconds):
    """``chip_smoke.raw_channels``'s turns with a loudness of 0.2-0.4 per
    turn (0.1-0.2 per answer) in place of one loudness for both."""
    n = int(seconds * SR)
    waves = np.zeros((2, n), np.float32)
    t, who = 1.0, 0
    while True:
        length = rng.uniform(3.0, 8.0)
        if t + length + 1.0 > seconds:
            break
        a, z = int(t * SR), int((t + length) * SR)
        waves[who, a:z] += rng.uniform(0.2, 0.4) * rng.standard_normal(z - a)
        b = t + rng.uniform(0.5, min(length - 1.0, 3.0))
        a, z = int(b * SR), int((b + rng.uniform(0.4, 0.8)) * SR)
        waves[1 - who, a:z] += rng.uniform(0.1, 0.2) * rng.standard_normal(
            z - a)
        t, who = t + length + rng.uniform(2.5, 4.0), who ^ 1
    return waves[0], waves[1], 0.5 * (waves[0] + waves[1])


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_align_shift_matches_jax_where_the_envelopes_mislead(seed):
    """Turns of unequal loudness: the coarse stage correlates RMS
    envelopes (never negative), so a lag laying the quiet channel's turns
    on the loud one's can outweigh the true lag; at seed 0 the comp and
    at seed 5 the host channel are misread, in both packages alike. The
    port gives JAX's lag, right or wrong."""
    comp, host, mix = _uneven_dialogue(np.random.default_rng(seed), 60.0)
    for clean, planted in ((comp, 3200), (host, -1600)):
        ch = chip_smoke.plant(clean, planted)
        assert px.align_shift(mix, ch, SR, device=CPU) == jx.align_shift(
            mix, ch, SR)


# ---- Kaldi reference extractor -------------------------------------------

@pytest.fixture(scope="module")
def wave():
    rng = np.random.default_rng(0)
    t = np.arange(16000) / 16000
    return (0.3 * np.sin(2 * np.pi * 440 * t)
            + 0.02 * rng.standard_normal(len(t))).astype(np.float32)


@pytest.mark.parametrize("params", [
    dict(dither=0.0),
    dict(dither=0.0, num_mel_bins=40, num_ceps=20, frame_length_ms=32,
         frame_shift_ms=16, low_frequency=60.0, high_frequency=7600.0),
], ids=["default", "wider"])
def test_fbank_mfcc_spec_match_jax(wave, params):
    p = pdsp.KaldiParams(**params)
    jp = jdsp.KaldiParams(**params)
    fb, lp = pdsp.compute_fbank(wave, p, device=CPU)
    jfb, jlp = jdsp.compute_fbank(wave, jp)
    assert tuple(fb.shape) == np.asarray(jfb).shape
    np.testing.assert_allclose(fb.numpy(), np.asarray(jfb), rtol=0, atol=1e-4)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=0, atol=1e-4)
    mfcc = pdsp.compute_mfcc(wave, p, device=CPU)
    np.testing.assert_allclose(mfcc.numpy(), np.asarray(jdsp.compute_mfcc(
        wave, jp)), rtol=0, atol=1e-4)
    spec, slp = pdsp.compute_spec(wave, p, device=CPU)
    jspec, _ = jdsp.compute_spec(wave, jp)
    mag, jmag = 10 ** (spec.numpy() / 20), 10 ** (np.asarray(jspec) / 20)
    assert float(np.abs(mag - jmag).max() / jmag.max()) <= 1e-4
    np.testing.assert_array_equal(slp.numpy(), lp.numpy())


def test_short_wave_gives_no_frames(wave):
    p = pdsp.KaldiParams(dither=0.0)
    fb, lp = pdsp.compute_fbank(wave[:100], p, device=CPU)
    assert tuple(fb.shape) == np.asarray(jdsp.compute_fbank(
        wave[:100], p)[0]).shape == (0, 23)
    assert tuple(pdsp.compute_mfcc(wave[:100], p, device=CPU).shape) == (0, 13)


def test_dither_only_with_a_generator(wave):
    p = pdsp.KaldiParams(dither=1e-3)
    off = pdsp.compute_spec(wave, pdsp.KaldiParams(dither=0.0), device=CPU)[0]
    # no generator: nothing drawn, the undithered spectrum
    np.testing.assert_array_equal(pdsp.compute_spec(wave, p, device=CPU)[0],
                                  off)
    a = pdsp.compute_spec(wave, p, torch.Generator().manual_seed(0),
                          device=CPU)[0]
    b = pdsp.compute_spec(wave, p, torch.Generator().manual_seed(0),
                          device=CPU)[0]
    c = pdsp.compute_spec(wave, p, torch.Generator().manual_seed(1),
                          device=CPU)[0]
    np.testing.assert_array_equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, off)


# ---- native wav IO -------------------------------------------------------

@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    d = tmp_path_factory.mktemp("nat")
    rng = np.random.default_rng(0)
    mono = (0.3 * rng.standard_normal(SR * 3)).astype(np.float32)
    stereo = (0.3 * rng.standard_normal((2, SR))).astype(np.float32)
    wavio.write_wav(str(d / "mono.wav"), mono[None], SR)
    wavio.write_wav(str(d / "stereo.wav"), stereo, SR)
    return str(d / "mono.wav"), str(d / "stereo.wav"), mono


def test_read_slice_and_batch_bitwise(wav):
    mono, stereo, sig = wav
    for start, n in ((1000, 8000), (len(sig) - 50, 200), (len(sig) + 5, 10)):
        np.testing.assert_array_equal(pnio.read_slice(mono, start, n),
                                      jnio.read_slice(mono, start, n))
    paths, starts = [mono, stereo, mono, stereo], [0, 100, len(sig) - 7, 15990]
    for dtype in (np.float32, np.int16):
        got = pnio.read_batch(paths, starts, 4000, dtype=dtype)
        want = jnio.read_batch(paths, starts, 4000, dtype=dtype)
        assert got.dtype == want.dtype == np.dtype(dtype)
        np.testing.assert_array_equal(got, want)
        assert (got[2, 7:] == 0).all() and (got[3, 10:] == 0).all()
    ref, _ = wavio.read_wav(mono, 100, 4000, dtype=np.int16)
    np.testing.assert_array_equal(
        pnio.read_batch([mono], [100], 4000, dtype=np.int16)[0], ref[0])


def test_frame_energy_bitwise(wav):
    _, _, sig = wav
    for n in (16000, 399, 400, 561):
        got = pnio.frame_energy_native(sig[:n])
        np.testing.assert_array_equal(got, jnio.frame_energy_native(sig[:n]))
    np.testing.assert_array_equal(
        pnio.frame_energy_native(sig, 512, 128),
        jnio.frame_energy_native(sig, 512, 128))


def test_missing_file_raises(wav):
    with pytest.raises(OSError):
        pnio.read_slice("/nonexistent/file.wav", 0, 100)
    with pytest.raises(OSError, match="segment 1"):
        pnio.read_batch([wav[0], "/nonexistent/file.wav"], [0, 0], 10)


def test_library_builds_into_the_port_build_dir(tmp_path, monkeypatch):
    """A fresh build lands in the port's build directory under a name
    keyed by the source; ``native/`` is read, never written."""
    native = pnio.SOURCE.parent
    before = {p.name: p.stat().st_mtime_ns for p in native.iterdir()}
    monkeypatch.setattr(pnio, "BUILD_DIR", tmp_path / "_build")
    out = pnio.build()
    assert out.parent == tmp_path / "_build" and out.is_file()
    assert out.name.startswith("libmrgen_io-") and out == pnio.lib_path()
    lib = ctypes.CDLL(str(out))
    assert hasattr(lib, "mrgen_read_batch_i16")
    assert pnio.build() == out  # built once
    assert {p.name: p.stat().st_mtime_ns for p in native.iterdir()} == before
    assert pnio.lib_path().parent == tmp_path / "_build"
    assert _build.BUILD_DIR.name == "_build"


def test_failed_build_raises_naming_the_compiler_error(tmp_path, monkeypatch):
    bad = tmp_path / "mrgen_io.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(pnio, "SOURCE", bad)
    monkeypatch.setattr(pnio, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(pnio, "_lib", None)
    with pytest.raises(RuntimeError, match="failed"):
        pnio.load()
    with pytest.raises(RuntimeError, match="failed"):
        pnio.frame_energy_native(np.zeros(800, np.float32))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    bad.write_text("int x;\n")
    with pytest.raises(RuntimeError, match=r"no C\+\+ compiler"):
        pnio.build()


# ---- segmentation -----------------------------------------------------------

@pytest.fixture(scope="module")
def dialogue(tmp_path_factory):
    d = tmp_path_factory.mktemp("vad")
    comp, host, _ = chip_smoke.raw_channels(np.random.default_rng(5), 30.0)
    wavio.write_wav(str(d / "comp.wav"), comp[None], SR)
    wavio.write_wav(str(d / "host.wav"), host[None], SR)
    return d, comp


def test_log_power_and_turns_match_jax(dialogue):
    d, comp = dialogue
    np.testing.assert_array_equal(pseg.compute_log_power(comp),
                                  jseg.compute_log_power(comp))
    # the numpy sliding window JAX falls back to sums in another order
    np.testing.assert_allclose(pseg.compute_log_power(comp),
                               jseg._log_power_numpy(comp), rtol=0, atol=1e-5)
    got = pseg.get_utterance_section(str(d / "host.wav"), str(d / "comp.wav"),
                                     SR)
    want = jseg.get_utterance_section(str(d / "host.wav"),
                                      str(d / "comp.wav"), SR)
    assert len(got[0]) > 0 and len(got[1]) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_vad_reads_the_native_energy(monkeypatch):
    calls = []

    def spy(wave, n_fft, n_shift):
        calls.append((len(wave), n_fft, n_shift))
        return np.full(7, 2.0, np.float32)

    monkeypatch.setattr(pseg, "frame_energy_native", spy)
    out = pseg.compute_log_power(np.zeros(16000, np.float32))
    assert calls == [(16000, 400, 160)]
    np.testing.assert_allclose(out, np.log(2.0))


def test_debug_plots_as_jax(dialogue, tmp_path):
    pytest.importorskip("matplotlib")
    d, _ = dialogue
    got = pseg.get_utterance_section(
        str(d / "host.wav"), str(d / "comp.wav"), SR, exp_plot=True,
        exp_plot_dir=str(tmp_path / "port"))
    want = jseg.get_utterance_section(
        str(d / "host.wav"), str(d / "comp.wav"), SR, exp_plot=True,
        exp_plot_dir=str(tmp_path / "jax"))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    session = os.path.basename(str(d))
    names = sorted(os.listdir(tmp_path / "port" / session))
    assert names == sorted(os.listdir(tmp_path / "jax" / session))
    assert names == ["utterance_000_015.png", "utterance_015_030.png"]


def test_vad_cli_prints_jax_sections(dialogue, capsys, monkeypatch):
    d, _ = dialogue
    argv = [str(d / "host.wav"), str(d / "comp.wav")]
    jseg.main(argv)
    want = json.loads(capsys.readouterr().out)
    pseg.main(argv + ["--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == want
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pseg.main(argv)
    assert capsys.readouterr().out == ""


# ---- the loader's native batch read ---------------------------------------

def test_loader_reads_batches_natively_as_jax(tmp_path, monkeypatch):
    """No audio cache: the port's collate reads each batch's PCM16 slices
    in one native call, and its batches are JAX's."""
    corpus = make_synthetic_corpus(str(tmp_path / "c"), seconds=60.0)
    cfg = dict(DATA_CFG, data_dir=corpus)
    jd = jds.SegmentDatasetNX(
        JaxBuilder(cfg, cache_root=str(tmp_path / "j")).data_site,
        MOTION_CFG, AUDIO_CFG)
    pd = pds.SegmentDatasetNX(
        DataBuilderNX(cfg, cache_root=str(tmp_path / "p")).data_site,
        MOTION_CFG, AUDIO_CFG)
    calls = []
    real = pnio.read_batch

    def spy(paths, starts, frames, dtype=np.float32):
        calls.append((len(paths), np.dtype(dtype)))
        return real(paths, starts, frames, dtype)

    monkeypatch.setattr(pnio, "read_batch", spy)
    idx = np.arange(len(pd))
    kw = dict(pad_to_multiple=16, shuffle=False, audio_cfg=AUDIO_CFG)
    jl = jds.BatchLoader(jd, idx, 3, **kw)
    pl = pds.BatchLoader(pd, idx, 3, device=torch.device("cpu"), **kw)
    n = 0
    for got, want in zip(pl, jl):
        for m, ((g, gl), (w, wl)) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(np.asarray(gl), np.asarray(wl))
            g = g.numpy() if isinstance(g, torch.Tensor) else g
            if m in (0, 3):
                np.testing.assert_allclose(g, np.asarray(w), atol=2e-5,
                                           rtol=1e-5)
            else:
                np.testing.assert_array_equal(g, np.asarray(w))
        n += 1
    assert n == len(jl) >= 2
    assert calls and all(dt == np.int16 for _, dt in calls)
    assert len(calls) == 2 * n  # the audio and lead slices of each batch


def test_collate_wave_is_the_jax_batch(tmp_path):
    """The raw PCM16 batch the port uploads is the JAX loader's, bit for
    bit (slices past a segment's end zeroed)."""
    path = str(tmp_path / "x.wav")
    sig = (0.3 * np.random.default_rng(3).standard_normal(SR)).astype(
        np.float32)
    wavio.write_wav(path, sig[None], SR)
    paths, starts, lens = [path] * 3, [0, 5000, 15000], [4000, 2000, 4000]
    got = pnio.read_batch(paths, starts, 4000, dtype=np.int16)
    want = jnio.read_batch(paths, starts, 4000, dtype=np.int16)
    for b, n in enumerate(lens):
        got[b, n:] = 0
        want[b, n:] = 0
    np.testing.assert_array_equal(got, want)


# ---- profiling -----------------------------------------------------------------

def test_speed_log_as_jax(tmp_path):
    for mod, name in ((pprof, "port.log"), (jprof, "jax.log")):
        log = mod.SpeedLog(str(tmp_path / name))
        log.record(0.5, 250)
        log.record(1e-12, 3)
    assert (tmp_path / "port.log").read_text() == (
        tmp_path / "jax.log").read_text()


def test_trace_annotate_and_timeit(tmp_path):
    x = torch.ones(64, 64)
    with pprof.trace(str(tmp_path / "trace")):
        with pprof.annotate("corpus_span"):
            x @ x
    text = (tmp_path / "trace" / "trace.json").read_text()
    assert "corpus_span" in text
    assert pprof.timeit(lambda a: a @ a, x, iters=3) > 0.0
