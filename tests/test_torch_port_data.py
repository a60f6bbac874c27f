"""PyTorch port: the training data path vs the JAX package, on the CPU.

On one synthetic corpus (``tests/fixtures.make_synthetic_corpus``), the
port's ``DataBuilderNX`` writes the JAX builder's manifests, and the
port's ``SegmentDatasetNX`` + ``BatchLoader`` give the JAX loaders'
batches: motion and targets exactly, lengths exactly, fbank features to
1e-5 relative and 2e-5 absolute (a 400-term matmul DFT summed in another
order, then a log: features near 7 round to ~1e-6 in f32, off by up to
~6e-6 here; the second-delta channels add three such features, weights
1, 2, 1); through the host collate (``pad_collate``), and through ``pad_collate_device`` with and without
the device audio cache. ``ops/dsp.py`` is held to tests/test_dsp.py's
numpy goldens and to the JAX fbank. The port runs on the CPU here
(``device="cpu"``); its loaders name no device in production and run on
``cuda:0``.
"""

import json
import os

import numpy as np
import pytest
import torch

from multimodalreactiongeneration_tpu.data import dataset as jds
from multimodalreactiongeneration_tpu.data.audio_cache import (
    DeviceAudioCache as JaxAudioCache,
)
from multimodalreactiongeneration_tpu.data.databuild_nx import (
    DataBuilderNX as JaxBuilder,
)
from multimodalreactiongeneration_tpu.ops import dsp as jdsp
from multimodalreactiongeneration_tpu_torch.data import dataset as pds
from multimodalreactiongeneration_tpu_torch.data.audio_cache import (
    DeviceAudioCache,
)
from multimodalreactiongeneration_tpu_torch.data.databuild_nx import (
    DataBuilderNX,
)
from multimodalreactiongeneration_tpu_torch.ops import dsp
from tests.fixtures import AUDIO_CFG, DATA_CFG, MOTION_CFG, make_synthetic_corpus
from tests.test_dsp import numpy_delta, numpy_mel_reference

torch.set_num_threads(1)
FBANK_TOL = dict(atol=2e-5, rtol=1e-5)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    corpus = make_synthetic_corpus(str(root / "c"), n_sessions=1,
                                   seconds=90.0)
    cfg = dict(DATA_CFG, data_dir=corpus)
    jb = JaxBuilder(cfg, cache_root=str(root / "jax"))
    pb = DataBuilderNX(cfg, cache_root=str(root / "port"))
    jd = jds.SegmentDatasetNX(jb.data_site, MOTION_CFG, AUDIO_CFG)
    pd = pds.SegmentDatasetNX(pb.data_site, MOTION_CFG, AUDIO_CFG)
    return jb, pb, jd, pd


def _read(site):
    out = {}
    for name in sorted(os.listdir(site)):
        with open(os.path.join(site, name), encoding="utf-8") as f:
            out[name] = json.load(f)
    return out


def test_builder_writes_the_jax_manifests(built):
    jb, pb, jd, pd = built
    assert len(pd) == len(jd) >= 8
    assert _read(pb.data_site) == _read(jb.data_site)
    np.testing.assert_array_equal(pd.segment_lengths(), jd.segment_lengths())
    assert pd.audio_paths() == jd.audio_paths()


def _assert_batches_equal(got, want):
    assert len(got) == len(want) == 7
    for m, ((g, gl), (w, wl)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(np.asarray(gl), np.asarray(wl))
        g = g.cpu().numpy() if isinstance(g, torch.Tensor) else g
        w = np.asarray(w)
        assert g.shape == w.shape, m
        if m in (0, 3):  # fbank
            np.testing.assert_allclose(g, w, **FBANK_TOL, err_msg=str(m))
            np.testing.assert_array_equal(g == -100.0, w == -100.0)
        else:
            np.testing.assert_array_equal(g, w, err_msg=str(m))


@pytest.mark.parametrize("device_collate", [False, True])
def test_batch_loader_gives_the_jax_batches(built, device_collate):
    _, _, jd, pd = built
    tr, _, _ = jds.random_split_indices(len(jd), 0.8, 0.1, seed=0)
    ptr, _, _ = pds.random_split_indices(len(pd), 0.8, 0.1, seed=0)
    np.testing.assert_array_equal(ptr, tr)
    audio = AUDIO_CFG if device_collate else None
    kw = dict(pad_to_multiple=16, shuffle=True, seed=3, audio_cfg=audio,
              bucket_windows=2)
    jl = jds.BatchLoader(jd, tr, 3, **kw)
    pl = pds.BatchLoader(pd, tr, 3, device=CPU, **kw)
    assert len(pl) == len(jl)
    for epoch in range(2):  # the shuffle changes per epoch on both sides
        pairs = list(zip(pl, jl))
        assert len(pairs) == len(jl)
        for got, want in pairs:
            _assert_batches_equal(got, want)


@pytest.mark.parametrize("cached", [False, True])
def test_pad_collate_device_matches_jax(built, cached):
    _, _, jd, pd = built
    idx = [0, 2, 5]
    jspecs = [jd.raw_item(i, audio="spec") for i in idx]
    pspecs = [pd.raw_item(i, audio="spec") for i in idx]
    jcache = pcache = None
    if cached:
        jcache = JaxAudioCache.build_for_dataset(
            jd, AUDIO_CFG, pad_to_multiple=16, ratio=8, budget_bytes=1 << 30)
        pcache = DeviceAudioCache.build_for_dataset(
            pd, AUDIO_CFG, pad_to_multiple=16, ratio=8, budget_bytes=1 << 30,
            device=CPU)
        assert pcache is not None and pcache.nbytes == jcache.nbytes
    want = jds.pad_collate_device(jspecs, AUDIO_CFG, 16, 8,
                                  audio_cache=jcache)
    got = pds.pad_collate_device(pspecs, AUDIO_CFG, 16, 8,
                                 audio_cache=pcache, device=CPU)
    _assert_batches_equal(got, want)
    # the array path (host slices) gives the same features
    arrays = pds.pad_collate_device([pd.raw_item(i) for i in idx], AUDIO_CFG,
                                    16, 8, device=CPU)
    for m in (0, 3):
        torch.testing.assert_close(arrays[m][0], got[m][0], rtol=0, atol=0)


def test_audio_cache_gather_matches_jax(built, tmp_path):
    from multimodalreactiongeneration_tpu_torch.utils import wavio

    sr = 16000
    sig = np.linspace(-0.5, 0.5, sr // 2, dtype=np.float32)
    p = str(tmp_path / "short.wav")
    wavio.write_wav(p, sig[None], sr)
    jc = JaxAudioCache.build([p], max_slice_samples=sr, budget_bytes=1 << 30)
    pc = DeviceAudioCache.build([p], max_slice_samples=sr,
                                budget_bytes=1 << 30, device=CPU)
    needed = sr // 4
    start = sr // 2 - needed // 2  # runs past EOF; true_len shorter still
    args = ([p], [start], [needed // 2 + 100], needed)
    got = pc.gather(*args)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), np.asarray(jc.gather(*args)))
    assert pc.gather(["missing.wav"], [0], [10], 10) is None
    assert pc.gather([p], [sr * 2], [10], 10) is None
    assert DeviceAudioCache.build([p], sr, budget_bytes=10, device=CPU) is None


@pytest.fixture(scope="module")
def wave():
    rng = np.random.default_rng(0)
    t = np.arange(16000 * 2) / 16000.0
    sig = 0.4 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(len(t))
    return sig.astype(np.float32)


def test_dsp_matches_golden_and_jax(wave):
    params = dsp.FbankParams()
    ours = dsp.logmel_with_power(torch.from_numpy(wave), params).numpy()
    ref = numpy_delta(numpy_mel_reference(wave), 2)
    assert ours.shape == ref.shape == (params.num_output_frames(len(wave)), 81)
    np.testing.assert_allclose(ours, ref, atol=2e-3, rtol=1e-4)
    jax_out = np.asarray(jdsp.logmel_with_power(wave, jdsp.FbankParams()))
    np.testing.assert_allclose(ours, jax_out, **FBANK_TOL)
    np.testing.assert_array_equal(
        dsp.mel_filterbank(201, 26, 16000), jdsp.mel_filterbank(201, 26, 16000))


def test_dsp_delta_orders_and_masked_batch(wave):
    for order in (0, 1, 2):
        params = dsp.FbankParams(delta_order=order)
        out = dsp.logmel_with_power(torch.from_numpy(wave[:8000]), params)
        assert tuple(out.shape) == (params.num_frames(8000) - order,
                                    27 * (order + 1))
        feat = numpy_mel_reference(wave[:8000].astype(np.float64))
        np.testing.assert_array_equal(
            dsp.delta_stack(torch.from_numpy(feat), order).numpy(),
            numpy_delta(feat, order))
    params = dsp.FbankParams()
    pcm = (np.stack([wave[:8000], wave[8000:16000]]) * 32768).astype(np.int16)
    counts = np.array([40, 20], np.int32)
    got = dsp.batched_logmel_masked(torch.from_numpy(pcm),
                                    torch.from_numpy(counts), params, -100.0)
    want = jdsp.batched_logmel_masked(pcm, counts, jdsp.FbankParams(), -100.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FBANK_TOL)
    assert bool((got[1, 20:] == -100.0).all())
