"""PyTorch port: rotations, rendering and the generation speed log.

Held to the JAX package on the same seeded numpy inputs:

  * ``ops/rotations.py`` ``angles_to_matrix`` / ``matrix_to_angles``, all
    12 orders, on numpy arrays and tensors, angles within 0.05 degrees of
    gimbal lock among them: in float64 (JAX with x64 on) within 1e-6 abs;
    in float32, the JAX default, the matrices within 1e-6 abs and the
    angles within 2e-5 degrees (two float32 ulps at 90 degrees: numpy's,
    torch's and XLA's arctan round differently in the last bit);
  * ``destandardize``;
  * ``head_pose_plotter`` (pose only, and a face cloud with a culled
    outlier), ``pose_strips``, ``composite_frames`` and
    ``render_comparison``: the same image shapes and pixels as the JAX
    functions. A pixel may differ only where a coordinate rounds the
    other way (the rotation's float32 last bit); the tests count them and
    allow at most 0.1% of the pixels;
  * ``nod_pitch_plot``'s amplitude ratio within 1e-6 of JAX's;
  * ``generation_speed_log``: one line per batch in the JAX format, the
    file reset on each call, predictions bit-equal to a direct
    ``generate_lws`` / ``generate_metaformer`` call, and simple_lstm
    refused as in JAX.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalreactiongeneration_tpu.infer import visualize as jviz
from multimodalreactiongeneration_tpu.ops import rotations as jrot
from multimodalreactiongeneration_tpu_torch.configs import LWS_MODEL_CFG
from multimodalreactiongeneration_tpu_torch.infer import visualize as viz
from multimodalreactiongeneration_tpu_torch.infer.generate import (
    generate_lws,
    generate_metaformer,
    sampling_mask_for,
)
from multimodalreactiongeneration_tpu_torch.models import build_model
from multimodalreactiongeneration_tpu_torch.ops import rotations as rot
from tests.test_streaming_models import LWS_CFG, MF_CFG
from tests.test_torch_port_weights import np_batch

torch.set_num_threads(1)
PIXEL_SHARE = 1e-3
STATS = {
    "angle_mean": np.array([2.0, -1.0, 0.5]),
    "angle_std": np.array([10.0, 8.0, 6.0]),
    "centroid_mean": np.array([0.5, 0.5, 0.0]),
    "centroid_std": np.array([0.05, 0.05, 0.01]),
}


def _angles(dtype):
    rng = np.random.default_rng(0)
    ang = rng.uniform(-85.0, 85.0, (400, 3))
    ang[:40, 1] = rng.uniform(89.95, 90.0, 40)  # near gimbal lock
    ang[40:80, 1] = -rng.uniform(89.95, 90.0, 40)
    ang[80:120, 0] = 89.99
    return ang.astype(dtype)


@pytest.mark.parametrize("order", rot.ORDERS)
def test_rotations_match_jax(order):
    for dtype, mat_tol, ang_tol in ((np.float64, 1e-6, 1e-6),
                                    (np.float32, 1e-6, 2e-5)):
        ang = _angles(dtype)
        with jax.enable_x64(dtype == np.float64):
            want_m = np.array(jrot.angles_to_matrix(jnp.asarray(ang), order))
            want_a = np.asarray(jrot.matrix_to_angles(jnp.asarray(want_m),
                                                      order))
        assert want_m.dtype == dtype
        for got_m, got_a in (
                (rot.angles_to_matrix(ang, order),
                 rot.matrix_to_angles(want_m, order)),
                (rot.angles_to_matrix(torch.from_numpy(ang), order).numpy(),
                 rot.matrix_to_angles(torch.from_numpy(want_m),
                                      order).numpy())):
            assert got_m.dtype == got_a.dtype == dtype
            assert got_m.shape == (400, 3, 3) and got_a.shape == (400, 3)
            np.testing.assert_allclose(got_m, want_m, rtol=0, atol=mat_tol)
            np.testing.assert_allclose(got_a, want_a, rtol=0, atol=ang_tol)
    with pytest.raises(ValueError, match="order"):
        rot.angles_to_matrix(np.zeros(3), "xxx")
    with pytest.raises(ValueError, match="order"):
        rot.matrix_to_angles(np.eye(3), "abc")


def test_destandardize_matches_jax():
    motion = np.random.default_rng(1).standard_normal((7, 18)).astype(
        np.float32)
    for got, want in zip(viz.destandardize(motion, STATS),
                         jviz.destandardize(motion, STATS)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _same_pixels(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    differ = int((got != want).any(axis=-1).sum())
    pixels = got.shape[0] * got.shape[1]
    assert differ <= PIXEL_SHARE * pixels, (
        f"{differ} of {pixels} pixels differ")
    return differ


def _face(seed):
    face = np.random.default_rng(seed).normal(scale=0.05, size=(40, 3))
    face = face.astype(np.float32)
    face[5] = [5.0, 5.0, 0.0]  # re-posed far outside [0, 1]: culled
    return face


@pytest.mark.parametrize("with_face", [False, True])
def test_head_pose_plotter_matches_jax(with_face):
    rng = np.random.default_rng(2)
    face = _face(3) if with_face else None
    differ = 0
    for i in range(20):
        frame = rng.integers(0, 60, (200, 240, 3), dtype=np.uint8)
        pose = {"face": face,
                "centroid": rng.uniform(0.2, 0.8, 3).astype(np.float32),
                "angle": rng.uniform(-40, 40, 3).astype(np.float32)}
        got = viz.head_pose_plotter(frame.copy(), pose)
        want = jviz.head_pose_plotter(frame.copy(), pose)
        assert (got != frame).any()  # something was drawn
        differ += _same_pixels(got, want)
        assert (viz.head_pose_plotter(frame, None) == frame).all()
    print(f"head_pose_plotter face={with_face}: {differ} pixels differ "
          "over 20 frames")


def test_pose_strips_composite_and_comparison_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    pred = rng.normal(size=(30, 18)).astype(np.float32)
    true = rng.normal(size=(30, 18)).astype(np.float32)
    face = _face(5)

    strips = viz.pose_strips(pred, STATS, face, size=(90, 90))
    want = jviz.pose_strips(pred, STATS, face, size=(90, 90))
    assert [s.shape for s in strips] == [(30, 240, 3), (30, 60, 3)]
    assert len(strips) == len(want)
    for g, w in zip(strips, want):
        _same_pixels(g, w)

    movie = rng.integers(0, 255, (12, 48, 64, 3), dtype=np.uint8)
    frames = [movie[i] for i in range(10)] + [None]
    got = list(viz.composite_frames(pred, true, STATS, frames, face,
                                    max_frames=11))
    want = list(jviz.composite_frames(pred, true, STATS, frames, face,
                                      max_frames=11))
    assert len(got) == len(want) == 11 and got[0].shape == (48, 128, 3)
    assert (got[-1][:, :64] == 0).all()  # past EOF: a black panel
    for g, w in zip(got, want):
        _same_pixels(g, w)

    wav = tmp_path / "a.wav"
    wav.write_bytes(b"RIFF")
    n = viz.render_comparison(pred, true, STATS, str(tmp_path / "port"),
                              wav_path=str(wav), max_frames=5, face=face)
    nj = jviz.render_comparison(pred, true, STATS, str(tmp_path / "jax"),
                                wav_path=str(wav), max_frames=5, face=face)
    assert n == nj == 5
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    assert names == ["audio.wav"] + [f"frame_{t:05d}.png" for t in range(5)]
    from PIL import Image

    for name in names[1:]:
        _same_pixels(np.asarray(Image.open(tmp_path / "port" / name)),
                     np.asarray(Image.open(tmp_path / "jax" / name)))

    assert viz.save_pose_strips(pred, true, STATS, str(tmp_path / "s")) == 4
    assert sorted(os.listdir(tmp_path / "s")) == [
        "static_0.png", "static_1.png", "t_static_0.png", "t_static_1.png"]


@pytest.mark.parametrize("frames", [25, 160])
def test_nod_pitch_plot_ratio_matches_jax(tmp_path, frames):
    rng = np.random.default_rng(frames)
    pred = rng.normal(size=(frames, 18)).astype(np.float32)
    true = rng.normal(size=(frames, 18)).astype(np.float32)
    got = viz.nod_pitch_plot(pred, true, STATS, str(tmp_path / "p" / "nod.png"))
    want = jviz.nod_pitch_plot(pred, true, STATS, str(tmp_path / "nod.png"))
    assert os.path.getsize(tmp_path / "p" / "nod.png") > 0
    assert abs(got - want) <= 1e-6 and 0.1 < got < 10.0


LINE = re.compile(r"^(\d+\.\d{6}) sec / (\d+) frames \((\d+\.\d) frames/s\)$")


@pytest.mark.parametrize("model_type", ["lstm_with_sampling", "lstmformer"])
def test_generation_speed_log(tmp_path, model_type):
    cfg = LWS_CFG if model_type == "lstm_with_sampling" else MF_CFG
    model = build_model(model_type, cfg,
                        generator=torch.Generator().manual_seed(0),
                        device="cpu")
    batches = [tuple(torch.from_numpy(x) for x in np_batch(s, T=6, lead=2))
               for s in (1, 2, 3)]
    log = tmp_path / "speed.log"
    log.write_text("stale line\n")  # a previous run's file is replaced
    preds = viz.generation_speed_log(model, model_type, batches, str(log))
    lines = log.read_text().splitlines()
    assert len(lines) == len(batches) == len(preds)
    for line, pred in zip(lines, preds):
        m = LINE.match(line)
        assert m, line
        assert int(m.group(2)) == pred.shape[0] * pred.shape[1] == 12
    gen = generate_lws if model_type == "lstm_with_sampling" else (
        generate_metaformer)
    for pred, batch in zip(preds, batches):
        assert isinstance(pred, np.ndarray) and pred.shape == (2, 6, 18)
        direct = gen(model, batch, sampling_mask_for(6, "full")).numpy()
        np.testing.assert_array_equal(pred, direct)


def test_generation_speed_log_refuses_simple_lstm(tmp_path):
    log = tmp_path / "speed.log"
    log.write_text("x\n")
    for fn, args in ((viz.generation_speed_log, (None, "simple_lstm", [])),
                     (jviz.generation_speed_log,
                      (None, None, "simple_lstm", []))):
        with pytest.raises(ValueError, match="simple_generate"):
            fn(*args, str(log))
        assert not log.exists()  # reset before the refusal, as in JAX
        log.write_text("x\n")
    assert LWS_MODEL_CFG["num_layers"] == 2  # the config the CLI builds
