"""PyTorch port: video writing, audio muxing and video sources.

The counterparts of tests/test_video.py, held to the JAX modules: the
writer piped through a fake encoder (no ffmpeg binary needed), the same
ffmpeg argv as the JAX ``infer/video.py`` for every command, the wav
slice of ``cat_audio``, a whole segment through ``render_segment_video``,
and the video sources of ``corpus/video.py`` (``open_video``,
``HalfVideoSource``, ``split_frame``, ``frames_at``) against the JAX
ones on the same arrays.
"""

import os
import sys

import numpy as np
import pytest

from multimodalreactiongeneration_tpu.corpus import video as jcvideo
from multimodalreactiongeneration_tpu.infer import video as jvid
from multimodalreactiongeneration_tpu.infer import visualize as jviz
from multimodalreactiongeneration_tpu_torch.corpus import video as cvideo
from multimodalreactiongeneration_tpu_torch.infer import video as vid
from multimodalreactiongeneration_tpu_torch.infer import visualize as viz
from multimodalreactiongeneration_tpu_torch.utils import wavio

STATS = {
    "angle_mean": np.zeros(3), "angle_std": np.full(3, 10.0),
    "centroid_mean": np.full(3, 0.5), "centroid_std": np.full(3, 0.05),
}


def fake_encoder_cmd(path, fps, width, height):
    """stdin -> file byte sink standing in for ffmpeg."""
    code = ("import sys; "
            f"open({path!r}, 'wb').write(sys.stdin.buffer.read())")
    return [sys.executable, "-c", code]


def recorder():
    calls = []

    def runner(cmd, check):
        assert check
        calls.append(cmd)

    return calls, runner


def test_writer_pipes_all_frames_and_rejects_bad_ones(tmp_path):
    out = tmp_path / "seg" / "clip.mp4"
    w, h, n = 32, 24, 5
    writer = vid.FfmpegVideoWriter(str(out), fps=12.5,
                                   encoder_cmd=fake_encoder_cmd)
    with writer:
        writer.write(np.full((h, w, 3), 7, np.uint8))  # single frame
        writer.write([np.full((h, w, 3), i, np.uint8) for i in range(n - 1)])
    assert writer.frames_written == n
    assert out.stat().st_size == n * w * h * 3  # every rawvideo byte arrived

    bad = vid.FfmpegVideoWriter(str(tmp_path / "x.mp4"), fps=25,
                                encoder_cmd=fake_encoder_cmd)
    with pytest.raises(ValueError, match="uint8"):
        bad.write(np.zeros((8, 8, 3), np.float32))
    bad.write(np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(ValueError, match="size"):
        bad.write(np.zeros((16, 16, 3), np.uint8))
    bad.close()


def test_writer_requires_ffmpeg_without_injection(tmp_path, monkeypatch):
    monkeypatch.setattr(vid, "have_ffmpeg", lambda: False)
    with pytest.raises(RuntimeError, match="ffmpeg"):
        vid.FfmpegVideoWriter(str(tmp_path / "x.mp4"), fps=25)
    with pytest.raises(RuntimeError, match="ffmpeg"):
        vid.patch_audio("o.mp4", "i.mp4", "a.wav")
    assert vid.have_ffmpeg() is False


def test_ffmpeg_argv_as_jax():
    assert (vid._default_encoder_cmd("/o/out.mp4", 12.5, 960, 480)
            == jvid._default_encoder_cmd("/o/out.mp4", 12.5, 960, 480))
    got, run = recorder()
    want, jrun = recorder()
    vid.patch_audio("out.mp4", "in.mp4", "a.wav", runner=run)
    jvid.patch_audio("out.mp4", "in.mp4", "a.wav", runner=jrun)
    vid.trim_video("in.mp4", "out.mp4", 1.25, 7.5, runner=run)
    jvid.trim_video("in.mp4", "out.mp4", 1.25, 7.5, runner=jrun)
    assert got == want and len(got) == 2
    cmd = got[0]
    assert cmd[cmd.index("-i") + 1] == "in.mp4" and cmd[-1] == "out.mp4"
    assert "copy" in cmd  # video stream-copied, not re-encoded


def test_cat_audio_slices_segment_as_jax(tmp_path):
    """[sr*start/fps, sr*(stop+stride)/fps) of the wav (reference
    visualize_metaformer.py:71-80), the same bytes and argv as JAX."""
    sr, fps = 16000, 25.0
    wav = tmp_path / "pair.wav"
    wave = np.random.default_rng(0).uniform(-0.5, 0.5, (1, sr * 4))
    wavio.write_wav(str(wav), wave.astype(np.float32), sr)
    got, run = recorder()
    want, jrun = recorder()
    outs = []
    for sub, fn, runner in (("port", vid.cat_audio, run),
                            ("jax", jvid.cat_audio, jrun)):
        os.makedirs(tmp_path / sub)
        outs.append(fn(str(tmp_path / "seg.mp4"),
                       str(tmp_path / sub / "seg_patched.mp4"), str(wav),
                       start=25, stop=50, fps=fps, stride=2, runner=runner))
    sliced, got_sr = wavio.read_wav(outs[0])
    assert got_sr == sr
    assert sliced.shape[1] == int(sr * (50 + 2) / fps) - int(sr * 25 / fps)
    with open(outs[0], "rb") as a, open(outs[1], "rb") as b:
        assert a.read() == b.read()
    assert [c[:-1] for c in got] == [
        [x.replace("/jax/", "/port/") for x in c[:-1]] for c in want]


def test_render_segment_video_end_to_end(tmp_path):
    sr = 16000
    wav = tmp_path / "pair.wav"
    wavio.write_wav(str(wav), np.zeros((1, sr * 6), np.float32), sr)
    rng = np.random.default_rng(0)
    pred = rng.normal(size=(12, 18)).astype(np.float32)
    true = rng.normal(size=(12, 18)).astype(np.float32)
    calls, run = recorder()
    out = tmp_path / "seg" / "seg.mp4"
    n = viz.render_segment_video(
        pred, true, STATS, str(out), wav_path=str(wav),
        seq={"start": 0, "end": 24, "stride": 2}, data_fps=25.0,
        pred_fps=12.5, encoder_cmd=fake_encoder_cmd, runner=run)
    assert n == 12
    assert out.stat().st_size == 12 * 960 * 480 * 3
    assert len(calls) == 1  # audio muxed once
    assert os.path.exists(str(out).rsplit(".", 1)[0] + "_patched.wav")

    # the side-by-side mode: movie frame | pose board, the JAX frames
    movie = rng.integers(0, 255, (40, 32, 48, 3), dtype=np.uint8)
    jout = tmp_path / "jax" / "seg.mp4"
    for fn, source, path in (
            (viz.render_segment_video, cvideo.open_video(movie), out),
            (jviz.render_segment_video, jcvideo.open_video(movie), jout)):
        assert fn(pred, true, STATS, str(path), wav_path=None,
                  seq={"start": 3, "end": 30, "stride": 2},
                  encoder_cmd=fake_encoder_cmd, max_frames=6,
                  source=source) == 6
    assert out.read_bytes() == jout.read_bytes()


def test_video_sources_as_jax(tmp_path, monkeypatch):
    from PIL import Image

    rng = np.random.default_rng(1)
    movie = rng.integers(0, 255, (9, 6, 11, 3), dtype=np.uint8)
    np.save(tmp_path / "m.npy", movie)
    frames_dir = tmp_path / "frames"
    frames_dir.mkdir()
    for i in range(3):
        Image.fromarray(movie[i]).save(frames_dir / f"f{i:02d}.png")
    for arg in (movie, str(tmp_path / "m.npy"), str(frames_dir)):
        src, jsrc = cvideo.open_video(arg, fps=12.5), jcvideo.open_video(
            arg, fps=12.5)
        assert type(src).__name__ == type(jsrc).__name__
        assert (len(src), src.size, src.fps) == (len(jsrc), jsrc.size,
                                                  jsrc.fps)
        for a, b in zip(src, jsrc):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(src[1], jsrc[1])
    monkeypatch.setitem(sys.modules, "cv2", None)  # a host without cv2
    with pytest.raises(ImportError, match="cv2"):
        cvideo.open_video(str(tmp_path / "movie.mp4"))
    monkeypatch.undo()

    for side in (0, 1):
        half = cvideo.HalfVideoSource(cvideo.open_video(movie), side)
        jhalf = jcvideo.HalfVideoSource(jcvideo.open_video(movie), side)
        assert half.size == jhalf.size == (5, 6) and len(half) == 9
        np.testing.assert_array_equal(half[4], jhalf[4])
        for a, b in zip(half, jhalf):
            np.testing.assert_array_equal(a, b)
    comp, host = cvideo.split_frame(movie[0])
    assert comp.shape == host.shape == (6, 5, 3)  # odd width: middle dropped
    np.testing.assert_array_equal(host, movie[0][:, -5:])

    # frames_at: random access and one ascending pass, past EOF -> None
    idx = [2, 5, 3, 99]
    got = viz.frames_at(cvideo.open_video(movie), idx)
    assert got[-1] is None
    for a, b in zip(got[:3], jviz.frames_at(jcvideo.open_video(movie), idx)):
        np.testing.assert_array_equal(a, b)
    streamed = viz.frames_at(iter(list(movie)), idx)
    for a, b in zip(streamed[:3], got[:3]):
        np.testing.assert_array_equal(a, b)
    assert streamed[-1] is None
