"""PyTorch port: the corpus CLIs vs the JAX package's, on the CPU.

Each ``corpus.ops`` subcommand, ``extract_angle_cent``, ``align_session``
and ``process_corpus`` of the port and of JAX run on the same temp
corpus (inputs written from the same numbers by each package's own
writers), and their trees are held equal: the same file names, the same
wav and movie bytes, the same ``.json`` (roots aside), the same ``.npz``
sections and arrays and ``.head`` fields (the head pose within the pose
bounds: angles 1e-3 degrees, centroids 1e-5), the same printed lines.
One test runs the whole chain, raw recordings to ``.npz`` sections, with
the JAX CLIs (mediapipe, ffmpeg and cv2 replaced by the synthetic
landmarker, array trimmer and array movie reader of ``chip_smoke.py``
phase 38) and the port's CLIs (the same stand-ins passed as keyword
arguments), compares the trees and the manifests both databuilds write
over them, and trains the port's ``train/cli.py`` on the port-built
corpus. Each CLI module runs as ``python -m ... --device cpu``; with no
device named and no CUDA it raises.
"""

import functools
import json
import os
import pickle
import shutil
import subprocess
import sys
from dataclasses import fields
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import multimodalreactiongeneration_tpu.corpus.video as jvideo_src
import multimodalreactiongeneration_tpu.infer.video as jvideo
from multimodalreactiongeneration_tpu.corpus import alignment as jalign
from multimodalreactiongeneration_tpu.corpus import extract_angle_cent as jext
from multimodalreactiongeneration_tpu.corpus import landmarks as jlm
from multimodalreactiongeneration_tpu.corpus import ops as jops
from multimodalreactiongeneration_tpu.data import head_io as jhead
from multimodalreactiongeneration_tpu.data.databuild_nx import (
    DataBuilderNX as JaxBuilder,
)
from multimodalreactiongeneration_tpu.utils import wavio as jwav
from multimodalreactiongeneration_tpu_torch.corpus import alignment as palign
from multimodalreactiongeneration_tpu_torch.corpus import (
    extract_angle_cent as pext,
)
from multimodalreactiongeneration_tpu_torch.corpus import landmarks as plm
from multimodalreactiongeneration_tpu_torch.corpus import ops as pops
from multimodalreactiongeneration_tpu_torch.corpus.video import (
    ArrayVideoReader,
)
from multimodalreactiongeneration_tpu_torch.data import head_io as phead
from multimodalreactiongeneration_tpu_torch.data import segmentation as pseg
from multimodalreactiongeneration_tpu_torch.data.databuild_nx import (
    DataBuilderNX,
)
from multimodalreactiongeneration_tpu_torch.train import cli as train_cli
from multimodalreactiongeneration_tpu_torch.utils import wavio as pwav
from tests.fixtures import DATA_CFG
from tests.test_torch_port_cli import SMALL, YAML
from tests.test_video import fake_encoder_cmd

import chip_smoke

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
SR = 16000
ANGLE_TOL, CENTROID_TOL = 1e-3, 1e-5
SEED_LM = 38  # the synthetic landmarker's face
JAX = SimpleNamespace(name="jax", ops=jops, head=jhead, wav=jwav, dev=[])
PORT = SimpleNamespace(name="port", ops=pops, head=phead, wav=pwav,
                       dev=["--device", "cpu"])
SIDES = (JAX, PORT)


# ---- comparing two trees ----------------------------------------------------

def _tol(name):
    """The pose bound of a HeadFrame field or an .npz array."""
    return CENTROID_TOL if name.startswith("centroid") else ANGLE_TOL


def _same_value(a, b, name, scale=1.0):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, name
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=0, atol=_tol(name) * scale,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    else:
        assert a == b, (name, a, b)


def _same_frame(a, b, where):
    assert (a is None) == (b is None), where
    if a is None:
        return
    for f in fields(phead.HeadFrame):
        _same_value(getattr(a, f.name), getattr(b, f.name), f"{where} {f.name}")


def _same_head_file(a, b, where):
    ra, rb = phead.loads_head(a.read_bytes()), phead.loads_head(b.read_bytes())
    if isinstance(ra, list):  # a monolithic (pre-split era) file
        assert len(ra) == len(rb), where
        for i, (fa, fb) in enumerate(zip(ra, rb)):
            _same_frame(fa, fb, f"{where}[{i}]")
        return
    assert ra[0] == rb[0], where
    _same_frame(ra[1], rb[1], where)


def _same_npz(a, b, where):
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files), where
        for key in za.files:
            # a standardized trajectory moves by its raw bound over its std
            std = za.get(f"{key}_std", 1.0)
            _same_value(za[key], zb[key], f"{where} {key}",
                        scale=2.0 / float(np.min(std)))


def _text(path, root):
    return path.read_text().replace(str(root), "<root>")


def assert_same_tree(a_root, b_root, under=""):
    """The trees under ``a_root / under`` and ``b_root / under`` hold the
    same files with the same contents (``a_root`` / ``b_root`` written
    as ``<root>`` in text files)."""
    a_root, b_root = Path(a_root), Path(b_root)
    names = sorted(str(p.relative_to(a_root)) for p in
                   (a_root / under).rglob("*") if p.is_file())
    assert names == sorted(str(p.relative_to(b_root)) for p in
                           (b_root / under).rglob("*") if p.is_file())
    assert names
    for rel in names:
        a, b = a_root / rel, b_root / rel
        if rel.endswith(".head"):
            _same_head_file(a, b, rel)
        elif rel.endswith(".npz"):
            _same_npz(a, b, rel)
        elif rel.endswith((".json", ".jsonl")):
            assert sorted(_text(a, a_root).splitlines()) == sorted(
                _text(b, b_root).splitlines()), rel
        elif rel.endswith(".png"):
            assert a.stat().st_size > 0 and b.stat().st_size > 0, rel
        else:
            assert a.read_bytes() == b.read_bytes(), rel
    return names


def _lines(out, root):
    return sorted(out.replace(str(root), "<root>").splitlines())


# ---- inputs, written by each package's own writers ------------------------

def _wave(seed, n=SR, ch=1):
    rng = np.random.default_rng(seed)
    return (0.2 * rng.standard_normal((ch, n))).astype(np.float32)


def _head_dir(side, d, who="comp", frames=260, gap=(100, 105), long_gap=None,
              stats=False):
    """tests/test_corpus_ops.py's head directory, as ``side`` writes it."""
    rng = np.random.default_rng(3)
    d = Path(d) / who
    d.mkdir(parents=True, exist_ok=True)
    traj = np.cumsum(rng.normal(size=(frames, 6)), axis=0)
    missing = set(range(*gap)) | (set(range(*long_gap)) if long_gap else set())
    for t in range(frames):
        frame = None
        if t not in missing:
            frame = side.head.HeadFrame(
                angle=traj[t, :3], centroid=traj[t, 3:], frame_no=t, fps=25.0,
                angle_mean=np.zeros(3), angle_std=np.ones(3) * (2 if stats
                                                               else 1),
                centroid_mean=np.zeros(3), centroid_std=np.ones(3))
        side.head.write_head_frame(str(d / f"{who}_{t:05d}.head"), t, frame)
    return d


def _monolithic(side, path, n=6, none_at=(2,)):
    frames = [None if i in none_at else side.head.HeadFrame(
        angle=np.array([float(i), 0.0, 0.0]),
        centroid=np.array([0.0, float(i), 0.0]), time=-1.0, frame_no=-1,
        fps=0.0) for i in range(n)]
    with open(path, "wb") as f:
        pickle.dump(frames, f)


def _setup_rename(side, r):
    for s, names in (("d01", ("movie_xxx.mp4", "c-01_alice.wav",
                              "h-02_bob.wav", "pair_raw.wav")),
                     ("d02", ("movie_yy.mp4", "c-03_carol.wav",
                              "h-02_bob.wav"))):
        (r / s).mkdir(parents=True)
        for name in names:
            (r / s / name).write_bytes(name.encode())
    return ["rename", "--target", str(r)]


def _setup_participants(side, r):
    _setup_rename(side, r)
    side.ops.rename_sessions(str(r))
    return ["participants", "--target", str(r)]


def _audio_sessions(side, r):
    for s, seed in (("s0", 0), ("s1", 1)):
        (r / s).mkdir(parents=True)
        side.wav.write_wav(str(r / s / "comp.wav"), _wave(seed), SR)
        side.wav.write_wav(str(r / s / "host.wav"), _wave(seed + 5, SR + 7),
                           SR)
        (r / s / "movie.mp4").write_bytes(b"movie" + bytes([seed]))
    side.wav.write_wav(str(r / "s1" / "bad.wav"), _wave(9, ch=2), SR)
    side.wav.write_wav(str(r / "s1" / "slow.wav"), _wave(9), 8000)


def _setup_stereo(side, r):
    _audio_sessions(side, r / "raw")
    return ["stereo", "--target", str(r / "raw"), "--output",
            str(r / "stereo")]


def _setup_check_audio(side, r):
    _audio_sessions(side, r)
    return ["check-audio", "--target", str(r)]


def _setup_extract(side, r):
    _audio_sessions(side, r / "src")
    return ["extract", "--target", str(r / "src"), "--output", str(r / "dst")]


def _setup_anomaly(side, r):
    _head_dir(side, r / "c" / "s0", "host", frames=50, gap=(10, 13))
    _head_dir(side, r / "c" / "s1", "comp", frames=40, gap=(0, 4))
    return ["anomaly", "--target", str(r / "c"), "--output",
            str(r / "anomaly.jsonl")]


def _setup_statistics(side, r):
    _head_dir(side, r / "s0", "host", frames=50, gap=(10, 13))
    _head_dir(side, r / "s1", "comp", frames=30, gap=(3, 5))
    return ["statistics", "--target", str(r), "--stamp"]


def _setup_duration(side, r):
    _head_dir(side, r / "s0", "host", frames=50, gap=(10, 13))
    side.wav.write_wav(str(r / "s0" / "host.wav"), _wave(1, 4 * SR), SR)
    _head_dir(side, r / "s1", "comp", frames=50, gap=(10, 13))
    side.wav.write_wav(str(r / "s1" / "comp.wav"), _wave(2, 2 * SR), SR)
    return ["duration-check", "--target", str(r)]


def _setup_quarantine(side, r):
    _head_dir(side, r / "c" / "bad_session", "comp", frames=500, gap=(0, 450))
    _head_dir(side, r / "c" / "good_session", "comp", frames=50, gap=(5, 8))
    side.ops.anomaly_search(str(r / "c"), str(r / "report.jsonl"))
    return ["quarantine", "--target", str(r / "c"), "--report",
            str(r / "report.jsonl"), "--output", str(r / "quarantine")]


def _setup_backfill(side, r):
    good = _head_dir(side, r / "s0", "comp", frames=50, gap=(5, 8))
    os.remove(good / "comp_00020.head")
    os.remove(good / "comp_00021.head")
    return ["backfill", "--target", str(r)]


def _setup_angle_jumps(side, r):
    d = _head_dir(side, r / "c" / "s0", "host", frames=50, gap=(10, 13))
    idx, frame = side.head.load_head_file(str(d / "host_00025.head"))
    frame.angle = frame.angle + np.array([30.0, 0.0, 0.0])
    side.head.write_head_frame(str(d / "host_00025.head"), idx, frame)
    return ["angle-jumps", "--target", str(r / "c"), "--threshold", "8",
            "--hist-dir", str(r / "hist")]


def _setup_split_head(side, r):
    (r / "corpus" / "s0").mkdir(parents=True)
    _monolithic(side, r / "corpus" / "s0" / "comp.head", n=5, none_at=(3,))
    (r / "corpus" / "s0" / "comp.wav").write_bytes(b"RIFFfake")
    return ["migrate-split-head", "--target", str(r / "corpus"), "--output",
            str(r / "migrated")]


def _setup_stamp_fps(side, r):
    (r / "corpus" / "s0").mkdir(parents=True)
    _monolithic(side, r / "corpus" / "s0" / "comp.head", n=4, none_at=(1,))
    return ["migrate-stamp-fps", "--target", str(r / "corpus"), "--output",
            str(r / "migrated"), "--fps", "25"]


def _setup_copy_wavs(side, r):
    src = r / "formd" / "s0"
    src.mkdir(parents=True)
    for name in ("host.wav", "comp.wav", "pair.wav"):
        (src / name).write_bytes(name.encode())
    (r / "features" / "s0").mkdir(parents=True)
    (r / "features" / "s0" / "host.wav").write_bytes(b"OLD")
    return ["migrate-copy-wavs", "--target", str(r / "formd"), "--output",
            str(r / "features")]


OPS = {
    "rename": _setup_rename, "participants": _setup_participants,
    "stereo": _setup_stereo, "check-audio": _setup_check_audio,
    "extract": _setup_extract, "anomaly": _setup_anomaly,
    "statistics": _setup_statistics, "duration-check": _setup_duration,
    "quarantine": _setup_quarantine, "backfill": _setup_backfill,
    "angle-jumps": _setup_angle_jumps, "migrate-split-head": _setup_split_head,
    "migrate-stamp-fps": _setup_stamp_fps,
    "migrate-copy-wavs": _setup_copy_wavs,
}


def test_every_subcommand_is_held():
    src = (ROOT / "multimodalreactiongeneration_tpu" / "corpus" /
           "ops.py").read_text()
    named = {line.split('"')[1] for line in src.splitlines()
             if 'sub.add_parser("' in line}
    assert named == set(OPS)


@pytest.mark.parametrize("cmd", sorted(OPS))
def test_ops_subcommand_matches_jax(cmd, tmp_path, capsys):
    out = {}
    for side in SIDES:
        root = tmp_path / side.name
        root.mkdir()
        argv = OPS[cmd](side, root)
        capsys.readouterr()
        side.ops.main(argv + side.dev)
        out[side.name] = _lines(capsys.readouterr().out, root)
    assert out["port"] == out["jax"]
    assert_same_tree(tmp_path / "jax", tmp_path / "port")
    if cmd == "angle-jumps":
        assert (tmp_path / "port" / "hist" / "s0_host_angle_jumps.png"
                ).is_file()
    if cmd == "quarantine":
        assert (tmp_path / "port" / "quarantine" / "bad_session").is_dir()


# ---- extract_angle_cent ------------------------------------------------------

def test_extract_angle_cent_matches_jax(tmp_path):
    for side, mod in ((JAX, jext), (PORT, pext)):
        session = tmp_path / side.name / "corpus" / "data00"
        _head_dir(side, session, "comp", frames=400, gap=(100, 105),
                  long_gap=(250, 280), stats=True)
        _head_dir(side, session, "host", frames=300, gap=(0, 6))
        side.wav.write_wav(str(session / "comp.wav"), _wave(4), SR)
        mod.main(["--path", str(tmp_path / side.name / "corpus"), "--output",
                  str(tmp_path / side.name / "npz")] + side.dev)
    names = assert_same_tree(tmp_path / "jax", tmp_path / "port", "npz")
    assert [n for n in names if n.endswith(".npz")] == [
        "npz/data00/comp_00000_00250.npz", "npz/data00/comp_00280_00400.npz",
        "npz/data00/host_00006_00300.npz"]


def test_fix_data_leaves_a_gap_at_the_start():
    for mod in (jext, pext):
        angle = [None, None, np.ones(3), np.zeros(3), None, np.full(3, 4.0)]
        cent = [None if a is None else a * 2 for a in angle]
        out = mod.fix_data({"angle": list(angle), "centroid": list(cent)})
        assert out["angle"][0] is None and out["angle"][1] is None
        np.testing.assert_allclose(out["angle"][4], np.full(3, 2.0))


# ---- alignment -------------------------------------------------------------------

def _session(side, d, seed, mix_as_m4a=False):
    rng = np.random.default_rng(seed)
    comp, host, mix = chip_smoke.raw_channels(rng, 30.0)
    d.mkdir(parents=True)
    side.wav.write_wav(str(d / "comp.wav"), chip_smoke.plant(comp, 3200)[None],
                       SR)
    side.wav.write_wav(str(d / "host.wav"), chip_smoke.plant(host, -1600)[None],
                       SR)
    if mix_as_m4a:
        (d / "session.m4a").write_bytes(b"not a real m4a")
    else:
        side.wav.write_wav(str(d / "pair.wav"), mix[None], SR)
    with open(d / "movie.mp4", "wb") as f:
        np.save(f, chip_smoke.side_by_side_movie(30 * chip_smoke.FPS))
    return (np.repeat(np.clip(mix, -1, 1), 2) * 32767).astype("<i2")


def test_load_m4a_matches_jax():
    pcm = np.arange(-8, 8, dtype="<i2")

    def decoder(cmd):
        return b"32000\n" if cmd[0] == "ffprobe" else pcm.tobytes()

    got = palign.load_m4a("/fake/session.m4a", decoder=decoder)
    want = jalign.load_m4a("/fake/session.m4a", decoder=decoder)
    assert got[1] == want[1] == 16000
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("m4a", [False, True], ids=["pair_wav", "m4a"])
def test_align_session_matches_jax(tmp_path, m4a):
    shifts = {}
    for side, mod in ((JAX, jalign), (PORT, palign)):
        pcm2x = _session(side, tmp_path / side.name / "raw" / "s0", 7, m4a)
        kw = dict(decoder=lambda cmd, pcm2x=pcm2x: (
            b"32000\n" if cmd[0] == "ffprobe" else pcm2x.tobytes()),
            video_runner=chip_smoke.array_trim_runner)
        if side is PORT:
            kw["device"] = "cpu"
        out = tmp_path / side.name / "aligned" / "s0"
        shifts[side.name] = mod.align_session(
            str(tmp_path / side.name / "raw" / "s0"), str(out), **kw)
        assert mod.align_session(str(tmp_path / side.name / "raw" / "s0"),
                                 str(out), **kw) is None  # resume
    assert shifts["port"] == shifts["jax"] == {"comp": 3200, "host": -1600}
    names = assert_same_tree(tmp_path / "jax", tmp_path / "port", "aligned")
    assert sorted(os.path.basename(n) for n in names) == [
        "alignment.json", "comp.wav", "host.wav", "movie.mp4", "pair.wav"]


# ---- landmarks ----------------------------------------------------------------

def _video(n):
    frames = np.zeros((n, 8, 8, 3), np.uint8)
    frames[:, 0, 0, 0] = np.arange(n)
    return ArrayVideoReader(frames, fps=50.0)


def _landmarker(calls=None):
    lm = chip_smoke.SyntheticLandmarker(SEED_LM)

    def detect(frame):
        if calls is not None:
            calls.append(int(frame[0, 0, 0]))
        t = int(frame[0, 0, 0])
        return None if t in (3, 4) else lm.face(t, 0)

    return detect



@pytest.mark.parametrize("visualize", [False, True])
def test_head_pose_estimation_matches_jax(tmp_path, visualize):
    """Stride 2 (50 fps video, 25 fps estimate), chunks of 4, a missed face
    written as None, the overlay movie in stream order; a second run
    resumes and estimates nothing."""
    for side, mod in ((JAX, jlm), (PORT, plm)):
        kw = {"device": "cpu"} if side is PORT else {}
        est = mod.HeadPoseEstimation(_landmarker(), chunk=4,
                                     visualize=visualize,
                                     encoder_cmd=fake_encoder_cmd, **kw)
        assert est(_video(20), str(tmp_path / side.name), "host") == 10
        calls = []
        again = mod.HeadPoseEstimation(_landmarker(calls), **kw)
        again(_video(20), str(tmp_path / side.name), "host")
        assert calls == []
    names = assert_same_tree(tmp_path / "jax", tmp_path / "port")
    assert len([n for n in names if n.endswith(".head")]) == 10
    if visualize:
        assert "host_visualized.mp4" in names


def test_estimate_and_stamp_matches_jax(tmp_path):
    for side, mod in ((JAX, jlm), (PORT, plm)):
        kw = {"device": "cpu"} if side is PORT else {}
        assert mod.estimate_and_stamp(_video(12), str(tmp_path / side.name),
                                      "comp", landmarker=_landmarker(),
                                      **kw) == 6
    assert_same_tree(tmp_path / "jax", tmp_path / "port")
    _, f = phead.load_head_file(str(tmp_path / "port" / "comp_00000.head"))
    assert (f.angle_std > 0).all()


def test_process_corpus_matches_jax(tmp_path, monkeypatch):
    """Both halves of every session's movie, two worker threads sharing
    one landmarker behind a lock, the sample-mode overlays."""
    raw = tmp_path / "raw"
    for s in ("data01", "data02"):
        (raw / s).mkdir(parents=True)
        with open(raw / s / "movie.mp4", "wb") as f:
            np.save(f, chip_smoke.side_by_side_movie(40))
    for mod in (jlm, plm):
        orig = mod.HeadPoseEstimation
        monkeypatch.setattr(mod, "HeadPoseEstimation", functools.partial(
            orig, encoder_cmd=fake_encoder_cmd))
    lm = chip_smoke.SyntheticLandmarker(SEED_LM)
    n_jax = jlm.process_corpus(str(raw), str(tmp_path / "jax"), pnum=2,
                               visualize="sample", landmarker=lm,
                               open_video_fn=chip_smoke.open_array_movie)
    n_port = plm.process_corpus(str(raw), str(tmp_path / "port"), pnum=2,
                                visualize="sample", landmarker=lm,
                                open_video_fn=chip_smoke.open_array_movie,
                                device="cpu")
    assert n_port == n_jax == 2 * 2 * 40
    names = assert_same_tree(tmp_path / "jax", tmp_path / "port")
    assert "data01/comp/comp_visualized.mp4" in names
    assert "data02/comp/comp_visualized.mp4" not in names


def test_mediapipe_landmarker_needs_mediapipe(monkeypatch):
    monkeypatch.setitem(sys.modules, "mediapipe", None)
    with pytest.raises(ImportError, match="custom landmarker"):
        plm.mediapipe_landmarker()


# ---- the whole chain ------------------------------------------------------------

def _jax_chain(raw, root, monkeypatch):
    """JAX's CLIs with ffmpeg, mediapipe and cv2 replaced."""
    monkeypatch.setattr(jvideo, "trim_video", functools.partial(
        jvideo.trim_video, runner=chip_smoke.array_trim_runner))
    monkeypatch.setattr(jlm, "mediapipe_landmarker",
                        lambda **kw: chip_smoke.SyntheticLandmarker(SEED_LM))
    monkeypatch.setattr(jvideo_src, "open_video", chip_smoke.open_array_movie)
    jalign.main(["--target", str(raw), "--output", str(root / "aligned")])
    jlm.main(["--target", str(root / "aligned"), "--output",
              str(root / "aligned")])
    jext.main(["--path", str(root / "aligned"), "--output", str(root / "npz")])


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """One raw corpus (2 sessions x 60 s, ``chip_smoke.write_raw_corpus``)
    through the JAX CLIs and through the port's, as ``chip_smoke.py``
    phase 38 runs them (``corpus_chain``: the three CLIs, then the
    training CLI's loaders and one batch)."""
    root = tmp_path_factory.mktemp("chain")
    planted = chip_smoke.write_raw_corpus(str(root / "raw"))
    mp = pytest.MonkeyPatch()
    try:
        _jax_chain(root / "raw", root / "jax", mp)
    finally:
        mp.undo()
    shutil.copytree(root / "raw", root / "port" / "raw")
    port = chip_smoke.corpus_chain(str(root / "port"), torch.device("cpu"),
                                   planted, config=str(ROOT / YAML))
    return root, planted, port


def test_chain_builds_the_jax_corpus(chain):
    root, planted, port = chain
    names = (assert_same_tree(root / "jax", root / "port", "aligned")
             + assert_same_tree(root / "jax", root / "port", "npz"))
    for session, shifts in planted.items():
        meta = json.loads((root / "port" / "aligned" / session /
                           "alignment.json").read_text())
        assert meta["shifts"] == shifts
    npz = sorted(n for n in names if n.endswith(".npz"))
    # per session one comp section (its 3-frame gaps interpolated) and two
    # host sections (split at the 20-frame gap)
    assert [os.path.basename(n).split("_")[0] for n in npz] == [
        "comp", "host", "host"] * len(planted)
    heads = [n for n in names if n.endswith(".head")]
    assert len(heads) == port["heads"] > 4 * 1400
    assert port["segments"] >= 8 and len(port["batch"]) == 7


def test_chain_manifests_match_jax(chain, tmp_path):
    root, _, _ = chain
    sites = {}
    for name, builder in (("jax", JaxBuilder), ("port", DataBuilderNX)):
        cfg = dict(DATA_CFG, data_dir=str(root / name / "npz"))
        site = builder(cfg, cache_root=str(tmp_path / name)).data_site
        sites[name] = {
            f: json.loads(_text(Path(site) / f, root / name))
            for f in sorted(os.listdir(site))}
    assert sites["port"] == sites["jax"]
    assert len(sites["port"]) >= 8


def test_cli_trains_on_the_port_built_corpus(chain, tmp_path, monkeypatch):
    root, _, _ = chain
    monkeypatch.chdir(tmp_path)  # the manifests go under ./data
    result = train_cli.main(["--config", YAML, "name=chain",
                             f"data_dir={root / 'port' / 'npz'}",
                             "ckpt_path=ck", "log_dir=log", *SMALL,
                             "max_epochs=1"])
    rec = result.history[0]
    for key in ("train_loss", "val_loss"):
        assert np.isfinite(rec[key]), (key, rec)
    assert rec["step"] >= 1


# ---- the command lines ---------------------------------------------------------

def _cli_inputs(r):
    _head_dir(PORT, r / "feat" / "data00", "comp", frames=150, gap=(50, 53))
    (r / "raw").mkdir()
    comp, host, mix = chip_smoke.raw_channels(np.random.default_rng(1), 20.0)
    for name, wave in (("comp", comp), ("host", host)):
        pwav.write_wav(str(r / f"{name}.wav"), wave[None], SR)
    d = r / "raw" / "data00"
    d.mkdir()
    for name, wave in (("comp", comp), ("host", host), ("pair", mix)):
        pwav.write_wav(str(d / f"{name}.wav"), wave[None], SR)


CLIS = {
    "corpus.ops": lambda r: ["check-audio", "--target", str(r / "raw")],
    "corpus.alignment": lambda r: ["--target", str(r / "raw"), "--output",
                                   str(r / "aligned")],
    "corpus.landmarks": lambda r: ["--target", str(r / "raw"), "--output",
                                   str(r / "feat2")],
    "corpus.extract_angle_cent": lambda r: ["--path", str(r / "feat"),
                                            "--output", str(r / "npz")],
    "data.segmentation": lambda r: [str(r / "host.wav"), str(r / "comp.wav")],
}
MAINS = {"corpus.ops": pops.main, "corpus.alignment": palign.main,
         "corpus.landmarks": plm.main, "corpus.extract_angle_cent": pext.main,
         "data.segmentation": pseg.main}


@pytest.mark.parametrize("module", sorted(CLIS))
def test_cli_module_runs_with_device_cpu(module, tmp_path):
    _cli_inputs(tmp_path)
    proc = subprocess.run(
        [sys.executable, "-m", f"multimodalreactiongeneration_tpu_torch."
         f"{module}", *CLIS[module](tmp_path), "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode == 0, proc.stderr[-2000:]
    if module == "corpus.extract_angle_cent":  # prints nothing
        assert list((tmp_path / "npz" / "data00").glob("comp_*.npz"))
    else:
        assert proc.stdout.strip()


@pytest.mark.parametrize("module", sorted(CLIS))
def test_cli_module_refuses_the_cpu_unless_named(module, tmp_path,
                                                 monkeypatch, capsys):
    _cli_inputs(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MAINS[module](CLIS[module](tmp_path))
    assert capsys.readouterr().out == ""
    assert not (tmp_path / "aligned").exists()
    assert not (tmp_path / "npz").exists()
