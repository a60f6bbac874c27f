"""PyTorch port: the evaluation CLI against the JAX one.

The counterpart of tests/test_cli.py:136 test_eval_cli_renders_all_segments,
on a tiny NX corpus with the same weights in both packages: JAX params
saved by the JAX package's saver, the same params through
``state_dict_from_jax`` into a port checkpoint. Both CLIs run on the CPU
(``device=cpu`` for the port), PNG rendering (no ffmpeg here):

  * lstm_with_sampling at f32: the port's genrt loss within 1e-5
    relative of JAX's, the same output files (speed.log, per segment the
    frames, the wav, the pose strips and nod.png), one speed.log line per
    batch, and the same nod ratio within 1e-4;
  * the small flagship, and the same with mha embeddings (decoded on the
    in-loop shared-KV path): the same file set and a finite loss
    (free-running bf16 rollouts of two implementations diverge;
    teacher-forced parity is held in test_torch_port_generate.py and
    test_torch_port_decode_layouts.py);
  * the mp4 branch through a fake encoder, one mp4 and nod.png per
    segment;
  * a reference-style checkpoint (the port's export, wrapped as a
    Lightning .ckpt, through ``torch_import.main``) evaluates to the same
    predictions bit for bit as the checkpoint it came from;
  * simple_lstm is refused, as by the JAX CLI.
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalreactiongeneration_tpu.infer import cli as jcli
from multimodalreactiongeneration_tpu.models import build_model as jbuild
from multimodalreactiongeneration_tpu.train.checkpoint import (
    TopKCheckpointer as JaxCheckpointer,
)
from multimodalreactiongeneration_tpu.utils.config import (
    load_config as jload_config,
)
from multimodalreactiongeneration_tpu_torch.configs import load_config
from multimodalreactiongeneration_tpu_torch.infer import cli
from multimodalreactiongeneration_tpu_torch.models import (
    torch_export,
    torch_import,
)
from multimodalreactiongeneration_tpu_torch.models.weights import (
    state_dict_from_jax,
)
from tests.fixtures import make_synthetic_corpus
from tests.test_cli import SMALL_STREAMING
from tests.test_torch_port_video import fake_encoder_cmd
from tests.test_torch_port_weights import flat_params

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LWS_YAML = os.path.join(ROOT, "configs", "lstm_with_sampling.yaml")
MF_YAML = os.path.join(ROOT, "configs", "lstmformer.yaml")
LWS_SMALL = SMALL_STREAMING + ["model.sampler_hidden_size=16",
                               "model.sampler_num_layers=1"]
MF_SMALL = SMALL_STREAMING + ["model.num_block=2",
                              "model.encoder_num_layer=1"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_corpus")
    return make_synthetic_corpus(str(root), n_sessions=1, seconds=60.0)


def _jax_params(yaml, overrides, seed):
    """A JAX model of the yaml's config at small width, initialised."""
    cfg = jload_config(yaml, overrides)
    mc = cfg.model.to_dict()
    ratio = int(mc["sampling_rate"] / mc["shift"] / mc["pred_fps"])
    nm = (mc["nmels"] + 1) * (mc["delta_order"] + 1)
    mo = ((int(mc["use_centroid"]) + int(mc["use_angle"])) * 3
          * (mc["delta_order"] + 1))
    example = [jnp.zeros(s) for s in ((1, 4 * ratio, nm), (1, 4, mo),
                                      (1, 4, mo), (1, 2 * ratio, nm),
                                      (1, 2, mo), (1, 2, mo))]
    model = jbuild(cfg.exp.use_model, cfg.model)
    return model.init(jax.random.PRNGKey(seed), *example)


def _checkpoints(tmp_path, yaml, overrides, seed):
    """(JAX checkpoint dir, port checkpoint file) holding the same
    weights."""
    params = _jax_params(yaml, overrides, seed)
    jdir = tmp_path / "jax_ckpt"
    saver = JaxCheckpointer(str(jdir), top_k=1)
    saver.save_last(params, None, epoch=0)
    saver.wait()
    port = tmp_path / "port_ckpt"
    port.mkdir()
    torch.save({"params": state_dict_from_jax(flat_params(params)),
                "epoch": 0}, port / "last")
    return str(jdir / "last"), str(port / "last")


def _run(main, yaml, corpus, work, ckpt, out, overrides, capsys):
    """Run an eval CLI from ``work`` (the manifests go under its ./data);
    returns the JSON line it printed last."""
    cwd = os.getcwd()
    os.makedirs(work, exist_ok=True)
    os.chdir(work)
    try:
        capsys.readouterr()
        main(["--config", yaml, f"data_dir={corpus}", f"model_path={ckpt}",
              f"output_path={out}", f"log_dir={work}/log", "name=test",
              "max_render_frames=4"] + overrides)
        printed = capsys.readouterr().out.strip().splitlines()
    finally:
        os.chdir(cwd)
    return json.loads(printed[-1])


def _files(out):
    return sorted(os.path.relpath(p, out) for p in
                  glob.glob(os.path.join(out, "**", "*"), recursive=True)
                  if os.path.isfile(p))


def _segments(out):
    return sorted(d for d in os.listdir(out)
                  if os.path.isdir(os.path.join(out, d)))


def test_lws_eval_cli_matches_jax(corpus, tmp_path, capsys):
    jckpt, pckpt = _checkpoints(tmp_path, LWS_YAML, LWS_SMALL, 3)
    jax_out, port_out = str(tmp_path / "jax_viz"), str(tmp_path / "viz")
    want = _run(jcli.main, LWS_YAML, corpus, str(tmp_path / "jwork"), jckpt,
                jax_out, LWS_SMALL
                + ["compile_cache_dir=null"], capsys)
    got = _run(cli.main, LWS_YAML, corpus, str(tmp_path / "work"), pckpt,
               port_out, LWS_SMALL + ["device=cpu"], capsys)
    assert got["batches"] == want["batches"] >= 1
    assert np.isfinite(got["genrt_loss"])
    rel = abs(got["genrt_loss"] - want["genrt_loss"]) / abs(
        want["genrt_loss"])
    print(f"lws genrt_loss port {got['genrt_loss']} jax "
          f"{want['genrt_loss']} rel {rel:.3e}")
    assert rel <= 1e-5
    assert abs(got["nod_ratio"] - want["nod_ratio"]) <= 1e-4
    files = _files(port_out)
    assert files == _files(jax_out)
    segments = _segments(port_out)
    assert len(segments) >= 2
    for seg in segments:
        assert {f"{seg}/nod.png", f"{seg}/audio.wav", f"{seg}/static_0.png",
                f"{seg}/frame_00003.png"} <= set(files)
    with open(os.path.join(port_out, "speed.log"), encoding="utf-8") as f:
        assert len(f.read().splitlines()) == got["batches"]


def test_metaformer_eval_cli_renders_as_jax(corpus, tmp_path, capsys):
    jckpt, pckpt = _checkpoints(tmp_path, MF_YAML, MF_SMALL, 4)
    jax_out, port_out = str(tmp_path / "jax_viz"), str(tmp_path / "viz")
    want = _run(jcli.main, MF_YAML, corpus, str(tmp_path / "jwork"), jckpt,
                jax_out, MF_SMALL
                + ["compile_cache_dir=null"], capsys)
    got = _run(cli.main, MF_YAML, corpus, str(tmp_path / "work"), pckpt,
               port_out, MF_SMALL + ["device=cpu"], capsys)
    assert got["batches"] == want["batches"]
    assert np.isfinite(got["genrt_loss"]) and np.isfinite(got["nod_ratio"])
    assert _files(port_out) == _files(jax_out)
    assert got["output"] == port_out


def test_metaformer_mha_embeddings_eval_cli(corpus, tmp_path, capsys):
    """An mha-embedding Metaformer: its decode takes the in-loop shared-KV
    path (the hoist refuses mha other-modality embeddings), and the CLI
    writes the JAX CLI's files with a finite loss."""
    overrides = MF_SMALL + ["model.emb_mixers=[mha,mha,mha]"]
    jckpt, pckpt = _checkpoints(tmp_path, MF_YAML, overrides, 5)
    jax_out, port_out = str(tmp_path / "jax_viz"), str(tmp_path / "viz")
    want = _run(jcli.main, MF_YAML, corpus, str(tmp_path / "jwork"), jckpt,
                jax_out, overrides + ["compile_cache_dir=null"], capsys)
    got = _run(cli.main, MF_YAML, corpus, str(tmp_path / "work"), pckpt,
               port_out, overrides + ["device=cpu"], capsys)
    assert got["batches"] == want["batches"] >= 1
    assert np.isfinite(got["genrt_loss"]) and np.isfinite(got["nod_ratio"])
    assert _files(port_out) == _files(jax_out)


def test_eval_cli_mp4_branch_and_imported_checkpoint(corpus, tmp_path,
                                                     capsys, monkeypatch):
    """The mp4 branch through the fake encoder (audio mux skipped), then
    the reference round trip: export -> Lightning .ckpt -> torch_import ->
    evaluate, bit-equal to evaluating the original checkpoint."""
    from multimodalreactiongeneration_tpu_torch.infer import video
    from multimodalreactiongeneration_tpu_torch.infer import visualize

    _, pckpt = _checkpoints(tmp_path, LWS_YAML, LWS_SMALL, 5)
    monkeypatch.setattr(video, "have_ffmpeg", lambda: True)
    orig = visualize.render_segment_video

    def patched(*args, **kw):
        kw["encoder_cmd"] = fake_encoder_cmd
        kw["runner"] = lambda cmd, check: None
        return orig(*args, **kw)

    monkeypatch.setattr(cli, "render_segment_video", patched)
    out = str(tmp_path / "viz")
    work = str(tmp_path / "work")
    got = _run(cli.main, LWS_YAML, corpus, work, pckpt, out,
               LWS_SMALL + ["device=cpu"], capsys)
    mp4s = glob.glob(os.path.join(out, "*", "*.mp4"))
    nods = glob.glob(os.path.join(out, "*", "nod.png"))
    assert len(mp4s) >= 2 and len(nods) == len(mp4s)
    assert not glob.glob(os.path.join(out, "*", "frame_*.png"))
    for path in mp4s:  # 4 frames of 960 x 480 RGB each, as piped
        assert os.path.getsize(path) == 4 * 960 * 480 * 3
    monkeypatch.undo()

    cfg = load_config(LWS_YAML, LWS_SMALL + [f"data_dir={corpus}"])
    exported = torch_export.EXPORTERS["lstm_with_sampling"](
        torch.load(pckpt, weights_only=True)["params"], cfg.model.to_dict())
    ref = tmp_path / "ref.ckpt"
    torch.save({"state_dict": {f"model.{k}": v for k, v in exported.items()},
                "epoch": 3}, ref)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        torch_import.main(["--config", LWS_YAML, "--ckpt", str(ref),
                           "--out", str(tmp_path / "imported")]
                          + LWS_SMALL + [f"data_dir={corpus}"])
        results = [cli.evaluate(load_config(LWS_YAML, LWS_SMALL + [
            f"data_dir={corpus}", f"model_path={path}", "device=cpu",
            f"output_path={tmp_path / name}"]))
            for name, path in (("a", pckpt),
                               ("b", str(tmp_path / "imported" / "last")))]
    finally:
        os.chdir(cwd)
    (preds_a, batches, losses_a), (preds_b, _, losses_b) = results
    assert len(preds_a) == len(batches) == got["batches"]
    for a, b in zip(preds_a, preds_b):
        np.testing.assert_array_equal(a, b)
    assert losses_a == losses_b
    assert abs(float(np.mean(losses_a)) - got["genrt_loss"]) <= 1e-6


def test_eval_cli_refuses_simple_lstm(tmp_path):
    simple = os.path.join(ROOT, "configs", "simple_lstm.yaml")
    with pytest.raises(ValueError, match="simple_generate"):
        cli.main(["--config", simple, f"data_dir={tmp_path}",
                  f"model_path={tmp_path / 'none'}", "device=cpu",
                  f"output_path={tmp_path / 'viz'}",
                  f"log_dir={tmp_path / 'log'}", "name=x"])
    assert not os.path.exists(tmp_path / "viz")


def test_eval_cli_device_is_cuda_unless_named(monkeypatch):
    """``cuda:0`` by default (the yaml's ``device: tpu`` names none of the
    port's devices); ``device=cpu`` runs on the CPU; no CUDA and no device
    named raises rather than fall back."""
    assert cli.device_of(load_config(LWS_YAML, ["device=cpu"])).type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for overrides in ([], ["device=tpu"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.device_of(load_config(LWS_YAML, overrides))

