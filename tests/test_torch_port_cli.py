"""PyTorch port: the training CLI, its config, and the default device.

  * ``configs.LSTMFORMER`` is ``configs/lstmformer.yaml`` as the JAX
    loader reads it, and the port's ``load_config`` (overrides, then
    interpolation) resolves to the JAX ``utils/config.py load_config``'s
    dict; override values parse as the JAX loader's YAML scalars;
  * ``load_config`` reads the file it is given: every shipped yaml, and
    an edited copy under another name, load as the JAX loader loads them,
    and every built-in dict of ``configs.CONFIGS`` is its yaml;
  * ``train.cli.main`` with ``device=cpu`` on a synthetic corpus at
    small width (hidden 32, 1 block, batch 2) builds the manifests, trains
    an epoch with two validation checks and the generation eval, writes
    V/T/G top-k checkpoints and ``last``, and resumes from ``last`` for a
    second epoch with the optimizer state restored;
  * the entry points run on ``cuda:0`` unless the caller names a device,
    and raise without CUDA rather than fall back to the CPU.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

from multimodalreactiongeneration_tpu.utils import config as jconfig
from multimodalreactiongeneration_tpu_torch import configs, resolve_device
from multimodalreactiongeneration_tpu_torch.models.lstmformer import Metaformer
from multimodalreactiongeneration_tpu_torch.train import cli
from tests.fixtures import make_synthetic_corpus
from tests.test_streaming_models import MF_CFG

torch.set_num_threads(1)
YAML = os.path.join(os.path.dirname(__file__), "..", "configs",
                    "lstmformer.yaml")
OVERRIDES = [
    "name=run-01", "data_dir=/tmp/corpus", "ckpt_path=ck", "log_dir=lg",
    "hidden_size=32", "lr=1e-3", "trainer.val_check_interval=0.5",
    "callbacks.async_checkpoint=false", "exp.batch_size=4", "seed=7",
    "model_path=null", "trainer.mesh_shape=[2, 4]", "x.y.z=yes",
]


def test_config_dict_is_the_yaml():
    with open(YAML, encoding="utf-8") as f:
        assert configs.LSTMFORMER == jconfig._yaml_load(f.read())


@pytest.mark.parametrize("overrides", [[], OVERRIDES])
def test_load_config_resolves_as_the_jax_loader(overrides):
    got = configs.load_config(YAML, overrides)
    want = jconfig.load_config(YAML, overrides)
    assert got.to_dict() == want.to_dict()
    assert configs.load_config("lstmformer", overrides) == got
    assert got.model.hidden_size == want.model.hidden_size
    assert got.trainer.get("pad_to_multiple", 1) == 16
    assert got.trainer.get("absent", 3) == 3
    if not overrides:
        with pytest.raises(KeyError, match="mandatory"):
            got.data.data_dir  # noqa: B018 - the read raises
        with pytest.raises(KeyError, match="mandatory"):
            jconfig.load_config(YAML).data.data_dir  # noqa: B018


@pytest.mark.parametrize("text", [
    "1e-3", "5e-6", "1.0", ".5", "3.", "-4", "0", "+1", "1_000", "1E3",
    "true", "True", "yes", "off", "null", "~", "", "abc", "a b", "[1, 2]",
    "[a, 0.5]", "'7'", '"x y"', "-.inf", "0.25", "cpu", "tpu",
])
def test_override_values_parse_as_yaml(text):
    got, want = configs.parse_value(text), jconfig._parse_override_value(text)
    assert got == want or (isinstance(got, float) and math.isnan(got)
                           and math.isnan(want))
    assert type(got) is type(want)


CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                          "configs")
SHIPPED = ("lstmformer", "lstmformer_gru", "lstm_with_sampling", "simple_lstm",
           "simple_lstm_best")


@pytest.mark.parametrize("overrides", [[], OVERRIDES])
@pytest.mark.parametrize("name", SHIPPED)
def test_load_config_reads_every_shipped_yaml(name, overrides):
    path = os.path.join(CONFIG_DIR, f"{name}.yaml")
    got = configs.load_config(path, overrides)
    assert got.to_dict() == jconfig.load_config(path, overrides).to_dict()
    with open(path, encoding="utf-8") as f:
        assert configs.CONFIGS[name] == jconfig._yaml_load(f.read())
    assert configs.parse_yaml(open(path, encoding="utf-8").read()) == (
        configs.CONFIGS[name])


def test_load_config_reads_an_edited_copy_under_any_name(tmp_path):
    """The repair: the file is read, not looked up by its stem."""
    with open(os.path.join(CONFIG_DIR, "simple_lstm.yaml"),
              encoding="utf-8") as f:
        text = f.read()
    text = text.replace("batch_size: 256", "batch_size: 7  # edited") + (
        "\n# a trailing comment\nextra:\n    ratio: 1e-2\n    tags: [a, 'b c']"
        "\n    items:\n    - 3\n    - x\n    empty:\n    mark: '#1'\n")
    for name in ("my_run.yaml", "lstmformer.yaml"):
        path = tmp_path / name
        path.write_text(text, encoding="utf-8")
        for overrides in ([], ["exp.train_rate=0.5", "lr=3e-4"]):
            got = configs.load_config(str(path), overrides)
            want = jconfig.load_config(str(path), overrides)
            assert got.to_dict() == want.to_dict()
        assert got.exp.batch_size == 7 and got.optim.lr == 3e-4
        assert got.extra.ratio == 0.01 and got.extra["items"] == [3, "x"]
        assert got.extra.mark == "#1" and got.extra.empty is None
    with pytest.raises(FileNotFoundError, match="no config file"):
        configs.load_config(str(tmp_path / "absent.yaml"))
    for bad in ("a: &x 1\n", "a: |\n  text\n", "a:\n  - - 1\n",
                "a: 1\n b: 2\n"):
        with pytest.raises(ValueError):
            configs.parse_yaml(bad)


def test_model_config_cut_from_the_full_config():
    resolved = configs.load_config("lstmformer")
    for key, value in configs.LSTMFORMER_MODEL_CFG.items():
        assert resolved.model[key] == value
    assert configs.LSTMFORMER_OPTIM_CFG["lr"] == 5e-6
    assert configs.LSTMFORMER_LOSS_CFG["loss_type"] == "huber"


SMALL = [
    "device=cpu", "hidden_size=32", "bottleneck_size=8", "batch_size=2",
    "optim_epochs=2", "lr=1e-3", "motion.max_len=150", "motion.min_len=50",
    "motion.shift_len=150", "motion.leading_len=24", "model.num_block=1",
    "model.encoder_num_layer=2", "trainer.val_check_interval=0.5",
    "callbacks.save_top_k=2",
]


def test_cli_trains_checkpoints_and_resumes(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the manifests go under ./data
    corpus = make_synthetic_corpus(str(tmp_path / "corpus"), n_sessions=1,
                                   seconds=90.0)
    common = ["name=cli", f"data_dir={corpus}", "ckpt_path=ck",
              "log_dir=log", *SMALL]
    result = cli.main(["--config", YAML, *common, "max_epochs=1"])
    assert result.epochs_run == 1
    rec = result.history[0]
    assert rec["val_checks"] == 2
    for key in ("train_loss", "val_loss", "genrt_loss"):
        assert np.isfinite(rec[key]), key
    names = sorted(os.listdir(tmp_path / "ck" / "cli"))
    assert "last" in names
    for mon in "VTG":
        assert any(n.startswith(f"{mon}0-") for n in names), mon
    with open(tmp_path / "log" / "metrics.jsonl", encoding="utf-8") as f:
        lines = [json.loads(x) for x in f]
    assert [("val_check" in x) for x in lines] == [True, True, False]

    resumed = cli.main(["--config", YAML, *common, "max_epochs=2",
                        "resume_from=ck/cli/last"])
    assert [r["epoch"] for r in resumed.history] == [1]
    assert np.isfinite(resumed.history[0]["train_loss"])
    # the cosine schedule picked up at epoch 1 of optim_epochs 2
    assert resumed.history[0]["lr"] == pytest.approx(0.5e-3)
    last = torch.load(tmp_path / "ck" / "cli" / "last", weights_only=True)
    assert last["epoch"] == 1 and last["opt"]["state"]


def test_cli_trains_two_inner_layer_mixers(tmp_path, monkeypatch):
    """``model.num_internal_layer=2`` (a setting configs/lstmformer.yaml
    documents and no shipped yaml uses): 2-layer LSTM mixers in every
    block and 2 MHA layers in every integrator train an epoch with the
    generation eval (held to JAX in tests/test_torch_port_mixer_kinds.py)."""
    monkeypatch.chdir(tmp_path)
    corpus = make_synthetic_corpus(str(tmp_path / "corpus"), n_sessions=1,
                                   seconds=90.0)
    result = cli.main(["--config", YAML, "name=inner2", f"data_dir={corpus}",
                       "ckpt_path=ck", "log_dir=log", *SMALL, "max_epochs=1",
                       "model.num_internal_layer=2"])
    rec = result.history[0]
    for key in ("train_loss", "val_loss", "genrt_loss"):
        assert np.isfinite(rec[key]), key
    last = torch.load(tmp_path / "ck" / "inner2" / "last", weights_only=True)
    assert (last["params"]["metaformer.block_0.emb_0.block_0.mixer."
                           "weight_hh_l1"].shape == (4 * 32, 32))


def test_cli_refuses_other_models_and_unported_options():
    """An unknown model, a 'model' mesh axis (parameter sharding, ROADMAP
    queue A, item 10) and a data axis wider than the process group raise;
    scheduled sampling, dropout, accumulation and remat train
    (tests/test_torch_port_train_options.py), and so does
    ``trainer.mesh_shape: [N, 1]`` on N processes
    (tests/test_torch_port_data_parallel.py)."""
    with pytest.raises(ValueError, match="gpt"):
        cli.main(["--config", "configs/lstmformer.yaml", "device=cpu",
                  "exp.use_model=gpt"])
    with pytest.raises(NotImplementedError, match="item 10"):
        cli.main(["--config", "configs/lstmformer.yaml", "device=cpu",
                  "model.use_scheduled_sampling=true",
                  "trainer.mesh_shape=[1, 2]"])
    with pytest.raises(ValueError, match="torchrun"):
        cli.main(["--config", "configs/lstmformer.yaml", "device=cpu",
                  "trainer.mesh_shape=[2, 1]"])


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from multimodalreactiongeneration_tpu_torch.data.dataset import (
        BatchLoader,
    )
    from multimodalreactiongeneration_tpu_torch.train.harness import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Metaformer(MF_CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchLoader(None, np.arange(3), 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(None, None, None, None, {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--config", "configs/lstmformer.yaml", "data_dir=x",
                  "log_dir=x", "ckpt_path=x"])
    model = Metaformer(MF_CFG, device="cpu")
    assert {p.device for p in model.parameters()} == {torch.device("cpu")}
