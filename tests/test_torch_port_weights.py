"""PyTorch port: weight bridge, model config, and no-JAX imports.

Also holds the helpers the other ``test_torch_port_*`` files share: a
JAX Metaformer and the port's Metaformer with the same weights, and
seeded numpy inputs in the shapes of ``tests/test_generate.py``.
"""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from multimodalreactiongeneration_tpu.models.lstmformer import (
    Metaformer as JaxMetaformer,
)
from multimodalreactiongeneration_tpu_torch.configs import LSTMFORMER_MODEL_CFG
from multimodalreactiongeneration_tpu_torch.models.lstmformer import (
    Metaformer as PortMetaformer,
)
from multimodalreactiongeneration_tpu_torch.models.weights import (
    state_dict_from_jax,
)
from tests.test_streaming_models import MF_CFG

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "multimodalreactiongeneration_tpu_torch"


def np_batch(seed, T=6, lead=2, ratio=8, B=2):
    """The 7-tuple of tests/test_generate.py:_full_batch, from numpy."""
    rng = np.random.default_rng(seed)
    shapes = [(B, T * ratio, 81), (B, T, 18), (B, T, 18),
              (B, lead * ratio, 81), (B, lead, 18), (B, lead, 18),
              (B, T, 18)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def flat_params(params):
    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(params).items()}


def paired_models(cfg, seed, batch):
    """(jax model, jax params, port model) holding the same weights."""
    jm = JaxMetaformer(cfg=cfg)
    params = jax.jit(jm.init)(
        jax.random.PRNGKey(seed), *[jnp.asarray(x) for x in batch[:6]]
    )
    pm = PortMetaformer(cfg, device="cpu")
    pm.load_state_dict(state_dict_from_jax(flat_params(params)), strict=True)
    return jm, params, pm


def test_converter_maps_every_leaf_and_loads_strict():
    batch = np_batch(0)
    jm = JaxMetaformer(cfg=MF_CFG)
    params = jm.init(jax.random.PRNGKey(0), *[jnp.asarray(x) for x in batch[:6]])
    flat = flat_params(params)
    sd = state_dict_from_jax(flat)
    pm = PortMetaformer(MF_CFG, device="cpu")
    assert set(sd) == set(pm.state_dict())
    assert len(sd) == len(flat)
    pm.load_state_dict(sd, strict=True)
    # Dense kernels are transposed into torch layout, LayerNorm scale is
    # the weight, LSTM/MHA leaves keep their layout
    mf = flat["params/metaformer/block_0/cat_linear/kernel"]
    np.testing.assert_array_equal(
        pm.metaformer.block_0.cat_linear.weight.detach().numpy(), mf.T
    )
    ln = flat["params/metaformer/block_1/feed_forward/LayerNorm_0/scale"]
    np.testing.assert_array_equal(
        pm.metaformer.block_1.feed_forward.LayerNorm_0.weight.detach().numpy(),
        ln,
    )
    w = flat["params/metaformer/block_0/emb_1/block_1/mixer/weight_hh_l0"]
    np.testing.assert_array_equal(
        pm.metaformer.block_0.emb_1.block_1.mixer.weight_hh_l0.detach()
        .numpy(), w,
    )


def test_converter_raises_on_unmapped_leaf():
    with pytest.raises(KeyError, match="no mapping"):
        state_dict_from_jax({"params/metaformer/x/embedding": np.zeros(3)})


def test_port_init_is_distribution_matched():
    """Same parameter names and shapes as the JAX init, drawn from the
    same families (checked by the spread of each kind of leaf)."""
    batch = np_batch(1)
    jm = JaxMetaformer(cfg=MF_CFG)
    flat = flat_params(
        jm.init(jax.random.PRNGKey(1), *[jnp.asarray(x) for x in batch[:6]])
    )
    ref = state_dict_from_jax(flat)
    sd = PortMetaformer(MF_CFG, generator=torch.Generator().manual_seed(1),
                        device="cpu").state_dict()
    for name, t in sd.items():
        assert t.shape == ref[name].shape, name
        r = ref[name]
        if float(r.std()) == 0.0:
            assert torch.equal(t, r), name  # zeros / ones
        else:
            ratio = float(t.std()) / float(r.std())
            assert 0.75 < ratio < 1.33, (name, ratio)


def _bench_cfg():
    tree = ast.parse((ROOT / "bench.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
            getattr(t, "id", None) == "BENCH_CFG" for t in node.targets
        ):
            return {kw.arg: ast.literal_eval(kw.value)
                    for kw in node.value.keywords}
    raise AssertionError("BENCH_CFG not found in bench.py")


def test_model_config_matches_bench_and_yaml():
    from multimodalreactiongeneration_tpu.utils.config import load_config

    assert LSTMFORMER_MODEL_CFG == _bench_cfg()
    model = load_config(str(ROOT / "configs" / "lstmformer.yaml"))["model"]
    for key, value in LSTMFORMER_MODEL_CFG.items():
        got = model[key]
        got = list(got) if isinstance(got, (list, tuple)) else got
        assert got == value, (key, got, value)


_BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "yaml",
            "multimodalreactiongeneration_tpu")


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_sources_name_no_jax_in_imports():
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in _BLOCKED, f"{path}: imports {name}"


def test_port_imports_with_jax_blocked():
    mods = ["multimodalreactiongeneration_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(
            [str(PORT)], prefix="multimodalreactiongeneration_tpu_torch."
        )
    ]
    code = (
        "import sys\n"
        f"for name in {list(_BLOCKED)!r}:\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "print('ok', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.startswith("ok")
    assert len(mods) >= 14


def test_chip_smoke_refuses_without_a_card():
    """No CUDA device: non-zero exit and no result line."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
