"""PyTorch port: the Metaformer's other mixer kinds vs the JAX package, on
CPU tensors.

The mixer settings ``configs/lstmformer.yaml`` exposes beside the
shipped ones: multi-layer and bidirectional recurrent mixers
(``num_internal_layer``, LSTM and GRU), MLP mixers (``emb_mixers`` with
``mlp``) and a layerd's input and output projections. The JAX side runs
as its own tests run it: the modules and the bf16 step under
``MRGEN_RNN_IMPL=pallas`` with the Pallas calls in interpret mode, so
its multi-layer LSTMs take ``lstm_stacked_recurrence`` (K9), its GRUs
``gru_recurrence`` (K10) and its single-layer LSTMs their kernels
direction by direction, as the port's modules route them (on the CPU, to
the plain versions); the f32 Metaformer on its CPU default (the scans,
the recurrences' plain reference; its fused encoder stack and rect
attention in interpret mode). Inputs from a numpy seed; f32 tolerance
``ATOL`` 2e-5 (tests/test_torch_port_train.py's).

  * the bidirectional ``TorchGRU`` (1 and 2 layers), the recurrent mixer
    blocks over kind x inner layers x direction, a recurrent layerd with
    input and output projections (on the fused stack and block by
    block), the MLP mixer block and layerd: forward, the input's and
    every parameter's gradient;
  * the Metaformer at (a) ``num_internal_layer`` 2 and 3 with LSTM
    mixers, (b) GRU mixers at 2 inner layers, and (c) ``emb_mixers``
    [mlp, mlp, lstm] and [lstm, lstm, mlp] (``CFGS``): the forward and
    its states, every parameter's gradient, teacher-forced generation
    (f32 caches; "auto" takes K2's plain version for [mlp, mlp, lstm] in
    both packages, the module loop elsewhere); their training steps,
    f32 and (a)'s bf16, are in tests/test_torch_port_mixer_kinds_train.py;
  * the weight bridges: ``state_dict_from_jax`` loads every tree with
    ``strict=True`` (``paired_models``); reference checkpoints of
    multi-layer recurrent mixers import through the port's tables as
    through JAX's and export back; an MLP-mixer checkpoint is refused by
    both packages' ``convert_checkpoint`` alike (neither maps the MLP
    mixer's Dense layers).

The card side (K9's layer route at hidden 256) is in
tests/test_torch_port_kernels.py.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from multimodalreactiongeneration_tpu.infer.generate import (
    generate_metaformer as jax_generate,
)
from multimodalreactiongeneration_tpu.models import torch_import as jimport
from multimodalreactiongeneration_tpu.nn import mixers as jmix
from multimodalreactiongeneration_tpu.nn.recurrent import (
    TorchGRU as JaxTorchGRU,
)
from multimodalreactiongeneration_tpu_torch.infer import generate as G
from multimodalreactiongeneration_tpu_torch.models import (
    torch_export,
    torch_import,
)
from multimodalreactiongeneration_tpu_torch.models.weights import (
    state_dict_from_jax,
)
from multimodalreactiongeneration_tpu_torch.nn import mixers, recurrent
from tests.test_streaming_models import MF_CFG
from tests.test_torch_port_weights import flat_params, np_batch, paired_models

torch.set_num_threads(1)
ATOL = 2e-5
GEN_ATOL = 2e-5
STEPS = 6

CFGS = {
    "a2": dict(MF_CFG, num_internal_layer=2),
    "a3": dict(MF_CFG, num_internal_layer=3),
    "b": dict(MF_CFG, emb_mixers=["gru"] * 3, num_internal_layer=2),
    "c_mlp_encoders": dict(MF_CFG, emb_mixers=["mlp", "mlp", "lstm"]),
    "c_mlp_main": dict(MF_CFG, emb_mixers=["lstm", "lstm", "mlp"]),
}


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


@pytest.fixture
def kernel_routes(monkeypatch):
    """JAX's recurrences on their Pallas kernels (interpret mode)."""
    monkeypatch.setenv("MRGEN_RNN_IMPL", "pallas")


def _rand(rng, *shape, s=1.0):
    return (s * rng.standard_normal(shape)).astype(np.float32)


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def _check_module(jmod, port, inputs, n_states=0):
    """``jmod`` (flax, its params initialized here) and ``port`` (the same
    structure) on the same ``inputs`` (numpy; the first is x, the next
    ``n_states`` the initial state's arrays, as one tuple when two):
    outputs and new states within ATOL, then the gradients of a random
    projection of every output with respect to x and every parameter."""
    def state(arrays):  # no state argument, an array, or a pair
        return (() if n_states == 0 else
                (arrays[0],) if n_states == 1 else (tuple(arrays),))

    x = jnp.asarray(inputs[0])
    hx = state([jnp.asarray(a) for a in inputs[1:]])
    params = jmod.init(jax.random.PRNGKey(0), x, *hx)
    port.load_state_dict(state_dict_from_jax(flat_params(params)),
                         strict=True)
    outs = _leaves(jmod.apply(params, x, *hx))
    rng = np.random.default_rng(7)
    cots = [_rand(rng, *np.shape(o)) for o in outs]

    def loss(p, xx):
        return sum(jnp.sum(o * c) for o, c in zip(
            _leaves(jmod.apply(p, xx, *hx)), cots))

    gp, gx = jax.grad(loss, argnums=(0, 1))(params, x)

    xt = torch.from_numpy(np.asarray(inputs[0])).requires_grad_()
    phx = state([torch.from_numpy(np.asarray(a)) for a in inputs[1:]])
    pouts = [o for o in _flatten(port(xt, *phx)) if o is not None]
    assert len(pouts) == len(outs)
    for got, want in zip(pouts, outs):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=ATOL)
    torch.autograd.backward(pouts, [torch.from_numpy(c) for c in cots])
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=ATOL)
    want = state_dict_from_jax(flat_params(gp))
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=ATOL, err_msg=name)


def _flatten(x):
    if isinstance(x, dict):
        return [y for k in sorted(x) for y in _flatten(x[k])]
    if isinstance(x, (tuple, list)):
        return [y for z in x for y in _flatten(z)]
    return [x]


# ---- the modules ---------------------------------------------------------

@pytest.mark.parametrize("layers", [1, 2])
def test_bidirectional_torchgru_matches_jax(layers, kernel_routes):
    """T 20: JAX's Pallas branch (K10 on the flipped sequence for the
    reverse direction) and the port's route, from a given state."""
    b, t, din, h = 3, 20, 24, 16
    rng = np.random.default_rng(layers)
    port = recurrent.TorchGRU(din, h, torch.Generator().manual_seed(0),
                              num_layers=layers, bidirectional=True)
    assert [n for n, _ in port.named_parameters()][4:8] == [
        "weight_ih_l0_reverse", "weight_hh_l0_reverse",
        "bias_ih_l0_reverse", "bias_hh_l0_reverse"]
    _check_module(
        JaxTorchGRU(input_size=din, hidden_size=h, num_layers=layers,
                    bidirectional=True),
        port, [_rand(rng, b, t, din, s=0.5),
               _rand(rng, 2 * layers, b, h, s=0.3)], n_states=1)
    y, hn = port(torch.zeros(b, t, din))
    assert y.shape == (b, t, 2 * h) and hn.shape == (2 * layers, b, h)


@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_recurrent_mixer_block_matches_jax(kind, layers, bidirectional,
                                          kernel_routes):
    """Hidden 32 (16 a direction when bidirectional), T 20: a 2-layer
    unidirectional LSTM takes K9, every other stack layer by layer and
    direction by direction; residual with LayerNorm and a bottleneck
    FFN, from a given state."""
    h, b, t = 32, 3, 20
    cfg = dict(hidden_size=h, kind=kind, num_layers=layers,
               bidirectional=bidirectional, residual=True,
               residual_layer_norm=True, bottleneck_size=8)
    port = mixers.RecurrentMixerBlock(
        generator=torch.Generator().manual_seed(0), **cfg)
    assert port.mixer.hidden_size == (h // 2 if bidirectional else h)
    n = layers * (2 if bidirectional else 1)
    hh = h // 2 if bidirectional else h
    rng = np.random.default_rng(layers + 10 * bidirectional)
    state = [_rand(rng, n, b, hh, s=0.3)
             for _ in range(2 if kind == "lstm" else 1)]
    _check_module(jmix.RecurrentMixerBlock(**cfg), port,
                  [_rand(rng, b, t, h, s=0.5), *state], n_states=len(state))


@pytest.mark.parametrize("kind,inner", [("lstm", 1), ("lstm", 2),
                                        ("gru", 2)])
def test_recurrent_layerd_projections_match_jax(kind, inner,
                                                kernel_routes):
    """Two blocks behind an ``input_projection`` (24 features -> 32) and
    before an ``output_projection`` (32 -> 12): single-layer LSTM blocks
    take the fused stack (K3/K4's plain version), the others run block by
    block."""
    h, b, t = 32, 2, 18
    cfg = dict(hidden_size=h, num_layerd=2, num_internal_layer=inner,
               input_projection_size=24, output_projection_size=12,
               residual=True, residual_layer_norm=True, bottleneck_size=8)
    port = mixers.RecurrentMixerLayerd(
        kind=kind, generator=torch.Generator().manual_seed(0), **cfg)
    x = _rand(np.random.default_rng(inner), b, t, 24, s=0.5)
    _check_module(jmix.RecurrentMixerLayerd(kind=kind, **cfg), port, [x])
    y, states = port(torch.from_numpy(x))
    assert y.shape == (b, t, 12) and len(states) == 2


@pytest.mark.parametrize("nonlinearity", ["none", "relu"])
@pytest.mark.parametrize("num_layer", [1, 3])
def test_mlp_mixers_match_jax(num_layer, nonlinearity):
    """``MLPMixerBlock`` (Dense ``input``, ``hidden_{i}``, ``output``,
    residual LayerNorm, FFN) alone and in a 2-block ``MLPMixerLayerd``
    with projections, which returns no state."""
    h, b, t = 32, 2, 7
    common = dict(hidden_size=h, nonlinearity=nonlinearity, residual=True,
                  residual_layer_norm=True, bottleneck_size=8)
    rng = np.random.default_rng(num_layer)
    x = _rand(rng, b, t, h, s=0.5)

    block = mixers.MLPMixerBlock(generator=torch.Generator().manual_seed(0),
                                 num_layer=num_layer, **common)
    _check_module(jmix.MLPMixerBlock(num_layer=num_layer, **common), block,
                  [x])
    names = [n for n, _ in block.named_parameters()]
    assert names[:2] == ["input.weight", "input.bias"]
    assert ("hidden_2.weight" in names) == (num_layer == 3)
    cfg = dict(common, num_layerd=2, num_internal_layer=num_layer,
               input_projection_size=20, output_projection_size=10)
    port = mixers.build_mixer_layerd(
        "mlp", cfg, torch.Generator().manual_seed(0))
    x = _rand(rng, b, t, 20, s=0.5)
    _check_module(jmix.MLPMixerLayerd(**cfg), port, [x])
    y, state = port(torch.from_numpy(x))
    assert y.shape == (b, t, 10) and state is None


# ---- the Metaformer ------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    """(JAX module, JAX params, port model, batch) per config."""
    out = {}
    batch = np_batch(40, T=STEPS, lead=2)
    for name, cfg in CFGS.items():
        out[name] = (*paired_models(cfg, 41, batch), batch)
    return out


@pytest.mark.parametrize("name", list(CFGS))
def test_metaformer_forward_and_gradients_match_jax(models, name):
    """T 24 + lead 4 (224 audio steps, 28 motion steps: the kernel
    routes); the states (per block: (h, c) or h of every inner layer, or
    None for an MLP embedding) and every parameter's gradient."""
    jm, params, pm, _ = models[name]
    batch = np_batch(42, T=24, lead=4)
    jx = [jnp.asarray(x) for x in batch[:6]]
    y, states = jm.apply(params, *jx)
    rng = np.random.default_rng(43)
    cot = _rand(rng, *y.shape)

    def loss(p):
        return jnp.sum(jm.apply(p, *jx)[0] * cot)

    with jax.default_matmul_precision("highest"):
        gp = jax.grad(loss)(params)
    pm.zero_grad()
    py, pstates = pm(*[torch.from_numpy(x) for x in batch[:6]])
    np.testing.assert_allclose(py.detach().numpy(), np.asarray(y), atol=ATOL)
    assert len(_flatten(pstates)) == len(_flatten(states))
    for got, want in zip(_flatten(pstates), _flatten(states)):
        if want is None:
            assert got is None
            continue
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=ATOL)
    (py * torch.from_numpy(cot)).sum().backward()
    want = state_dict_from_jax(flat_params(gp))
    for pname, p in pm.named_parameters():
        assert p.grad is not None, pname
        np.testing.assert_allclose(p.grad.numpy(), want[pname].numpy(),
                                   atol=ATOL, err_msg=pname)


@pytest.mark.parametrize("name", list(CFGS))
def test_metaformer_generation_matches_jax(models, name):
    """Teacher-forced, f32 caches, the hoisted shared layout: recurrent
    and MLP embeddings start from None states; "auto" takes the fused
    rollout (K2's plain version) only where both packages' gate says so
    ([mlp, mlp, lstm]: an LSTM main mixer of one inner layer)."""
    jm, params, pm, batch = models[name]
    mask = np.zeros(STEPS, bool)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_generate(
            jm, params, tuple(jnp.asarray(x) for x in batch),
            jnp.asarray(mask), cache_dtype=jnp.float32, kv_layout="shared"))
    fused = G._fused_rollout_supported(CFGS[name], torch.float32, 8, 16)
    assert fused == (name == "c_mlp_encoders")
    got = G.generate_metaformer(pm, [torch.from_numpy(x) for x in batch],
                                torch.from_numpy(mask),
                                cache_dtype=torch.float32)
    assert got.shape == want.shape == (2, STEPS, 18)
    np.testing.assert_allclose(got.numpy(), want, atol=GEN_ATOL)


# ---- the weight bridges ----------------------------------------------------

@pytest.mark.parametrize("name", ["a2", "a3", "b"])
def test_reference_checkpoints_of_multilayer_mixers_round_trip(models, name,
                                                               tmp_path):
    """The port's export writes every ``weight_*_l{k}`` leaf under the
    reference names; both packages' importers map it back to the same
    tree, and ``convert_checkpoint`` loads it strictly."""
    _, params, pm, _ = models[name]
    cfg = CFGS[name]
    ref = torch_export.export_torch_state_dict(
        pm.state_dict(), torch_import.metaformer_name_map(cfg))
    assert any("weight_hh_l1" in k for k in ref)
    got = torch_import.convert_checkpoint("lstmformer", cfg, ref,
                                          str(tmp_path))
    jtree = jimport.import_metaformer_state_dict(
        {k: v.numpy() for k, v in ref.items()}, cfg)
    want = state_dict_from_jax(flat_params({"params": jtree}))
    assert set(got) == set(want) == set(pm.state_dict())
    for k, v in pm.state_dict().items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)
        torch.testing.assert_close(want[k], v, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["c_mlp_encoders", "c_mlp_main"])
def test_mlp_checkpoints_are_refused_as_jax_refuses_them(models, name,
                                                         tmp_path):
    """The reference names map no MLP mixer Dense layer in either
    package: a checkpoint of every parameter the tables name leaves the
    MLP mixers' ``input`` / ``output`` out, and both ``convert_checkpoint``
    refuse it; the port's export refuses the model too."""
    _, _, pm, _ = models[name]
    cfg = CFGS[name]
    table = torch_import.metaformer_name_map(cfg)
    assert table == jimport.metaformer_name_map(cfg)
    sd = pm.state_dict()
    mlp = [k for k in sd if re.search(
        r"\.emb_\d+\.block_\d+\.(input|hidden_\d+|output)\.", k)]
    assert mlp
    with pytest.raises(ValueError, match="no reference mapping"):
        torch_export.export_torch_state_dict(sd, table)
    ref = torch_export.export_torch_state_dict(
        {k: v for k, v in sd.items() if k not in mlp}, table)
    with pytest.raises(ValueError, match="does not match the model"):
        torch_import.convert_checkpoint("lstmformer", cfg, ref,
                                        str(tmp_path / "port"))
    with pytest.raises(ValueError, match="does not match the model"):
        jimport.convert_checkpoint(
            "lstmformer", cfg, {k: v.numpy() for k, v in ref.items()},
            str(tmp_path / "jax"))
