"""PyTorch port: dropout, gradient accumulation, remat and the CLI's
training options vs the JAX package, on CPU tensors.

  * **Dropout** (``nn/basic.py dropout``): with rate 0.1 the Metaformer
    (LSTM and mha embeddings), lstm_with_sampling (2-layer sampler) and
    simple_lstm (2-layer bidirectional LSTMs) in eval mode give the JAX
    ``deterministic=True`` outputs (atol 1e-5); in training the port
    draws masks at the JAX package's sites: the multiset of mask shapes
    of one training forward equals that of the JAX forward's active
    ``nn.Dropout`` calls (the JAX integrators on the rect-attention
    kernel, ``MRGEN_FUSED_ATTN=force``, as the port's always are). The
    JAX ``TorchMHA`` builds its ``nn.Dropout`` inside ``attend`` and
    ``attend_raw``, methods of a ``setup`` module, so flax raises there in
    training (a JAX-side fault, held by a test below); its three sites
    are read through a stand-in for ``nn.Dropout`` in that module that
    records the shape and passes the context through; the
    fused encoder stack and the stacked LSTM route are taken in eval mode
    or at rate 0 and never with active dropout (JAX's gates); the keep
    rate and the kept value match flax's ``nn.Dropout`` over 10^6 draws;
    two steps from one generator seed give the same bits, another seed
    other bits.
  * **Accumulation** (``train/optim.py MultiSteps``): k 2 over 6 AdamW
    micro-steps (epochs of 3, so one accumulation spans an epoch end)
    with the cosine LR set each epoch, fed the same gradients as
    ``optax.MultiSteps(adamw)``: parameters atol 1e-6 after every
    micro-step, unchanged between updates; a run resumed from a ``last``
    checkpoint saved mid-accumulation equals the unbroken run bit for
    bit; the Metaformer's step functions with k 2 over 4 batches against
    JAX's with ``build_optimizer(accumulate_grad_batches=2)``: per-step
    losses rtol 1e-5, parameters atol 1e-5.
  * **Remat** (``streaming_step_fns(remat=True)``): the step equals the
    plain step bit for bit, at rate 0 and at 0.1 (the recompute draws the
    forward's masks again), and equals JAX's remat step (loss rtol 1e-5,
    parameters atol 1e-5), the Metaformer and lstm_with_sampling.
  * **Trainer and CLI**: ``scheduled_sampling_rate`` in the check and
    epoch records where the JAX loop writes it
    (``tests/test_val_check_interval.py:193``); the training CLI on a
    small lstm_with_sampling run with ``model.use_scheduled_sampling=true``
    (``tests/test_cli.py:118``), dropout, ``accumulate_grad_batches=2``
    and ``remat=true``, and a small lstmformer run with
    ``model.dropout=0.1``.
"""

import functools
import json
import os
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental import pallas as pl

from multimodalreactiongeneration_tpu.models import simple_lstm as jsimple
from multimodalreactiongeneration_tpu.nn import attention as jattention
from multimodalreactiongeneration_tpu.models.lstm_with_sampling import (
    LSTMwithSample as JaxLSTMwithSample,
)
from multimodalreactiongeneration_tpu.models.lstmformer import (
    Metaformer as JaxMetaformer,
)
from multimodalreactiongeneration_tpu.train import harness as jharness
from multimodalreactiongeneration_tpu.train import optim as joptim
from multimodalreactiongeneration_tpu.utils.config import from_dict
from multimodalreactiongeneration_tpu_torch.models import build_model
from multimodalreactiongeneration_tpu_torch.models.weights import (
    state_dict_from_jax,
)
from multimodalreactiongeneration_tpu_torch.nn import basic, mixers, recurrent
from multimodalreactiongeneration_tpu_torch.train import (
    checkpoint as ckpt,
    cli,
    harness,
    optim,
)
from tests.fixtures import make_synthetic_corpus
from tests.test_simple_lstm import CFG as SIMPLE_CFG
from tests.test_streaming_models import LWS_CFG, MF_CFG
from tests.test_torch_port_weights import flat_params, np_batch

torch.set_num_threads(1)
ATOL = 1e-5
P = 0.1
LOSS_CFG = dict(loss_type="huber", loss_reduction="mean", huber_delta=1.0,
                delta_loss_scale=2.0)
METRICS = dict(use_centroid=True, use_angle=True, delta_order=2)
SGD = dict(use_optimizer="sgd", lr=1e-2, weight_decay=1e-3, momentum=0.9)
ADAM = dict(use_optimizer="adam", lr=1e-3, weight_decay=1e-2, momentum=0.9,
            use_lr_sched=True, max_epochs=4)
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

MODELS = {
    # name: (JAX model class, config at rate P, the JAX model's type)
    "lstmformer": (JaxMetaformer, dict(MF_CFG, dropout=P), "lstmformer"),
    "lstmformer_mha": (JaxMetaformer, dict(MF_CFG, dropout=P,
                                           emb_mixers=["mha"] * 3),
                       "lstmformer"),
    "lstm_with_sampling": (
        JaxLSTMwithSample,
        dict(LWS_CFG, sampler_num_layers=2, sampler_dropout_rate=P,
             dropout_rate=P), "lstm_with_sampling"),
    "simple_lstm": (jsimple.SimpleLSTM,
                    dict(SIMPLE_CFG, dropout_rate=P, acostic_num_lstm=2),
                    "simple_lstm"),
}


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


def _inputs(name, seed):
    """The model's forward inputs as numpy arrays."""
    if name == "simple_lstm":
        rng = np.random.default_rng(seed)
        return [rng.standard_normal(s).astype(np.float32)
                for s in ((2, 120, 81), (2, 15, 18))]
    return np_batch(seed, T=4, lead=2)[:6]


def _pair(name, seed, cfg=None):
    """(jax model, jax params, port model, inputs) with the same weights."""
    jcls, default_cfg, model_type = MODELS[name]
    cfg = default_cfg if cfg is None else cfg
    inputs = _inputs(name, seed)
    jm = jcls(cfg=cfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed),
                              *[jnp.asarray(x) for x in inputs])
    pm = build_model(model_type, cfg, device="cpu")
    pm.load_state_dict(state_dict_from_jax(flat_params(params)), strict=True)
    return jm, params, pm, inputs


def _out(y):
    return y[0] if isinstance(y, tuple) else y


# ---- dropout ---------------------------------------------------------------

@pytest.mark.parametrize("name", list(MODELS))
def test_eval_mode_with_dropout_matches_jax_deterministic(name):
    jm, params, pm, inputs = _pair(name, 20)
    want = _out(jm.apply(params, *[jnp.asarray(x) for x in inputs]))
    pm.eval()
    with torch.no_grad():
        got = _out(pm(*[torch.from_numpy(x) for x in inputs]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def _jax_dropout_shapes(jm, params, inputs, monkeypatch):
    """Input shapes of the JAX training forward's active Dropout calls,
    those of ``TorchMHA`` read through a stand-in."""
    shapes = []

    class AttentionDropout:
        def __init__(self, rate):
            self.rate = rate

        def __call__(self, x, deterministic):
            assert not deterministic and self.rate > 0
            shapes.append(tuple(x.shape))
            return x

    stand_in = types.SimpleNamespace(**{
        k: getattr(fnn, k) for k in dir(fnn) if not k.startswith("__")})
    stand_in.Dropout = AttentionDropout
    monkeypatch.setattr(jattention, "nn", stand_in)

    def record(next_fun, args, kwargs, context):
        module = context.module
        if (isinstance(module, fnn.Dropout) and module.rate > 0
                and context.method_name == "__call__"
                and not kwargs.get("deterministic", module.deterministic)):
            shapes.append(tuple(args[0].shape))
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(record):
        jm.apply(params, *[jnp.asarray(x) for x in inputs],
                 deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)})
    return sorted(shapes)


def _port_dropout_shapes(pm, inputs, monkeypatch):
    """Shapes of the masks the port's training forward draws."""
    shapes = []
    rand = torch.rand

    def recording_rand(*args, **kwargs):
        shapes.append(tuple(args[0]))
        return rand(*args, **kwargs)

    pm.train()
    with monkeypatch.context() as m, basic.dropout_rng(0):
        m.setattr(torch, "rand", recording_rand)
        pm(*[torch.from_numpy(x) for x in inputs])
    return sorted(shapes)


@pytest.mark.parametrize("name", list(MODELS))
def test_dropout_sites_match_jax(name, monkeypatch):
    monkeypatch.setenv("MRGEN_FUSED_ATTN", "force")
    jm, params, pm, inputs = _pair(name, 21)
    want = _jax_dropout_shapes(jm, params, inputs, monkeypatch)
    assert want, "the JAX forward applies dropout"
    assert _port_dropout_shapes(pm, inputs, monkeypatch) == want


@pytest.mark.parametrize("name", ["lstmformer", "simple_lstm"])
def test_jax_attention_dropout_raises_in_training(name):
    """The JAX-side fault the port does not share: ``TorchMHA`` creates
    ``nn.Dropout`` in ``attend`` (JAX ``nn/attention.py:205, :221``), so a
    JAX training forward with dropout > 0 through any MHA raises."""
    jm, params, pm, inputs = _pair(name, 22)
    with pytest.raises(Exception, match="must be defined in `setup"):
        jm.apply(params, *[jnp.asarray(x) for x in inputs],
                 deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)})
    pm.train()
    with basic.dropout_rng(0):
        assert torch.isfinite(
            _out(pm(*[torch.from_numpy(x) for x in inputs]))).all()


def test_active_dropout_leaves_the_fused_and_stacked_routes(monkeypatch):
    """JAX's gates: the fused encoder stack and the stacked LSTM run in
    eval mode or at rate 0, never with active dropout."""
    calls = {"stack": 0, "stacked": 0}

    def counting(key, fn):
        def run(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return run

    monkeypatch.setattr(mixers, "mixer_stack_recurrence",
                        counting("stack", mixers.mixer_stack_recurrence))
    monkeypatch.setattr(recurrent, "lstm_stacked_recurrence",
                        counting("stacked", recurrent.lstm_stacked_recurrence))
    long_batch = [torch.from_numpy(x) for x in np_batch(3, T=20, lead=2)[:6]]
    cases = [("lstmformer", "stack"), ("lstm_with_sampling", "stacked")]
    for name, key in cases:
        _, cfg, model_type = MODELS[name]
        for rate, training, taken in ((P, True, False), (P, False, True),
                                      (0.0, True, True)):
            rates = {k: rate for k in ("dropout", "dropout_rate",
                                       "sampler_dropout_rate") if k in cfg}
            pm = build_model(model_type, dict(cfg, **rates), device="cpu")
            pm.train(training)
            before = calls[key]
            with basic.dropout_rng(0):
                pm(*long_batch)
            assert (calls[key] > before) == taken, (name, rate, training)


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_keep_rate_and_scale_match_flax(p):
    shape = (1000, 1000)
    with basic.dropout_rng(0):
        got = basic.dropout(torch.ones(shape), p, training=True).numpy()
    want = np.asarray(fnn.Dropout(p).apply(
        {}, jnp.ones(shape), deterministic=False,
        rngs={"dropout": jax.random.PRNGKey(0)}))
    sigma = (p * (1 - p) / got.size) ** 0.5
    for kept in (got, want):
        assert abs(float((kept != 0).mean()) - (1 - p)) < 5 * sigma
        assert set(np.unique(kept)) == {np.float32(0), np.float32(1 / (1 - p))}
    assert np.unique(got[got != 0])[0] == np.unique(want[want != 0])[0]
    # eval mode, rate 0: the identity; training without a seed raises
    x = torch.ones(3)
    assert basic.dropout(x, p, training=False) is x
    assert basic.dropout(x, 0.0, training=True) is x
    with pytest.raises(RuntimeError, match="dropout_rng"):
        basic.dropout(x, p, training=True)


def _metaformer_step(cfg, state, remat=False, opt_cfg=SGD):
    pm = build_model("lstmformer", cfg, device="cpu")
    pm.load_state_dict(state)
    opt = optim.build_optimizer(pm.parameters(), opt_cfg)
    step, _ = harness.streaming_step_fns(pm, dict(cfg, **LOSS_CFG), METRICS,
                                         opt, True, remat=remat)
    return pm, step


def _torch_batch(data):
    return [(torch.from_numpy(x), None) for x in data]


def test_dropout_steps_are_bit_equal_from_one_seed():
    cfg = MODELS["lstmformer"][1]
    state = build_model("lstmformer", cfg, device="cpu").state_dict()
    batch = _torch_batch(np_batch(4, T=20, lead=4))
    runs = []
    for seed in (5, 5, 6):
        pm, step = _metaformer_step(cfg, state)
        gen = torch.Generator().manual_seed(seed)
        losses = [float(step(batch, gen)[0]) for _ in range(2)]
        runs.append((losses, [p.detach().clone() for p in pm.parameters()]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    assert runs[0][0] != runs[2][0]


# ---- remat -----------------------------------------------------------------

@pytest.mark.parametrize("name", ["lstmformer", "lstm_with_sampling"])
def test_remat_step_matches_plain_and_jax(name):
    jcls, cfg, model_type = MODELS[name]
    rates = {k: 0.0 for k in ("dropout", "dropout_rate",
                              "sampler_dropout_rate") if k in cfg}
    cfg = dict(cfg, **rates, **LOSS_CFG)
    data = np_batch(30, T=4, lead=2)
    jm = jcls(cfg=cfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(31),
                              *[jnp.asarray(x) for x in data[:6]])
    state = state_dict_from_jax(flat_params(params))
    mask_self = model_type == "lstmformer"
    jopt = joptim.build_optimizer(from_dict(SGD))
    jstep, _ = jharness.streaming_step_fns(
        jm, cfg, METRICS, jopt, mask_self_motion_input=mask_self, remat=True)
    jbatch = [(jnp.asarray(x), jnp.zeros(x.shape[0], jnp.int32))
              for x in data]
    jparams, _, jloss, _ = jax.jit(jstep)(params, jopt.init(params), jbatch,
                                          jax.random.PRNGKey(1))
    runs = {}
    for remat in (False, True):
        pm = build_model(model_type, cfg, device="cpu")
        pm.load_state_dict(state)
        opt = optim.build_optimizer(pm.parameters(), SGD)
        step, _ = harness.streaming_step_fns(pm, cfg, METRICS, opt,
                                             mask_self, remat=remat)
        loss, _ = step(_torch_batch(data), torch.Generator().manual_seed(1))
        runs[remat] = (float(loss), pm.state_dict())
    assert runs[True][0] == runs[False][0]
    for key, value in runs[True][1].items():
        assert torch.equal(value, runs[False][1][key]), key
    np.testing.assert_allclose(runs[True][0], float(jloss), rtol=1e-5)
    want = state_dict_from_jax(flat_params(jparams))
    for key, value in runs[True][1].items():
        np.testing.assert_allclose(value.numpy(), want[key].numpy(),
                                   atol=ATOL, err_msg=key)


@pytest.mark.parametrize("name", ["lstmformer", "lstm_with_sampling"])
def test_remat_recompute_reuses_the_dropout_masks(name):
    _, cfg, model_type = MODELS[name]
    cfg = dict(cfg, **LOSS_CFG)
    state = build_model(model_type, cfg, device="cpu").state_dict()
    batch = _torch_batch(np_batch(32, T=20, lead=2))
    runs = {}
    for remat in (False, True):
        pm = build_model(model_type, cfg, device="cpu")
        pm.load_state_dict(state)
        opt = optim.build_optimizer(pm.parameters(), SGD)
        step, _ = harness.streaming_step_fns(
            pm, cfg, METRICS, opt, model_type == "lstmformer", remat=remat)
        loss, _ = step(batch, torch.Generator().manual_seed(2))
        runs[remat] = (float(loss), pm.state_dict())
    assert runs[True][0] == runs[False][0]
    for key, value in runs[True][1].items():
        assert torch.equal(value, runs[False][1][key]), key


# ---- gradient accumulation -------------------------------------------------

SHAPES = {"w": (4, 3), "b": (3,), "v": (5,)}


class _Params(torch.nn.Module):
    def __init__(self, arrays):
        super().__init__()
        for k, a in arrays.items():
            setattr(self, k, torch.nn.Parameter(torch.from_numpy(a.copy())))


def _grads(seed, n):
    rng = np.random.default_rng(seed)
    return [{k: rng.standard_normal(s).astype(np.float32)
             for k, s in SHAPES.items()} for _ in range(n)]


def _port_micro_steps(module, opt, grads, lr_of, start=0):
    """One MultiSteps call per gradient (micro-steps ``start`` on); the
    cosine LR set at each epoch (3 micro-batches) start; the parameters
    after every call."""
    out = []
    for i, g in enumerate(grads, start=start):
        if i % 3 == 0:
            optim.set_learning_rate(opt, lr_of(i // 3))
        for k, p in module.named_parameters():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        out.append({k: p.detach().clone().numpy()
                    for k, p in module.named_parameters()})
    return out


def test_accumulation_matches_optax_multisteps(tmp_path):
    rng = np.random.default_rng(0)
    params0 = {k: rng.standard_normal(s).astype(np.float32)
               for k, s in SHAPES.items()}
    grads = _grads(1, 6)
    lr_of = optim.cosine_annealing(ADAM["lr"], ADAM["max_epochs"])

    jopt = joptim.build_optimizer(from_dict(ADAM), accumulate_grad_batches=2)
    jparams = {k: jnp.asarray(v) for k, v in params0.items()}
    jstate = jopt.init(jparams)
    want = []
    for i, g in enumerate(grads):
        if i % 3 == 0:
            jstate = joptim.set_learning_rate(
                jstate, float(joptim.cosine_annealing(
                    ADAM["lr"], ADAM["max_epochs"])(i // 3)))
        updates, jstate = jopt.update({k: jnp.asarray(v) for k, v in
                                       g.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        want.append({k: np.asarray(v) for k, v in jparams.items()})

    module = _Params(params0)
    opt = optim.build_optimizer(module.parameters(), ADAM,
                                accumulate_grad_batches=2)
    assert isinstance(opt, optim.MultiSteps)
    got = _port_micro_steps(module, opt, grads, lr_of)
    for i, (g, w) in enumerate(zip(got, want)):
        for k in SHAPES:
            np.testing.assert_allclose(g[k], w[k], atol=1e-6,
                                       err_msg=f"micro-step {i} {k}")
    # between updates nothing moves, weight decay included
    for i in (0, 2, 4):
        before = params0 if i == 0 else got[i - 1]
        for k in SHAPES:
            np.testing.assert_array_equal(got[i][k], before[k])
    assert opt.param_groups[0]["lr"] == pytest.approx(lr_of(1))

    # resume from a `last` checkpoint saved after micro-step 3, mid-way
    # through the accumulation that spans the epoch end
    part = _Params(params0)
    popt = optim.build_optimizer(part.parameters(), ADAM,
                                 accumulate_grad_batches=2)
    _port_micro_steps(part, popt, grads[:3], lr_of)
    assert popt.mini_step == 1
    saver = ckpt.TopKCheckpointer(str(tmp_path), top_k=1)
    saver.save_last(ckpt.HostSnapshot(part, popt), 0)
    payload = ckpt.load_checkpoint(str(tmp_path / "last"))
    resumed = _Params(params0)
    resumed.load_state_dict(payload["params"])
    ropt = optim.build_optimizer(resumed.parameters(), ADAM,
                                 accumulate_grad_batches=2)
    assert ckpt.restore_opt_state(payload, ropt) and ropt.mini_step == 1
    tail = _port_micro_steps(resumed, ropt, grads[3:], lr_of, start=3)
    for g, w in zip(tail, got[3:]):
        for k in SHAPES:
            np.testing.assert_array_equal(g[k], w[k])


def test_accumulated_metaformer_steps_match_jax():
    cfg = dict(MF_CFG, **LOSS_CFG)
    batches = [np_batch(60 + i, T=6, lead=2) for i in range(4)]
    jm = JaxMetaformer(cfg=cfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(61),
                              *[jnp.asarray(x) for x in batches[0][:6]])
    jopt = joptim.build_optimizer(from_dict(SGD), accumulate_grad_batches=2)
    jstep, _ = jharness.streaming_step_fns(jm, cfg, METRICS, jopt, True)
    jstep = jax.jit(jstep)
    jstate = jopt.init(params)
    pm = build_model("lstmformer", cfg, device="cpu")
    pm.load_state_dict(state_dict_from_jax(flat_params(params)))
    popt = optim.build_optimizer(pm.parameters(), SGD,
                                 accumulate_grad_batches=2)
    pstep, _ = harness.streaming_step_fns(pm, cfg, METRICS, popt, True)
    for i, data in enumerate(batches):
        jbatch = [(jnp.asarray(x), jnp.zeros(x.shape[0], jnp.int32))
                  for x in data]
        params, jstate, jloss, _ = jstep(params, jstate, jbatch,
                                         jax.random.PRNGKey(i))
        ploss, _ = pstep(_torch_batch(data))
        np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-5,
                                   err_msg=f"step {i}")
    want = state_dict_from_jax(flat_params(params))
    for key, value in pm.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[key].numpy(),
                                   atol=ATOL, err_msg=key)


# ---- the trainer and the CLI -----------------------------------------------

class _Loader:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __iter__(self):
        for _ in range(self.n):
            yield [(np.zeros((1, 2, 18), np.float32), np.array([2]))] * 7


def test_scheduled_sampling_rate_logged(tmp_path):
    """The JAX loop's records (tests/test_val_check_interval.py:193): the
    rate is epoch / scheduled_max_epochs, in every check and epoch
    record; the train step gets the trainer's generator and the rate."""
    seen = []

    def train_step(batch, generator, rate):
        seen.append((generator, rate))
        return torch.zeros(()), {}

    def eval_step(batch):
        return torch.full((), 0.5), {}

    trainer = harness.Trainer(
        None, train_step, eval_step, None,
        dict(lr=1e-3, use_lr_sched=False),
        callbacks_cfg=dict(use_checkpoint=False),
        log_dir=str(tmp_path), scheduled_max_epochs=4,
        val_check_interval=0.5, device="cpu", seed=3)
    trainer.fit(_Loader(4), _Loader(1), max_epochs=2)
    with open(tmp_path / "metrics.jsonl", encoding="utf-8") as f:
        lines = [json.loads(x) for x in f]
    checks = [x for x in lines if "val_check" in x]
    epochs = [x for x in lines if "val_check" not in x]
    assert [c["scheduled_sampling_rate"] for c in checks] == [
        0.0, 0.0, 0.25, 0.25]
    assert [e["scheduled_sampling_rate"] for e in epochs] == [0.0, 0.25]
    assert [r for _, r in seen] == [0.0] * 4 + [0.25] * 4
    assert all(g is trainer.generator for g, _ in seen)


LWS_SMALL = [
    "device=cpu", "hidden_size=32", "bottleneck_size=8", "batch_size=2",
    "optim_epochs=2", "lr=1e-3", "motion.max_len=150", "motion.min_len=50",
    "motion.shift_len=150", "motion.leading_len=24",
    "model.sampler_hidden_size=16", "trainer.run_generation_eval=false",
    "max_epochs=1", "callbacks.save_top_k=1",
]
MF_SMALL = [
    "device=cpu", "hidden_size=32", "bottleneck_size=8", "batch_size=2",
    "optim_epochs=2", "lr=1e-3", "motion.max_len=150", "motion.min_len=50",
    "motion.shift_len=150", "motion.leading_len=24", "model.num_block=1",
    "model.encoder_num_layer=2", "trainer.run_generation_eval=false",
    "max_epochs=1", "callbacks.save_top_k=1",
]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_synthetic_corpus(
        str(tmp_path_factory.mktemp("corpus")), n_sessions=1, seconds=90.0)


@pytest.mark.parametrize("config,overrides", [
    ("lstm_with_sampling", ["model.sampler_num_layers=1",
                            "model.use_scheduled_sampling=true"]),
    ("lstm_with_sampling", ["model.sampler_dropout_rate=0.1",
                            "model.dropout_rate=0.1"]),
    ("lstm_with_sampling", ["trainer.accumulate_grad_batches=2"]),
    ("lstm_with_sampling", ["trainer.remat=true"]),
    ("lstmformer", ["model.dropout=0.1"]),
], ids=["scheduled_sampling", "dropout", "accumulate", "remat",
        "lstmformer_dropout"])
def test_cli_trains_with_the_option(config, overrides, corpus, tmp_path,
                                    monkeypatch):
    monkeypatch.chdir(tmp_path)  # the manifests go under ./data
    small = LWS_SMALL if config == "lstm_with_sampling" else MF_SMALL
    result = cli.main(["--config", os.path.join(ROOT, "configs",
                                                f"{config}.yaml"),
                       "name=run", f"data_dir={corpus}", "ckpt_path=ck",
                       "log_dir=log", *small, *overrides])
    assert result.epochs_run == 1
    rec = result.history[0]
    assert np.isfinite(rec["train_loss"]) and np.isfinite(rec["val_loss"])
    scheduled = "model.use_scheduled_sampling=true" in overrides
    assert ("scheduled_sampling_rate" in rec) == scheduled
    if scheduled:
        assert rec["scheduled_sampling_rate"] == 0.0
    last = torch.load(tmp_path / "ck" / "run" / "last", weights_only=True)
    if "trainer.accumulate_grad_batches=2" in overrides:
        assert last["opt"]["every_k"] == 2 and "inner" in last["opt"]

