"""PyTorch port: every head count and hidden size up to 256 on K5/K6, K8,
K10 and K9's layer route, on CPU tensors against the JAX package.

The kernels are built for head dims 16, 32, 64, 128 and 256
(``ops/rect_attention.py HEAD_DIMS``) and hidden sizes 64, 128, 192 and
256 (``ops/hidden_pad.py HIDDEN_SIZES``); their wrappers run any other
head dim or hidden size up to 256 on the next of them, padded with zeros.
The JAX kernels take any size (they pad time and keys only). Here:

  * the padding transforms as functions of their own, for heads (head
    dims 12 -> 16, 24 -> 32, 48 -> 64) and hidden sizes (48 -> 64, 100 ->
    128, 160 -> 192; K8, K10 and K9 at 2 layers): pad -> plain version ->
    unpad equals the plain version at the real size, forward and every
    input gradient, within 1e-6 in f32, abs up to magnitude 1 and of the
    largest magnitude past it (the same sums over zeros more, in another
    blocking: an f32 ulp of a value past 8 is itself 1e-6); and equals the JAX kernel at the real
    size, its Pallas calls in interpret mode, at the JAX tests' bounds
    (forward 1e-5, gradients 2e-4);
  * the bf16 mode the same way, at T 16 (attention: Lq 12, Lk 40). The
    padded and the unpadded plain bf16 versions round the same operands
    to bf16 and sum in f32 in other orders, so an h, a dgate or a weight
    on a bf16 rounding boundary may round the other way in one (K9 at H
    100: its bf16 dW 1.1e-3 of their largest): they are held to the
    bounds chip_smoke.py holds a bf16 mode to its plain version at T 16
    (``BF16_SHORT_TOL``): outputs 1e-3 abs, the f32 gradients 2e-3 and
    the bf16 ones 1e-2 of their largest magnitude (a bf16 ulp is 2^-8 to
    2^-7 of a value), each gradient in the reference's dtype. Against
    JAX's bf16 kernel, compiled with ``xla_allow_excess_precision`` off:
    attention to the same bounds; the chains, where from H 100 on such
    flips compound within 16 steps (the plain K8 against JAX at H 160:
    dh0 2.4e-3 of its largest, unpadded as padded), to the JAX package's
    bf16 bounds, as tests/test_torch_port_bf16_recurrence.py past T 16
    (tests/test_pallas_lstm.py:130: 5e-2 abs on outputs, states and f32
    gradients, 0.3 on the bf16 dW);
  * the GRU Metaformer at hidden 48, 4 heads (head dim 12), lstm_with_
    sampling at hidden 48, sampler 48, and simple_lstm with 48-wide
    LSTMs against the JAX package (its recurrences and rect attention on
    their Pallas routes in interpret mode): the weight bridge with
    ``strict=True``, the forward, every parameter's gradient and a
    teacher-forced generation, at the bounds of
    tests/test_torch_port_gru.py / _lws.py / _simple_lstm.py; once on the
    plain versions, once with each plain version run through the
    wrappers' padding (the sizes the card runs);
  * the routes with device type "cuda": ``single_layer_route``,
    ``use_gru_kernel``, ``use_lstm_stacked``, ``ops/lstm_stacked.route``
    and K5/K6's ``kernel_refusal`` take every H and head dim up to 256,
    and raise (or refuse), naming the kernel, at H 384 and head dim 512.

The CUDA kernels at these shapes are held to their plain versions on the
card in tests/test_torch_port_kernels.py and chip_smoke.py phase 40.
"""

import contextlib
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from multimodalreactiongeneration_tpu.infer.generate import (
    generate_lws as jax_generate_lws,
)
from multimodalreactiongeneration_tpu.infer.generate import (
    generate_metaformer as jax_generate,
)
from multimodalreactiongeneration_tpu.models import simple_lstm as jsimple
from multimodalreactiongeneration_tpu.models.lstm_with_sampling import (
    LSTMwithSample as JaxLSTMwithSample,
)
from multimodalreactiongeneration_tpu.models.lstmformer import (
    Metaformer as JaxMetaformer,
)
from multimodalreactiongeneration_tpu.ops import (
    pallas_gru,
    pallas_lstm,
    pallas_lstm_stacked,
)
from multimodalreactiongeneration_tpu.ops import pallas_rect_attention as jra
from multimodalreactiongeneration_tpu_torch.infer import generate as G
from multimodalreactiongeneration_tpu_torch.models import simple_lstm
from multimodalreactiongeneration_tpu_torch.models.lstm_with_sampling import (
    LSTMwithSample,
)
from multimodalreactiongeneration_tpu_torch.models.lstmformer import Metaformer
from multimodalreactiongeneration_tpu_torch.models.weights import (
    state_dict_from_jax,
)
from multimodalreactiongeneration_tpu_torch.nn import recurrent
from multimodalreactiongeneration_tpu_torch.ops import gru as K10
from multimodalreactiongeneration_tpu_torch.ops import hidden_pad
from multimodalreactiongeneration_tpu_torch.ops import lstm_recurrence as K8
from multimodalreactiongeneration_tpu_torch.ops import lstm_stacked as K9
from multimodalreactiongeneration_tpu_torch.ops import rect_attention as K5
from tests.test_simple_lstm import CFG as SIMPLE_CFG
from tests.test_simple_lstm import METRICS as SIMPLE_METRICS
from tests.test_streaming_models import LWS_CFG, MF_CFG
from tests.test_torch_port_weights import flat_params, np_batch

torch.set_num_threads(1)
BF = torch.bfloat16
PAD_TOL = 1e-6            # pad -> plain -> unpad against plain, f32
FWD_ATOL, GRAD_ATOL = 1e-5, 2e-4  # against the JAX kernels, f32
BF16_TOL = (1e-3, 2e-3, 1e-2)    # bf16 (T 16): chip_smoke.BF16_SHORT_TOL
HEAD_CASES = [(2, 12, 16), (2, 24, 32), (1, 48, 64)]  # heads, d, tile
HIDDEN_CASES = [(48, 64), (100, 128), (160, 192)]     # H, the H it runs


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


def _np(x):
    """A JAX array or a torch tensor as f32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _torch(x):
    """A JAX array as a torch tensor of the same dtype (f32 or bf16)."""
    t = torch.from_numpy(np.array(_np(x)))
    return t.to(BF) if x.dtype == jnp.bfloat16 else t


def _flatten(out):
    """(ys, hn), (ys, (hn, cn)) or a context as a flat tuple."""
    if not isinstance(out, tuple):
        return (out,)
    ys, state = out
    return (ys, *state) if isinstance(state, tuple) else (ys, state)


def _grads(fn, leaves, cots):
    """fn's flat outputs (detached) and the gradients of all leaves."""
    leaves = [x.detach().clone().requires_grad_() for x in leaves]
    outs = _flatten(fn(*leaves))
    grads = torch.autograd.grad(outs, leaves, [torch.from_numpy(c)
                                               for c in cots])
    return [o.detach() for o in outs], grads


def _jax_vjp(fn, jargs, cots):
    """fn's flat outputs and the gradients of all its arguments under
    ``cots``, compiled with ``xla_allow_excess_precision`` off (XLA keeps
    no f32 where the program says bf16)."""
    def both(*a):
        outs, vjp = jax.vjp(lambda *x: _flatten(fn(*x)), *a)
        return outs, vjp(tuple(jnp.asarray(c) for c in cots))

    compiled = jax.jit(both).lower(*jargs).compile(
        compiler_options={"xla_allow_excess_precision": False})
    return compiled(*jargs)


def _close_padded(got, want):
    """pad -> plain -> unpad against plain, f32: within PAD_TOL, abs up
    to magnitude 1, of the largest magnitude past it."""
    for i, (a, b) in enumerate(zip(got, want)):
        scale = max(1.0, float(b.abs().max()))
        np.testing.assert_allclose(a.numpy(), b.numpy(),
                                   atol=PAD_TOL * scale, err_msg=str(i))


def _close_bf16(got, want, grads, want_grads):
    """The bf16 bounds (``BF16_TOL``): outputs abs; f32 and bf16
    gradients of their largest magnitude; each gradient in the
    reference's dtype."""
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(), _np(w),
                                   atol=BF16_TOL[0])
    for i, (g, w) in enumerate(zip(grads, want_grads)):
        assert str(g.dtype).split(".")[-1] == str(w.dtype).split(".")[-1], i
        err = np.abs(g.float().numpy() - _np(w)).max()
        limit = BF16_TOL[2 if g.dtype == BF else 1] * np.abs(_np(w)).max()
        assert err <= limit, (i, err, limit)


def _close_jax_chain_bf16(got, want, grads, want_grads):
    """The JAX package's bf16 bounds of a chain: outputs, states and f32
    gradients 5e-2 abs, the bf16 dW 0.3 abs; each gradient in JAX's
    dtype."""
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(), _np(w), atol=5e-2)
    for i, (g, w) in enumerate(zip(grads, want_grads)):
        assert str(g.dtype).split(".")[-1] == str(w.dtype), i
        np.testing.assert_allclose(g.float().numpy(), _np(w),
                                   atol=0.3 if g.dtype == BF else 5e-2,
                                   err_msg=str(i))


# ---- K5/K6: head dims -----------------------------------------------------

def _attn_inputs(seed, heads, d, lq=12, lk=40, b=2):
    rng = np.random.default_rng(seed)
    e = heads * d
    q, k, v, g = [rng.standard_normal(s).astype(np.float32)
                  for s in ((b, lq, e), (b, lk, e), (b, lk, e), (b, lq, e))]
    return (q, k, v, rng.random((b, lq)) < 0.1, rng.random((b, lk)) < 0.1,
            g)


def _padded_attention(plain, heads, d):
    """What the wrappers run on the card at head dim d: q, k and v padded
    to the tile, the plain version there with the scale of d, the context
    cut back."""
    dp = K5.padded_head_dim(d)

    def run(q, k, v, q_pad, k_pad):
        out = plain(heads, *(K5.pad_heads(x, heads, dp) for x in (q, k, v)),
                    q_pad, k_pad, scale=1.0 / math.sqrt(d))
        return K5.unpad_heads(out, heads, d)
    return run


def test_pad_heads_places_each_head_and_unpads_exactly():
    x = torch.arange(2 * 3 * 6, dtype=torch.float32).view(2, 3, 6)
    p = K5.pad_heads(x, 2, 4)
    assert p.shape == (2, 3, 8)
    torch.testing.assert_close(p.view(2, 3, 2, 4)[..., :3],
                               x.view(2, 3, 2, 3), rtol=0, atol=0)
    assert not p.view(2, 3, 2, 4)[..., 3:].any()
    assert torch.equal(K5.unpad_heads(p, 2, 3), x)
    assert K5.pad_heads(x, 2, 3) is x
    assert [K5.padded_head_dim(d) for d in (1, 12, 16, 17, 48, 96, 129, 256,
                                            257)] == [16, 16, 16, 32, 64,
                                                      128, 256, 256, None]


@pytest.mark.parametrize("heads,d,tile", HEAD_CASES)
def test_head_padding_f32_is_exact_and_matches_jax(heads, d, tile):
    q, k, v, q_pad, k_pad, g = _attn_inputs(d, heads, d)
    assert K5.padded_head_dim(d) == tile
    pads = (torch.from_numpy(q_pad), torch.from_numpy(k_pad))
    leaves = [torch.from_numpy(x) for x in (q, k, v)]
    want, wgrads = _grads(
        lambda *x: K5.rect_attention_reference(heads, *x, *pads), leaves, [g])
    padded = _padded_attention(K5.rect_attention_reference, heads, d)
    got, grads = _grads(lambda *x: padded(*x, *pads), leaves, [g])
    _close_padded(got + list(grads), want + list(wgrads))
    jout, jgrads = jax.vjp(
        lambda a, b, c: jra.rect_attention(heads, a, b, c, jnp.asarray(q_pad),
                                           jnp.asarray(k_pad)),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jout),
                               atol=FWD_ATOL)
    for a, w, name in zip(grads, jgrads(jnp.asarray(g)), "qkv"):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=GRAD_ATOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("heads,d,tile", HEAD_CASES)
def test_head_padding_bf16_matches_plain_and_jax(heads, d, tile):
    q, k, v, q_pad, k_pad, g = _attn_inputs(d + 1, heads, d)
    jargs = [jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)]
    pads = (torch.from_numpy(q_pad), torch.from_numpy(k_pad))
    leaves = [_torch(x) for x in jargs]
    want, wgrads = _grads(
        lambda *x: K5.rect_attention_bf16_reference(heads, *x, *pads),
        leaves, [g])
    padded = _padded_attention(K5.rect_attention_bf16_reference, heads, d)
    got, grads = _grads(lambda *x: padded(*x, *pads), leaves, [g])
    _close_bf16(got, want, grads, wgrads)
    jout, jgrads = _jax_vjp(
        lambda a, b, c: jra.rect_attention(heads, a, b, c, jnp.asarray(q_pad),
                                           jnp.asarray(k_pad)), jargs, [g])
    _close_bf16(got, jout, grads, jgrads)


# ---- K8, K10, K9: hidden sizes --------------------------------------------

RECURRENCES = {  # port module, JAX kernel, entry point, gates, scales
    "lstm": (K8, pallas_lstm.lstm_recurrence, "lstm_recurrence_reference"),
    "gru": (K10, pallas_gru.gru_recurrence, "gru_recurrence_reference"),
    "stacked": (K9, pallas_lstm_stacked.lstm_stacked_recurrence,
                "lstm_stacked_reference"),
}


def _rec_inputs(kind, seed, h, b=3, t=16, layers=2):
    """Numpy arguments and cotangents of a recurrence at hidden size h."""
    rng = np.random.default_rng(seed)

    def r(*shape, s=1.0):
        return (s * rng.standard_normal(shape)).astype(np.float32)

    if kind == "gru":
        args = [r(b, t, 3 * h, s=0.5), r(h, 3 * h, s=0.2), r(3 * h, s=0.1),
                r(b, h, s=0.3)]
        cots = [r(b, t, h), r(b, h)]
    elif kind == "lstm":
        args = [r(b, t, 4 * h, s=0.5), r(h, 4 * h, s=0.2), r(b, h, s=0.3),
                r(b, h, s=0.3)]
        cots = [r(b, t, h), r(b, h), r(b, h)]
    else:
        args = [r(b, t, 4 * h, s=0.5), r(layers - 1, h, 4 * h, s=0.1),
                r(layers - 1, 4 * h, s=0.1), r(layers, h, 4 * h, s=0.1),
                r(layers, b, h, s=0.3), r(layers, b, h, s=0.3)]
        cots = [r(b, t, h), r(layers, b, h), r(layers, b, h)]
    return args, cots


def _weights(kind):
    """The indices of a recurrence's weights (bf16 in the bf16 mode)."""
    return {"gru": (1,), "lstm": (1,), "stacked": (1, 3)}[kind]


def _padded_recurrence(kind, reference, h):
    """What the wrappers run on the card at hidden size h: the arguments
    padded to ``padded_hidden(h)``, ``reference`` there, the outputs cut
    back."""
    mod = RECURRENCES[kind][0]
    hp = hidden_pad.padded_hidden(h)

    def run(*args):
        out = _flatten(reference(*mod.pad_args(args, hp)))
        ys, *state = (hidden_pad.unpad_units(x, h) for x in out)
        return (ys, state[0]) if kind == "gru" else (ys, tuple(state))
    return run


@pytest.mark.parametrize("kind", sorted(RECURRENCES))
@pytest.mark.parametrize("h,hp", HIDDEN_CASES)
def test_hidden_padding_f32_is_exact_and_matches_jax(kind, h, hp):
    mod, jfn, name = RECURRENCES[kind]
    reference = getattr(mod, name)
    assert hidden_pad.padded_hidden(h) == hp
    args, cots = _rec_inputs(kind, h, h, t=20)
    leaves = [torch.from_numpy(a) for a in args]
    want, wgrads = _grads(reference, leaves, cots)
    got, grads = _grads(_padded_recurrence(kind, reference, h), leaves, cots)
    _close_padded(got + list(grads), want + list(wgrads))
    jargs = [jnp.asarray(a) for a in args]
    jout, vjp = jax.vjp(lambda *a: _flatten(jfn(*a)), *jargs)
    for a, w in zip(got, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=FWD_ATOL)
    for i, (a, w) in enumerate(zip(grads, vjp(tuple(
            jnp.asarray(c) for c in cots)))):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=GRAD_ATOL,
                                   err_msg=str(i))


@pytest.mark.parametrize("kind", sorted(RECURRENCES))
@pytest.mark.parametrize("h,hp", HIDDEN_CASES)
def test_hidden_padding_bf16_matches_plain_and_jax(kind, h, hp):
    mod, jfn, name = RECURRENCES[kind]
    reference = getattr(mod, name)
    args, cots = _rec_inputs(kind, h + 1, h)
    jargs = [jnp.asarray(a) for a in args]
    for i in _weights(kind):
        jargs[i] = jargs[i].astype(jnp.bfloat16)
    leaves = [_torch(a) for a in jargs]
    want, wgrads = _grads(reference, leaves, cots)
    got, grads = _grads(_padded_recurrence(kind, reference, h), leaves, cots)
    _close_bf16(got, want, grads, wgrads)
    jout, jgrads = _jax_vjp(jfn, jargs, cots)
    _close_jax_chain_bf16(got, jout, grads, jgrads)


def test_pad_args_zero_every_padded_unit():
    """Each gate block keeps its units first, zeros after; W's padded rows
    are zero too."""
    args, _ = _rec_inputs("lstm", 0, 3, b=2, t=2)
    xw, w, h0, c0 = K8.pad_args([torch.from_numpy(a) for a in args], 5)
    assert xw.shape == (2, 2, 20) and w.shape == (5, 20)
    blocks = w.view(5, 4, 5)
    torch.testing.assert_close(blocks[:3, :, :3],
                               torch.from_numpy(args[1]).view(3, 4, 3),
                               rtol=0, atol=0)
    assert not blocks[3:].any() and not blocks[:, :, 3:].any()
    assert not xw.view(2, 2, 4, 5)[..., 3:].any()
    assert not h0[:, 3:].any() and not c0[:, 3:].any()
    g = K10.pad_args([torch.from_numpy(a) for a in
                      _rec_inputs("gru", 0, 3, b=2, t=2)[0]], 4)
    assert [tuple(x.shape) for x in g] == [(2, 2, 12), (4, 12), (12,),
                                           (2, 4)]
    s = K9.pad_args([torch.from_numpy(a) for a in
                     _rec_inputs("stacked", 0, 3, b=2, t=2)[0]], 4)
    assert [tuple(x.shape) for x in s] == [(2, 2, 16), (1, 4, 16), (1, 16),
                                           (2, 4, 16), (2, 2, 4), (2, 2, 4)]


# ---- the configurations ---------------------------------------------------

@pytest.fixture(params=["plain", "padded"])
def padding(request, monkeypatch):
    """"padded": each plain version the CPU runs goes through the
    wrappers' padding, as the kernels run these sizes on the card; the
    test must run at least one of them there."""
    ran = []
    if request.param == "padded":
        for kind, (mod, _, name) in RECURRENCES.items():
            monkeypatch.setattr(mod, name, functools.partial(
                _pad_any_recurrence, ran, kind, getattr(mod, name)))
        for name in ("rect_attention_reference",
                     "rect_attention_bf16_reference"):
            monkeypatch.setattr(K5, name, functools.partial(
                _pad_any_attention, ran, getattr(K5, name)))
    yield request.param
    assert bool(ran) == (request.param == "padded"), ran


def _pad_any_recurrence(ran, kind, reference, *args):
    ran.append(kind)
    return _padded_recurrence(kind, reference, args[-1].shape[-1])(*args)


def _pad_any_attention(ran, plain, heads, q, k, v, q_pad, k_pad,
                       scale=None):
    ran.append("rect_attention")
    return _padded_attention(plain, heads, q.shape[-1] // heads)(
        q, k, v, q_pad, k_pad)


def _close_tree(got, want, atol):
    if isinstance(got, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close_tree(g, w, atol)
    elif isinstance(got, dict):
        for key in got:
            _close_tree(got[key], want[key], atol)
    else:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=atol)


def _grads_match(pm, jgrads, atol):
    want = state_dict_from_jax(flat_params(jgrads))
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=atol, err_msg=name)


@contextlib.contextmanager
def _jax_env(**env):
    """A context with the JAX side's routes (``env``) and its Pallas calls
    in interpret mode, for module-scoped fixtures."""
    with pytest.MonkeyPatch.context() as mp:
        for key, value in env.items():
            mp.setenv(key, value)
        mp.setattr(pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        yield


GRU48 = dict(MF_CFG, hidden_size=48, num_heads=4, bottleneck_size=8,
             emb_mixers=["gru", "gru", "gru"])


@pytest.fixture(scope="module")
def gru48():
    """The JAX GRU Metaformer at hidden 48, 4 heads (its GRUs and rect
    attention on their Pallas routes), T 6 + lead 2 (the audio encoder 64
    steps, the motion streams 8): params, batch, the output and the
    gradients of a mean-square loss, a teacher-forced generation."""
    with _jax_env(MRGEN_RNN_IMPL="pallas", MRGEN_FUSED_ATTN="force"):
        batch = np_batch(70, T=6, lead=2)
        jm = JaxMetaformer(cfg=GRU48)
        params = jax.jit(jm.init)(jax.random.PRNGKey(71),
                                  *[jnp.asarray(x) for x in batch[:6]])

        def loss(p):
            y, _ = jm.apply(p, *[jnp.asarray(x) for x in batch[:6]])
            return jnp.mean(y[:, 2:] ** 2), y

        (_, y), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            params)
        with jax.default_matmul_precision("highest"):
            gen = jax_generate(jm, params, tuple(jnp.asarray(x)
                                                 for x in batch),
                               jnp.asarray(np.zeros(6, bool)),
                               cache_dtype=jnp.float32, kv_layout="shared")
    return params, batch, y, grads, gen


def test_gru_metaformer_at_hidden_48_and_head_dim_12_matches_jax(
        gru48, padding):
    """Forward atol 2e-5, the gradients of a mean-square loss atol 1e-5,
    a teacher-forced generation (f32 caches) atol 2e-5."""
    params, batch, y, jgrads, gen = gru48
    pm = Metaformer(GRU48, device="cpu")
    pm.load_state_dict(state_dict_from_jax(flat_params(params)), strict=True)
    assert pm.metaformer.block_0.emb_1.block_0.mixer.weight_hh_l0.shape == (
        144, 48)
    py, _ = pm(*[torch.from_numpy(x) for x in batch[:6]])
    py[:, 2:].square().mean().backward()
    np.testing.assert_allclose(py.detach().numpy(), np.asarray(y), atol=2e-5)
    _grads_match(pm, jgrads, 1e-5)
    with torch.no_grad():
        got = G.generate_metaformer(pm, [torch.from_numpy(x) for x in batch],
                                    torch.zeros(6, dtype=torch.bool),
                                    cache_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(gen), atol=2e-5)


LWS48 = dict(LWS_CFG, hidden_size=48, sampler_hidden_size=48,
             sampler_num_layers=2)


@pytest.fixture(scope="module")
def lws48():
    """JAX lstm_with_sampling at hidden 48, sampler 48 (2 layers; its
    recurrences on their Pallas routes), T 4 + lead 2 (the sampler 48
    steps): params, batch, output and state, the gradients of a
    mean-square loss, a teacher-forced ``generate_lws``."""
    with _jax_env(MRGEN_RNN_IMPL="pallas"):
        batch = np_batch(80, T=4, lead=2)
        jm = JaxLSTMwithSample(cfg=LWS48)
        params = jax.jit(jm.init)(jax.random.PRNGKey(81),
                                  *[jnp.asarray(x) for x in batch[:6]])

        def loss(p):
            y, state = jm.apply(p, *[jnp.asarray(x) for x in batch[:6]])
            return jnp.mean(y ** 2), (y, state)

        (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            params)
        gen = jax_generate_lws(jm, params, tuple(jnp.asarray(x)
                                                 for x in batch),
                               jnp.asarray(np.zeros(4, bool)))
    return params, batch, out, grads, gen


def test_lws_at_hidden_48_and_sampler_48_matches_jax(lws48, padding):
    """Forward and states atol 1e-5, the gradients atol 1e-5, a
    teacher-forced ``generate_lws`` atol 1e-5 (the sampler on K9's route,
    the blocks' 6 steps the plain loop)."""
    params, batch, (y, state), jgrads, gen = lws48
    pm = LSTMwithSample(LWS48, device="cpu")
    pm.load_state_dict(state_dict_from_jax(flat_params(params)), strict=True)
    py, pstate = pm(*[torch.from_numpy(x) for x in batch[:6]])
    py.square().mean().backward()
    _close_tree(py, y, 1e-5)
    _close_tree(pstate, state, 1e-5)
    _grads_match(pm, jgrads, 1e-5)
    got = G.generate_lws(pm, [torch.from_numpy(x) for x in batch],
                         torch.zeros(4, dtype=torch.bool))
    np.testing.assert_allclose(got.numpy(), np.asarray(gen), atol=1e-5)


SIMPLE48 = dict(SIMPLE_CFG, acostic_lstm_size=48, motion_lstm_size=48,
                acostic_affine_size=96, motion_affine_size=96,
                acostic_output_size=96, motion_output_size=96,
                decoder_lstm_size=48, decoder_affine_size=96,
                decoder_output_size=96)


@pytest.fixture(scope="module")
def simple48():
    """JAX simple_lstm with 48-wide bidirectional LSTMs: a 120-frame fbank
    window (the acoustic LSTMs 120 steps) and a 15-frame motion context;
    params, batch, output, loss and gradients; ``sliding_window_generate``
    over 2 windows."""
    from multimodalreactiongeneration_tpu.infer.simple_generate import (
        sliding_window_generate as jax_sliding,
    )

    rng = np.random.default_rng(90)
    batch = [rng.standard_normal(s).astype(np.float32)
             for s in ((2, 120, 81), (2, 15, 18), (2, 1, 18))]
    windows = rng.standard_normal((2, 120, 81)).astype(np.float32)
    jm = jsimple.SimpleLSTM(cfg=SIMPLE48)
    params = jax.jit(jm.init)(jax.random.PRNGKey(91),
                              *[jnp.asarray(x) for x in batch[:2]])
    fbank, motion, target = [jnp.asarray(x) for x in batch]

    def loss_fn(p):
        y = jm.apply(p, fbank, motion)
        loss, _ = jsimple.simple_lstm_loss(y, target, motion, SIMPLE48,
                                           SIMPLE_METRICS)
        return loss, y

    (loss, y), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    gen = jax_sliding(jm, params, jnp.asarray(windows),
                      jnp.asarray(batch[1][0]))
    return params, batch, windows, y, loss, grads, gen


def test_simple_lstm_with_48_wide_lstms_matches_jax(simple48, padding):
    """Forward, loss and every parameter's gradient atol 1e-5 (the
    acoustic LSTMs on K8's route), ``sliding_window_generate`` atol
    1e-4."""
    from multimodalreactiongeneration_tpu_torch.infer.simple_generate import (
        sliding_window_generate,
    )

    params, batch, windows, y, loss, jgrads, gen = simple48
    pm = simple_lstm.SimpleLSTM(SIMPLE48, device="cpu")
    pm.load_state_dict(state_dict_from_jax(flat_params(params)), strict=True)
    tb = [torch.from_numpy(x) for x in batch]
    py = pm(tb[0], tb[1])
    ploss, _ = simple_lstm.simple_lstm_loss(py, tb[2], tb[1], SIMPLE48,
                                            SIMPLE_METRICS)
    ploss.backward()
    np.testing.assert_allclose(py.detach().numpy(), np.asarray(y), atol=1e-5)
    np.testing.assert_allclose(float(ploss.detach()), float(loss), rtol=1e-5)
    _grads_match(pm, jgrads, 1e-5)
    with torch.no_grad():
        got = sliding_window_generate(pm, torch.from_numpy(windows),
                                      tb[1][0], device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(gen), atol=1e-4)


# ---- the routes -----------------------------------------------------------

@pytest.mark.parametrize("h", [1, 48, 64, 100, 160, 192, 200, 256])
def test_cuda_routes_take_every_hidden_size_up_to_256(h):
    assert recurrent.single_layer_route("cuda", 16, 18, h) == (
        "lstm_recurrence")
    assert recurrent.use_gru_kernel("cuda", 16, h)
    assert recurrent.use_lstm_stacked("cuda", 16, 2, h, 4)
    assert K9.route(2, h) == ("wavefront" if 64 < h <= 128 else "layers")
    assert K9.route(5, h) == "layers"
    for why in (K8.kernel_refusal(h), K10.kernel_refusal(h),
                K9.kernel_refusal(2, h, 4)):
        assert why is None


@pytest.mark.parametrize("d", [1, 12, 16, 48, 96, 128, 200, 256])
def test_attention_shape_check_takes_every_head_dim_up_to_256(d):
    for heads in (1, 2, 4):
        assert K5.kernel_refusal(heads * d, heads) is None


def test_cuda_routes_raise_naming_the_kernel_above_256():
    with pytest.raises(NotImplementedError, match="K8"):
        recurrent.single_layer_route("cuda", 16, 18, 384)
    with pytest.raises(NotImplementedError, match="K10"):
        recurrent.use_gru_kernel("cuda", 16, 384)
    with pytest.raises(NotImplementedError, match="K9"):
        recurrent.use_lstm_stacked("cuda", 16, 2, 384, 4)
    assert K9.route(2, 384) is None
    assert "K5/K6" in K5.kernel_refusal(512, 1)
    assert "K5/K6" in K5.kernel_refusal(1024, 2)
    # the CPU routes take them (the plain versions)
    assert recurrent.single_layer_route("cpu", 16, 18, 384) == (
        "lstm_recurrence")
    assert recurrent.use_gru_kernel("cpu", 16, 384)
