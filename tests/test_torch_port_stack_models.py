"""PyTorch port: the LSTM layer (K7) at 384 and 512 and the LSTM-mixer
Metaformer at hidden 48, on CPU tensors against the JAX package (its
Pallas calls in interpret mode).

  * K7's plain version at H 384 and 512 (the 128-aligned sizes past 256,
    which JAX routes to ``lstm_layer``; the card runs them on 16-CTA
    clusters) against JAX's ``lstm_layer``, f32 and bf16;
  * the LSTM-mixer Metaformer at hidden 48 and 4 heads (head dim 12)
    against JAX with its stack kernel, recurrences and attention on their
    Pallas routes (``MRGEN_RNN_IMPL=pallas``): the weight bridge with
    ``strict=True``, the forward, every parameter's gradient and a
    teacher-forced generation, once on the plain versions and once with
    each run through the wrappers' padding (tests/
    test_torch_port_kernel_shapes.py's ``padding``: K8 at 64, the heads at
    16; and the stack's plain version padded at the real width: hidden 48
    is a width the stack's kernels are built for, so it is padded to 56,
    which holds the padding's arithmetic inside the model).

The stack's padding at every hidden size is in
tests/test_torch_port_stack_shapes.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from multimodalreactiongeneration_tpu.infer.generate import (
    generate_metaformer as jax_generate,
)
from multimodalreactiongeneration_tpu.models.lstmformer import (
    Metaformer as JaxMetaformer,
)
from multimodalreactiongeneration_tpu.ops import pallas_lstm
from multimodalreactiongeneration_tpu_torch.infer import generate as G
from multimodalreactiongeneration_tpu_torch.models.lstmformer import Metaformer
from multimodalreactiongeneration_tpu_torch.models.weights import (
    state_dict_from_jax,
)
from multimodalreactiongeneration_tpu_torch.ops import lstm_layer as K7
from multimodalreactiongeneration_tpu_torch.ops import mixer_stack as K1
from tests.test_streaming_models import MF_CFG
from tests.test_torch_port_kernel_shapes import (
    _grads_match,
    _jax_env,
    _jax_vjp,
    _np,
    _torch,
)
from tests.test_torch_port_kernel_shapes import padding  # noqa: F401
from tests.test_torch_port_stack_shapes import (
    ATOL,
    _close_scaled,
    _pad_width,
)
from tests.test_torch_port_weights import flat_params, np_batch

torch.set_num_threads(1)
BF = torch.bfloat16


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


# ---- K7 at 384 and 512 ----------------------------------------------------

@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("h", [384, 512])
def test_lstm_layer_plain_matches_jax_at_384_and_512(h, bf16):
    """f32: outputs atol 1e-5, gradients 2e-5 of their largest past
    magnitude 1; bf16 (x and the weights bf16, T 16): JAX's bf16 bounds
    (tests/test_pallas_lstm.py:130: 5e-2 abs on outputs and the f32
    gradients, 0.3 on the bf16 ones), each gradient in JAX's dtype."""
    rng = np.random.default_rng(h)
    b, t = 2, 16

    def r(*shape, s=1.0):
        return (s * rng.standard_normal(shape)).astype(np.float32)

    args = [r(b, t, h), r(h, 4 * h, s=0.05), r(4 * h, s=0.1),
            r(h, 4 * h, s=0.05), r(b, h, s=0.3), r(b, h, s=0.3)]
    cots = [r(b, t, h), r(b, h), r(b, h)]
    jargs = [jnp.asarray(a) for a in args]
    if bf16:
        for i in (0, 1, 3):
            jargs[i] = jargs[i].astype(jnp.bfloat16)
    jouts, jgrads = _jax_vjp(pallas_lstm.lstm_layer, jargs, cots)
    leaves = [_torch(a).requires_grad_() for a in jargs]
    ys, (hn, cn) = K7.lstm_layer(*leaves)
    grads = torch.autograd.grad((ys, hn, cn), leaves,
                                [torch.from_numpy(c) for c in cots])
    assert K7.kernel_refusal(h, h) is None
    for i, (g, w) in enumerate(zip((ys, hn, cn), jouts)):
        np.testing.assert_allclose(_np(g), _np(w),
                                   atol=5e-2 if bf16 else 1e-5,
                                   err_msg=str(i))
    for i, (g, w) in enumerate(zip(grads, jgrads)):
        assert str(g.dtype).split(".")[-1] == str(w.dtype), i
        if bf16:
            np.testing.assert_allclose(_np(g), _np(w),
                                       atol=0.3 if g.dtype == BF else 5e-2,
                                       err_msg=str(i))
        else:
            _close_scaled(g, w, ATOL, str(i))


# ---- the LSTM-mixer Metaformer at hidden 48 -------------------------------

LSTM48 = dict(MF_CFG, hidden_size=48, num_heads=4, bottleneck_size=8,
              emb_mixers=["lstm", "lstm", "lstm"])


@pytest.fixture(scope="module")
def lstm48():
    """The JAX LSTM-mixer Metaformer at hidden 48, 4 heads (its stack
    kernel, recurrences and rect attention on their Pallas routes), T 6 +
    lead 2 (the audio encoder 64 steps, the motion streams 8): params,
    batch, the output and the gradients of a mean-square loss, a
    teacher-forced generation."""
    with _jax_env(MRGEN_RNN_IMPL="pallas", MRGEN_FUSED_ATTN="force"):
        batch = np_batch(60, T=6, lead=2)
        jm = JaxMetaformer(cfg=LSTM48)
        params = jax.jit(jm.init)(jax.random.PRNGKey(61),
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


@pytest.fixture
def stack_padding(padding, monkeypatch):  # noqa: F811
    """The ``padding`` fixture's recurrences and attention, and the
    stack's plain version run padded (to the next built width: hidden 48
    is built) at the real width; the test must run it there."""
    ran = []
    if padding == "padded":
        plain = K1.mixer_stack_forward_reference

        def padded(*args, real=None):
            ran.append("stack")
            h = args[0].shape[-1]
            out, (hn, cn) = plain(*K1.pad_args(args, _pad_width(h)), real=h)
            out, hn, cn = K1.unpad_outputs(out, hn, cn, h)
            return out, (hn, cn)
        monkeypatch.setattr(K1, "mixer_stack_forward_reference", padded)
    yield padding
    assert bool(ran) == (padding == "padded")


def test_lstm_metaformer_at_hidden_48_matches_jax(lstm48, stack_padding):
    """Forward atol 2e-5, the gradients of a mean-square loss atol 1e-5,
    a teacher-forced generation (f32 caches) atol 2e-5 (the bounds of
    tests/test_torch_port_kernel_shapes.py's hidden-48 GRU model)."""
    params, batch, y, jgrads, gen = lstm48
    pm = Metaformer(LSTM48, device="cpu")
    pm.load_state_dict(state_dict_from_jax(flat_params(params)), strict=True)
    emb = pm.metaformer.block_0.emb_0
    assert emb.block_0.mixer.weight_hh_l0.shape == (192, 48)
    py, _ = pm(*[torch.from_numpy(x) for x in batch[:6]])
    py[:, 2:].square().mean().backward()
    np.testing.assert_allclose(py.detach().numpy(), np.asarray(y), atol=2e-5)
    _grads_match(pm, jgrads, 1e-5)
    with torch.no_grad():
        got = G.generate_metaformer(pm, [torch.from_numpy(x) for x in batch],
                                    torch.zeros(6, dtype=torch.bool),
                                    cache_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(gen), atol=2e-5)
