"""PyTorch port: the recurrent-mixer stack vs the JAX package.

Ground truth is the JAX ``RecurrentMixerLayerd`` on its scan path (the
CPU path), at the cases of tests/test_pallas_mixer_stack.py: the port's
plain ``mixer_stack_forward_reference`` and the port's own
``RecurrentMixerLayerd`` (which dispatches to it on the CPU) must match
it, f32, atol 2e-5. The CUDA kernel is held to the plain version on the
card in tests/test_torch_port_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalreactiongeneration_tpu.nn.mixers import (
    RecurrentMixerLayerd as JaxLayerd,
)
from multimodalreactiongeneration_tpu_torch.models.weights import (
    state_dict_from_jax,
)
from multimodalreactiongeneration_tpu_torch.nn.mixers import (
    RecurrentMixerLayerd as PortLayerd,
)
from multimodalreactiongeneration_tpu_torch.ops import mixer_stack
from tests.test_torch_port_weights import flat_params

torch.set_num_threads(1)
ATOL = 2e-5
CASES = [(2, 16), (3, 21), (5, 33)]


def _pair(num_layerd, h, x, seed):
    kw = dict(num_layerd=num_layerd, num_internal_layer=1,
              nonlinearity=None, residual=True, residual_layer_norm=True,
              bottleneck_size=16, use_bias=True)
    jm = JaxLayerd(hidden_size=h, kind="lstm", dropout=0.0,
                   bidirectional=False, **kw)
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    pm = PortLayerd(h, torch.Generator(), kind="lstm", **kw)
    pm.load_state_dict(state_dict_from_jax(flat_params(params)), strict=True)
    return jm, params, pm


def _stacked(pm):
    blocks = [getattr(pm, f"block_{i}") for i in range(pm.num_layerd)]

    def st(fn):
        return torch.stack([fn(b) for b in blocks]).detach().contiguous()

    return (
        st(lambda b: b.mixer.weight_ih_l0.T),
        st(lambda b: b.mixer.bias_ih_l0 + b.mixer.bias_hh_l0),
        st(lambda b: b.mixer.weight_hh_l0.T),
        st(lambda b: b.feed_forward.feedforward.weight.T),
        st(lambda b: b.feed_forward.feedforward.bias),
        st(lambda b: b.mixer_norm.weight),
        st(lambda b: b.mixer_norm.bias),
        st(lambda b: b.feed_forward.LayerNorm_0.weight),
        st(lambda b: b.feed_forward.LayerNorm_0.bias),
    )


def _inputs(num_layerd, t, b=3, h=16, seed=0):
    rng = np.random.default_rng(seed + 10 * num_layerd + t)
    x = rng.standard_normal((b, t, h)).astype(np.float32)
    h0 = 0.3 * rng.standard_normal((num_layerd, b, h)).astype(np.float32)
    c0 = 0.3 * rng.standard_normal((num_layerd, b, h)).astype(np.float32)
    return x, h0, c0


def _jax_ref(jm, params, x, h0, c0):
    hx = [(jnp.asarray(h0[l][None]), jnp.asarray(c0[l][None]))
          for l in range(h0.shape[0])]
    with jax.default_matmul_precision("highest"):
        y, states = jm.apply(params, jnp.asarray(x), hx)
    hn = np.stack([np.asarray(s[0][0]) for s in states])
    cn = np.stack([np.asarray(s[1][0]) for s in states])
    return np.asarray(y), hn, cn


@pytest.mark.parametrize("num_layerd,t", CASES)
def test_reference_matches_jax_module(num_layerd, t):
    x, h0, c0 = _inputs(num_layerd, t)
    jm, params, pm = _pair(num_layerd, 16, x, seed=t)
    want = _jax_ref(jm, params, x, h0, c0)
    with torch.no_grad():
        y, (hn, cn) = mixer_stack.mixer_stack_forward_reference(
            torch.from_numpy(x), *_stacked(pm), torch.from_numpy(h0),
            torch.from_numpy(c0),
        )
    for got, w in zip((y, hn, cn), want):
        np.testing.assert_allclose(got.numpy(), w, atol=ATOL)


@pytest.mark.parametrize("num_layerd,t", CASES)
def test_port_module_matches_jax_module(num_layerd, t):
    """The port's RecurrentMixerLayerd (its fused-stack dispatch on the
    CPU) vs the JAX module, from zero and from given states."""
    x, h0, c0 = _inputs(num_layerd, t, seed=1)
    jm, params, pm = _pair(num_layerd, 16, x, seed=t + 1)
    before = mixer_stack.launches
    with torch.no_grad():
        y0, s0 = pm(torch.from_numpy(x))
        hx = [(torch.from_numpy(h0[l][None]), torch.from_numpy(c0[l][None]))
              for l in range(num_layerd)]
        y1, s1 = pm(torch.from_numpy(x), hx)
    assert mixer_stack.launches == before  # CPU tensors: no kernel
    with jax.default_matmul_precision("highest"):
        jy0, js0 = jm.apply(params, jnp.asarray(x))
    np.testing.assert_allclose(y0.numpy(), np.asarray(jy0), atol=ATOL)
    for (ph, pc), (jh, jc) in zip(s0, js0):
        np.testing.assert_allclose(ph.numpy(), np.asarray(jh), atol=ATOL)
        np.testing.assert_allclose(pc.numpy(), np.asarray(jc), atol=ATOL)
    jy1, jh1, jc1 = _jax_ref(jm, params, x, h0, c0)
    np.testing.assert_allclose(y1.numpy(), jy1, atol=ATOL)
    np.testing.assert_allclose(torch.cat([s[0] for s in s1]).numpy(), jh1,
                               atol=ATOL)
    np.testing.assert_allclose(torch.cat([s[1] for s in s1]).numpy(), jc1,
                               atol=ATOL)


def test_short_sequences_stay_on_the_block_modules():
    """Under 16 steps the stack is not fused (the JAX resolve_impl
    rule), and the per-block path gives the same result."""
    x, h0, c0 = _inputs(2, 15, seed=2)
    jm, params, pm = _pair(2, 16, x, seed=3)
    assert pm._fused_stack(torch.from_numpy(x), None) is None
    with torch.no_grad():
        y, _ = pm(torch.from_numpy(x))
    with jax.default_matmul_precision("highest"):
        jy, _ = jm.apply(params, jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL)


def test_cpu_wrapper_rejects_other_devices():
    x = torch.zeros(1, 16, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        mixer_stack.mixer_stack_forward(x, *([x] * 11))
