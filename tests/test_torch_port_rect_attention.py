"""PyTorch port: rect attention (K5/K6) vs the JAX package, on CPU tensors.

  * the port's ``rect_attention`` (its plain version on CPU tensors),
    forward and dq/dk/dv under a random cotangent, against the JAX
    ``ops/pallas_rect_attention.py rect_attention`` with its Pallas calls
    in interpret mode (patched as tests/test_pallas_attention.py runs
    them) and against JAX ``scaled_dot_attention`` on the merged mask;
    B 2, E 64, 2 heads, ~10% padded rows and keys; f32 atol 2e-5
    forward, 2e-4 gradients (the JAX kernel tests' own bounds);
  * a row whose keys are all masked, held to JAX ``scaled_dot_attention``
    only: the JAX kernel pads Lk to a multiple of 8 and averages such a
    row over the padded columns too (20 -> 24 keys), a JAX-side
    difference recorded in ROADMAP queue C;
  * ``TorchMHA.attend`` on a ``rect_pad_masks`` module takes the rect
    route and agrees with the same module's plain masked path.

The CUDA kernels are held to the plain version on the card in
tests/test_torch_port_kernels.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from multimodalreactiongeneration_tpu.nn.attention import scaled_dot_attention
from multimodalreactiongeneration_tpu.ops import masks as jmasks
from multimodalreactiongeneration_tpu.ops import pallas_rect_attention as jra
from multimodalreactiongeneration_tpu_torch.nn.attention import TorchMHA
from multimodalreactiongeneration_tpu_torch.ops import rect_attention as K5
from multimodalreactiongeneration_tpu_torch.ops.masks import (
    merged_attention_mask,
)

torch.set_num_threads(1)
FWD_ATOL, GRAD_ATOL = 2e-5, 2e-4
B, E, HEADS = 2, 64, 2
CASES = [(16, 128), (128, 16), (40, 40), (12, 96), (10, 20)]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


def _inputs(lq, lk, seed, full_row=False):
    rng = np.random.default_rng(seed)
    q, k, v, g = [rng.standard_normal(s).astype(np.float32)
                  for s in ((B, lq, E), (B, lk, E), (B, lk, E), (B, lq, E))]
    q_pad = rng.random((B, lq)) < 0.1
    k_pad = rng.random((B, lk)) < 0.1
    if full_row:  # row 3 of batch 0 and every key it sees are padding
        q_pad[0, 3] = True
        k_pad[0, :-(-4 * lk // lq)] = True
    return q, k, v, q_pad, k_pad, g


def _port(q, k, v, q_pad, k_pad, g):
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    before = K5.fwd_launches, K5.bwd_launches
    out = K5.rect_attention(HEADS, *leaves, torch.from_numpy(q_pad),
                            torch.from_numpy(k_pad))
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    assert (K5.fwd_launches, K5.bwd_launches) == before  # plain on CPU
    return out.detach().numpy(), [x.numpy() for x in grads]


def _jax_dot(q, k, v, q_pad, k_pad, g):
    """JAX scaled_dot_attention on the merged mask, heads split around
    it, with its vjp."""
    lq, lk = q.shape[1], k.shape[1]
    qm = np.where(q_pad[:, :, None], -100.0, 0.0).astype(np.float32)
    km = np.where(k_pad[:, :, None], -100.0, 0.0).astype(np.float32)
    mask = jmasks.merged_attention_mask(jnp.asarray(qm),
                                        jnp.asarray(km))[:, None]

    def f(q, k, v):
        def split(x, n):
            return x.reshape(B, n, HEADS, E // HEADS).transpose(0, 2, 1, 3)
        ctx = scaled_dot_attention(split(q, lq), split(k, lk), split(v, lk),
                                   mask)
        return ctx.transpose(0, 2, 1, 3).reshape(B, lq, E)

    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("lq,lk", CASES)
def test_rect_attention_matches_jax_kernel(lq, lk):
    q, k, v, q_pad, k_pad, g = _inputs(lq, lk, lq * 1000 + lk)
    out, grads = _port(q, k, v, q_pad, k_pad, g)

    def f(q, k, v):
        return jra.rect_attention(HEADS, q, k, v, jnp.asarray(q_pad),
                                  jnp.asarray(k_pad))

    want, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(out, np.asarray(want), atol=FWD_ATOL)
    for got, w, name in zip(grads, vjp(jnp.asarray(g)), "qkv"):
        np.testing.assert_allclose(got, np.asarray(w), atol=GRAD_ATOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("lq,lk,full_row", [
    *[(lq, lk, False) for lq, lk in CASES],
    *[(lq, lk, True) for lq, lk in CASES],
])
def test_rect_attention_matches_jax_masked_softmax(lq, lk, full_row):
    inputs = _inputs(lq, lk, lq * 1000 + lk + 1, full_row)
    out, grads = _port(*inputs)
    want, wgrads = _jax_dot(*inputs)
    np.testing.assert_allclose(out, want, atol=FWD_ATOL)
    for got, w, name in zip(grads, wgrads, "qkv"):
        np.testing.assert_allclose(got, w, atol=GRAD_ATOL, err_msg=f"d{name}")
    if full_row:  # the uniform average over all Lk keys, v of batch 0
        v = inputs[2]
        np.testing.assert_allclose(out[0, 3], v[0].mean(axis=0), atol=1e-5)


def test_reference_backward_is_autograd_of_the_plain_forward():
    q, k, v, q_pad, k_pad, g = [torch.from_numpy(x)
                                for x in _inputs(40, 40, 7)]
    got = K5.rect_attention_backward_reference(HEADS, q, k, v, q_pad, k_pad,
                                               g)
    _, want = _port(*[x.numpy() for x in (q, k, v, q_pad, k_pad, g)])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("lq,lk", [(12, 96), (40, 40)])
def test_mha_attend_takes_the_rect_route(monkeypatch, lq, lk):
    """A rect_pad_masks module on a merged mask goes through
    rect_attention and matches the same weights' plain masked path."""
    rng = np.random.default_rng(lq + lk)
    query = torch.from_numpy(rng.standard_normal((B, lq, E)).astype(
        np.float32))
    key = torch.from_numpy(rng.standard_normal((B, lk, E)).astype(
        np.float32))
    query[0, -2:, 0] = -100.0  # padded frames: first channel -100
    key[0, :5, 0] = -100.0  # visible to every row, so the pads rebuild
    key[1, -3:, 0] = -100.0
    mask = merged_attention_mask(query, key)
    rect = TorchMHA(E, HEADS, torch.Generator().manual_seed(0),
                    rect_pad_masks=True)
    plain = TorchMHA(E, HEADS, torch.Generator().manual_seed(0))
    plain.load_state_dict(rect.state_dict())
    calls = []
    real = K5.rect_attention_reference

    def spy(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(K5, "rect_attention_reference", spy)
    got = rect(query, key, key, mask)
    assert len(calls) == 1
    np.testing.assert_array_equal(calls[0][4].numpy(),
                                  (query[:, :, 0] == -100).numpy())
    want = plain(query, key, key, mask)
    assert not calls[1:]
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               atol=FWD_ATOL)
    # a rank-2 mask keeps the plain path
    rect(query, key, key, mask[0])
    assert len(calls) == 1
