"""The bf16 operand mode of the LSTM chains K7, K8 and K9, in plain
PyTorch, and the bf16 operand product the plain versions of K3/K4
(``ops/mixer_stack.py``) record autograd through.

In the JAX package the dtype of the weights handed to ``lstm_layer``,
``lstm_recurrence`` (``ops/pallas_lstm.py``) and
``lstm_stacked_recurrence`` (``ops/pallas_lstm_stacked.py``) selects the
operands of every matrix product inside the kernels: with bf16 weights
each product rounds its operands to bf16 and sums in f32
(``preferred_element_type=f32``). The state, the cell math, the gate
activations and cell states kept for the backward, the bias sums and db
stay f32. So in this mode:

  * forward: gates = xw + bf16(h) W_hh (K9's upper layers also take
    bf16(h_below) W_ih + b);
  * backward: the carry dh = bf16(dgates) W_hh^T (K9: plus
    bf16(dgates_above) W_ih^T), dx = bf16(dgates) W_ih^T, and the weight
    gradients bf16(A)^T bf16(dgates) summed in f32 over all rows, then
    rounded to bf16 (the weights' dtype);
  * db and K9's dxw0 are the f32 dgates, unrounded.

This module holds that arithmetic once for the plain versions of the
three kernels (``ops/lstm_layer.py``, ``ops/lstm_recurrence.py``,
``ops/lstm_stacked.py``; K8's dW_hh is ``tn`` of its h_{t-1} and
dgates); the CUDA kernels' bf16 mode computes the same function
(``csrc/lstm_cluster.cuh``, ``csrc/lstm_cluster_bwd.cuh``,
``csrc/lstm_recurrence.cu``, ``csrc/bf16_gemm.cuh``). Its backward is
written out step by step, as the JAX kernels' custom VJPs are, because
autograd through the roundings would round the cotangents too.
"""

from __future__ import annotations

import torch

BF16 = torch.bfloat16


def recurrence_operand_dtype(name, args, names) -> torch.dtype:
    """The operand mode of a recurrence over f32 input projections (K8,
    K10) on ``args``, named ``names``, W_hh second: f32 when every tensor
    is f32, bf16 for the bf16 mode (w_hh_t bf16, the rest f32); raises,
    naming ``name``, otherwise."""
    mm = args[1].dtype
    if mm not in (torch.float32, BF16) or any(
            a.dtype != torch.float32 for i, a in enumerate(args) if i != 1):
        rest = ", ".join(n for i, n in enumerate(names) if i != 1)
        raise ValueError(
            f"{name} takes every tensor f32, or w_hh_t bf16 with {rest} f32 "
            "(the bf16 operand mode); got "
            + ", ".join(str(a.dtype) for a in args))
    return mm


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (to nearest, ties to even), as f32."""
    return x.to(BF16).float()


def chain_forward(xw, w_hh_t, h0, c0):
    """The recurrence over f32 input projections ``xw`` (B, T, 4H) with
    bf16 ``w_hh_t`` (H, 4H) and f32 ``h0``, ``c0`` (B, H). Returns (ys,
    hn, cn, acts, cs): acts (B, T, 4H) = [i, f, g, o] and cs (B, T, H),
    the backward's residuals; all f32."""
    w = w_hh_t.float()
    h, c = h0, c0
    ys, acts, cs = [], [], []
    for t in range(xw.shape[1]):
        gates = xw[:, t] + round_bf16(h) @ w
        i, f, g, o = gates.chunk(4, dim=-1)
        i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                      torch.sigmoid(o))
        c = f * c + i * g
        h = o * torch.tanh(c)
        ys.append(h)
        acts.append(torch.cat([i, f, g, o], dim=-1))
        cs.append(c)
    stack = lambda xs: torch.stack(xs, dim=1)
    return stack(ys), h, c, stack(acts), stack(cs)


def chain_backward(acts, cs, c0, w_hh_t, dys, dhn, dcn):
    """The reverse recurrence from the forward's residuals and the f32
    cotangents dys (B, T, H), dhn, dcn (B, H). Returns (dgates (B, T,
    4H), dh0, dc0), all f32; the carry takes bf16(dgates) W_hh^T."""
    w_t = w_hh_t.float().T  # (4H, H)
    dh_carry, dc_carry = dhn, dcn
    dgates = [None] * acts.shape[1]
    for t in reversed(range(acts.shape[1])):
        i, f, g, o = acts[:, t].chunk(4, dim=-1)
        c = cs[:, t]
        c_prev = cs[:, t - 1] if t else c0
        dh = dys[:, t] + dh_carry
        tc = torch.tanh(c)
        dc = dh * o * (1.0 - tc * tc) + dc_carry
        d = torch.cat([dc * g * i * (1.0 - i), dc * c_prev * f * (1.0 - f),
                       dc * i * (1.0 - g * g), dh * tc * o * (1.0 - o)],
                      dim=-1)
        dc_carry = dc * f
        dh_carry = round_bf16(d) @ w_t
        dgates[t] = d
    return torch.stack(dgates, dim=1), dh_carry, dc_carry


def shifted(ys, h0):
    """h_{t-1} of every step: (B, T, H) with h0 at t = 0."""
    return torch.cat([h0[:, None], ys[:, :-1]], dim=1)


def zero_none(cots, likes):
    """An autograd Function's cotangents, zeros like ``likes`` for the
    outputs that got none."""
    return [torch.zeros_like(like) if c is None else c
            for c, like in zip(cots, likes)]


class _OperandMm(torch.autograd.Function):
    """a @ w with a rounded to bf16, w f32 holding bf16 values, f32 sums;
    its backward rounds the cotangent g to bf16 for both products: da =
    bf16(g) w^T and dw = bf16(a)^T bf16(g), f32 sums (JAX's products in
    the bf16 mode, ``ops/pallas_mixer_stack.py _bwd_kernel``)."""

    @staticmethod
    def forward(ctx, a, w):
        ar = round_bf16(a)
        ctx.save_for_backward(ar, w)
        return ar @ w

    @staticmethod
    def backward(ctx, g):
        ar, w = ctx.saved_tensors
        gr = round_bf16(g)
        dw = ar.reshape(-1, ar.shape[-1]).T @ gr.reshape(-1, gr.shape[-1])
        return gr @ w.T, dw


def operand_mm(a: torch.Tensor, w32: torch.Tensor) -> torch.Tensor:
    """bf16(a) @ w32 with f32 sums, differentiable at JAX's rounding
    points (``_OperandMm``). ``w32`` is a bf16 weight converted to f32
    once per forward (``w.float()``): autograd then sums the weight's
    gradient over every product in f32 and rounds it to bf16 once, as JAX
    casts its f32 sum to the weights' dtype."""
    return _OperandMm.apply(a, w32)


def tn(a, b):
    """sum over all rows of bf16(a)^T bf16(b), f32 sums, rounded to bf16:
    a (..., M), b (..., N) -> (M, N) bf16."""
    a = round_bf16(a.reshape(-1, a.shape[-1]))
    b = round_bf16(b.reshape(-1, b.shape[-1]))
    return (a.T @ b).to(BF16)
