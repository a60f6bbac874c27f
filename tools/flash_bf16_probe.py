#!/usr/bin/env python3
"""Would rect attention's f32 flash kernels, instantiated on bf16
operands, hold the bf16 mode's gate?

``csrc/rect_attention.cu`` streams 64-key tiles with an online softmax:
its forward rounds the unnormalized weights exp(s - running max) for the
product with V and divides by the row sum at the end, and its backward
takes D = rowsum(dO o O) from the forward's output. JAX's bf16 kernels
(``ops/pallas_rect_attention.py``) round the normalized weights and take
D = rowsum(dw o w). This script writes both roundings out in plain
PyTorch (``flash_bf16`` here; ``rect_attention_bf16_reference`` in the
port) on the same bf16 q, k, v and masks as ``chip_smoke.py``'s
``bf16_attention_case`` (B32 x 252 x {2016, 252} x 4 heads, E 256, 10%
padded rows and keys, f32 cotangent), and reports what that case's
``bf16_check`` would read for a kernel computing ``flash_bf16``: the
context's largest error (``BF16_ATTN_TOL`` 1e-2), the bf16 gradients'
largest error relative to their largest magnitude (1e-2), and the
distance test, the context's mean error over the plain f32 version's
mean distance from the plain bf16 one (at most ``BF16_MODE_FRAC`` 0.25).

    python3 tools/flash_bf16_probe.py [--device cpu|cuda] [--batch 32]

The last line is one JSON object with the readings at each Lk.
"""
import argparse
import json
import math
import sys

import numpy as np
import torch

sys.path.insert(0, ".")

from multimodalreactiongeneration_tpu_torch.ops import (  # noqa: E402
    rect_attention as K5,
)
from multimodalreactiongeneration_tpu_torch.ops.lstm_bf16 import (  # noqa: E402
    round_bf16,
)

TILE = 64  # keys per tile of csrc/rect_attention.cu
HEADS, E, LQ = 4, 256, 252


def flash_bf16_forward(q, k, v, mask):
    """The online-softmax forward on bf16 operands: per 64-key tile the
    running max m, p = exp(s - m) in f32, the row sum of the unrounded p,
    the context accumulated from bf16(p) V and rescaled as m grows; the
    context divided by the row sum at the end. q, k, v (B, H, L, Dh) f32
    holding bf16 values; mask (B, 1, Lq, Lk) True where masked."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    b, h, lq, dh = q.shape
    m = torch.full((b, h, lq, 1), -math.inf, device=q.device)
    l = torch.zeros(b, h, lq, 1, device=q.device)
    acc = torch.zeros(b, h, lq, dh, device=q.device)
    for j in range(0, k.shape[2], TILE):
        s = q @ k[:, :, j:j + TILE].transpose(-1, -2) * scale
        s = s.masked_fill(mask[..., j:j + TILE], K5.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + round_bf16(p) @ v[:, :, j:j + TILE]
        m = m_new
    return acc / l


def flash_bf16(q, k, v, q_pad, k_pad, g):
    """(context, dq, dk, dv) of the flash kernels on bf16 operands: the
    forward above; the backward from the normalized weights w recomputed
    in f32, g rounded to bf16, D = rowsum(bf16(g) o context), ds = w (dw -
    D) zero where masked and rounded to bf16 for dq and dk, dv = bf16(w)^T
    bf16(g); the gradients rounded to bf16."""
    split = lambda x: K5._heads(HEADS, x)  # noqa: E731
    qh, kh, vh = split(q), split(k), split(v)
    w, mask = K5._weights(HEADS, q, k, q_pad, k_pad)
    ctx = flash_bf16_forward(qh, kh, vh, mask)
    gr = round_bf16(split(g))
    dw = gr @ vh.transpose(-1, -2)
    d = (gr * ctx).sum(-1, keepdim=True)
    ds = round_bf16((w * (dw - d)).masked_fill(mask, 0.0))
    scale = 1.0 / math.sqrt(qh.shape[-1])
    grads = (ds @ kh * scale, ds.transpose(-1, -2) @ qh * scale,
             round_bf16(w).transpose(-1, -2) @ gr)
    return K5._merge(ctx), [K5._merge(x).to(torch.bfloat16) for x in grads]


def case(rng, dev, b, lk):
    """The inputs of chip_smoke.py's bf16_attention_case at (b, lk)."""
    r = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(dev)
    q, k, v, g = (r(b, LQ, E).to(torch.bfloat16), r(b, lk, E).to(
        torch.bfloat16), r(b, lk, E).to(torch.bfloat16), r(b, LQ, E))
    q_pad = torch.from_numpy(rng.random((b, LQ)) < 0.1).to(dev)
    k_pad = torch.from_numpy(rng.random((b, lk)) < 0.1).to(dev)
    return q, k, v, q_pad, k_pad, g


def readings(q, k, v, q_pad, k_pad, g):
    with torch.no_grad():
        want = K5.rect_attention_bf16_reference(HEADS, q, k, v, q_pad, k_pad)
        ctx32 = K5.rect_attention_reference(HEADS, q.float(), k.float(),
                                            v.float(), q_pad, k_pad)
        ctx, grads = flash_bf16(q, k, v, q_pad, k_pad, g)
    wgrads = K5.rect_attention_backward_reference(HEADS, q, k, v, q_pad,
                                                  k_pad, g)
    gap = float((ctx32 - want).abs().mean())
    err = float((ctx - want).abs().mean())
    return dict(
        fwd_max_abs_err=float((ctx - want).abs().max()),
        grad_bf16_max_rel_err=max(
            float((x.float() - w.float()).abs().max() / w.float().abs().max())
            for x, w in zip(grads, wgrads)),
        ys_mean_abs_err=err, plain_f32_vs_bf16_ys_mean=gap,
        distance_ratio=err / gap)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda" if torch.cuda.is_available()
                    else "cpu")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args()
    rng = np.random.default_rng(a.seed)
    out = {}
    for lk in (8 * LQ, LQ):
        out[lk] = readings(*case(rng, torch.device(a.device), a.batch, lk))
        print(f"Lk {lk}:", out[lk], flush=True)
    print(json.dumps({"device": a.device, "batch": a.batch, "readings": out}))


if __name__ == "__main__":
    main()
