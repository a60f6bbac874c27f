"""TF32 arithmetic of the port's tensor-core kernels, on CPU tensors.

The kernels (``csrc/tf32x3.cuh``) split each f32 operand x into hi =
tf32(x) and lo = tf32(x - hi) and sum lo*hi + hi*lo + hi*hi in f32 on
the tensor cores (3xTF32). The emulations of tests/test_torch_port_
attention_tc.py, tests/test_torch_port_gru_tc.py and tests/test_torch_
port_lstm_tc.py build on these: ``chain_product`` is a step's product of
the recurrence chains (``csrc/gru.cu``, ``csrc/lstm_recurrence.cu``),
``reduce_rows`` the split-K weight-gradient reduction over rows
(``csrc/tc_gemm.cuh reduce_rows_tn_tc``).
"""

import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 as cvt.rna.tf32.f32: add half of the 13 dropped
    mantissa bits to the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def product(a, b, passes=3):
    """a @ b from TF32 parts with FP32 sums: three passes (lo*hi + hi*lo
    + hi*hi, the kernels' order) or one (hi*hi)."""
    ah, bh = tf32(a), tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = tf32(a - ah), tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def chain_product(a, w, passes=3, splits=1):
    """a (R, K) @ w (K, N) as the chain kernels' warps sum it: K in
    ``splits`` contiguous ranges, each summed as its even k-steps (k % 4
    in {0, 1}, the kernels' permuted fragment order) plus its odd ones,
    the ranges added in order."""
    out = None
    for idx in torch.arange(a.shape[1]).chunk(splits):
        even, odd = idx[idx % 4 < 2], idx[idx % 4 >= 2]
        part = (product(a[:, even], w[even], passes)
                + product(a[:, odd], w[odd], passes))
        out = part if out is None else out + part
    return out


def reduce_rows(a, b, passes=3):
    """a (R, M)^T @ b (R, N) as ``reduce_rows_tn_tc`` sums it: the rows in
    splits of ``rps`` (its choice for the shapes), a product each, the
    partials added in split order to zero."""
    r, m = a.shape
    n = b.shape[1]
    tiles = -(-m // 64) * -(-n // 64)
    splits = min(-(-1024 // tiles), (1 << 22) // (m * n))
    splits = max(1, min(splits, -(-r // 16)))
    rps = -(-(-(-r // splits)) // 16) * 16
    out = torch.zeros(m, n)
    for s in range(0, r, rps):
        out = out + product(a[s:s + rps].T, b[s:s + rps], passes)
    return out
