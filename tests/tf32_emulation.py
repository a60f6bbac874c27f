"""TF32 arithmetic of the port's tensor-core kernels, on CPU tensors.

The kernels (``csrc/tf32x3.cuh``) split each f32 operand x into hi =
tf32(x) and lo = tf32(x - hi) and sum lo*hi + hi*lo + hi*hi in f32 on
the tensor cores (3xTF32). The emulations of tests/test_torch_port_
attention_tc.py and tests/test_torch_port_gru_tc.py build on these two.
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
