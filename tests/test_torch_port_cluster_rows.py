"""PyTorch port: the rows per cluster of the LSTM chains K7 and K9, and
the 3xTF32 method of their weight-gradient reductions, on the CPU.

``choose_rows`` is the plain function the wrappers call with what the
card reports (clusters it holds at once, shared memory per CTA). The
3xTF32 product is emulated with TF32 rounding by bit masking (round to
nearest, ties away from zero, as ``cvt.rna.tf32.f32``) and FP32 sums, and
held against a float64 product on sums that cancel the way dW_hh's do.
"""

import numpy as np
import pytest
import torch

from multimodalreactiongeneration_tpu_torch.ops.cluster_rows import (
    SMEM_LIMIT,
    choose_rows,
    resolve_rows,
)

GRAD_REL_TOL = 1e-3  # the gradients' gate: max error / max |exact|

# shared memory per CTA by rows (the formulas of csrc/lstm_cluster.cuh and
# csrc/lstm_stacked.cu): K7's chains at H256, K9's at L2 and L3
K7_H256 = {16: 172032, 24: 192512, 32: 212992}
K9_L2 = {16: 139264, 24: 159744, 32: 180224}
K9_L3 = {16: 225280, 24: 256000, 32: 286720}
ALL = {16: 15, 24: 15, 32: 15}  # an H100 holds 15 of these clusters


@pytest.mark.parametrize("batch,resident,smem,want", [
    (256, ALL, K7_H256, 24),      # lws blocks: 11 clusters, one wave
    (256, ALL, K9_L2, 24),        # lws sampler
    (32, ALL, K7_H256, 16),       # the Metaformer's self-motion LSTMs
    (16, ALL, K9_L2, 16),         # lws generation warmup
    (240, ALL, K9_L2, 16),        # 15 clusters of 16 fit
    (256, {16: 15}, K9_L3, 16),   # L3 takes no more rows: waves
    (257, ALL, K9_L2, 24),        # ragged: 11 clusters, the last of 17 rows
    (241, ALL, K7_H256, 24),      # ragged: the last cluster of 1 row
    (400, ALL, K7_H256, 32),      # 17 clusters of 24 would not fit
    (600, ALL, K9_L2, 16),        # nothing fits: R 16 in waves
    (256, {16: 31, 24: 31, 32: 31}, K7_H256, 16),  # a card holding more
])
def test_choose_rows(batch, resident, smem, want):
    assert choose_rows(batch, resident, smem) == want


@pytest.mark.parametrize("resident", [{16: 0, 24: 15, 32: 15},
                                      {16: 15, 24: 0, 32: 15}])
def test_choose_rows_raises_without_a_resident_cluster(resident):
    with pytest.raises(ValueError, match="holds 0 clusters"):
        choose_rows(400, resident, K7_H256)


def test_choose_rows_raises_on_no_batch():
    with pytest.raises(ValueError, match="batch 0"):
        choose_rows(0, ALL, K7_H256)


def test_resolve_rows():
    layout = ({16: 15}, K9_L3)
    assert resolve_rows("k9", 256, None, layout) == 16
    assert resolve_rows("k9", 256, 16, layout) == 16
    with pytest.raises(ValueError, match="k9: no kernel for 24 rows.*"
                       f"more than {SMEM_LIMIT}"):
        resolve_rows("k9", 256, 24, layout)
    with pytest.raises(ValueError, match="k7: no kernel for 20 rows"):
        resolve_rows("k7", 256, 20, (ALL, K7_H256))


def tf32(x: np.ndarray) -> np.ndarray:
    """float32 rounded to TF32 (10-bit mantissa) as cvt.rna.tf32.f32: add
    half of the 13 dropped bits to the magnitude, then clear them."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def product_tn(a, b, passes):
    """a^T b over the rows in FP32 sums of TF32 products: one pass
    (hi*hi) or three (lo*hi + hi*lo + hi*hi, the kernel's order)."""
    ah, bh = tf32(a), tf32(b)
    if passes == 1:
        return torch.from_numpy(ah).T @ torch.from_numpy(bh)
    al, bl = tf32(a - ah), tf32(b - bh)
    t = lambda x: torch.from_numpy(x)
    return t(al).T @ t(bh) + t(ah).T @ t(bl) + t(ah).T @ t(bh)


def cancelling_rows(seed, rows, m, n, eps=1e-3):
    """(h, dgates) shaped like dW_hh's operands (rows = B*T, H, 4H),
    zero-mean and paired: row 2i+1 repeats row 2i's h with the negated
    dgates plus eps of new ones, so the exact sum is eps of the sum of
    |terms|."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((rows // 2, m)).astype(np.float32)
    d = rng.standard_normal((rows // 2, n)).astype(np.float32)
    e = rng.standard_normal((rows // 2, n)).astype(np.float32)
    hh = np.stack([h, h], 1).reshape(rows, m)
    dd = np.stack([d, -d + np.float32(eps) * e], 1).reshape(rows, n)
    return hh, dd.astype(np.float32)


@pytest.mark.parametrize("seed,rows,m,n", [
    (0, 4096, 16, 64), (1, 8960, 32, 128), (2, 2240, 64, 256),
])
def test_3xtf32_holds_the_gradient_gate_where_tf32_does_not(seed, rows, m,
                                                           n):
    h, d = cancelling_rows(seed, rows, m, n)
    exact = h.astype(np.float64).T @ d.astype(np.float64)
    scale = np.abs(exact).max()

    def err(got):
        return np.abs(got.double().numpy() - exact).max() / scale

    assert err(product_tn(h, d, 3)) <= GRAD_REL_TOL / 5
    assert err(product_tn(h, d, 1)) > GRAD_REL_TOL


def test_tf32_rounds_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)  # TF32's spacing at 1
    x = np.array([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - ulp / 8,
                  one + ulp * 3 / 4], dtype=np.float32)
    np.testing.assert_array_equal(
        tf32(x), np.array([one + ulp, -(one + ulp), one, one + ulp],
                          dtype=np.float32))
    # a TF32 value is its own rounding, and hi + lo recovers x to ~2^-21
    y = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    hi = tf32(y)
    np.testing.assert_array_equal(tf32(hi), hi)
    rest = tf32(y - hi)
    assert np.abs(hi + rest - y).max() <= 2.0 ** -21 * np.abs(y).max()
