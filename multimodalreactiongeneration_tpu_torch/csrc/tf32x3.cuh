// FP32 products on the tensor cores at FP32 accuracy (3xTF32), and the
// 16-byte cp.async copies that feed them. Shared by tc_gemm.cuh (K4's,
// K7's, K9's and K10's weight gradients, K7's dx), rect_attention.cu
// (K5's forward, K6's backward) and gru.cu (K10's per-step products).
//
// Each FP32 operand x is split into hi = tf32(x) and lo = tf32(x - hi)
// (cvt.rna: round to nearest, ties away), and lo*hi + hi*lo + hi*hi is
// summed in FP32 by mma.sync.m16n8k8 (TF32 in, FP32 accumulate): the
// dropped lo*lo and the rounding of lo are ~2^-22 of a product, FP32's
// own order. Three TF32 products cost 3/495 of a TFLOP/s each, against
// FP32 SIMT at 67.
//
// Fragments of m16n8k8 (g = lane / 4, q = lane % 4), (row, column):
//   A (16 x 8): a0 (g, q), a1 (g+8, q), a2 (g, q+4), a3 (g+8, q+4)
//   B (8 x 8):  b0 (q, g), b1 (q+4, g)
//   C (16 x 8): c0 (g, 2q), c1 (g, 2q+1), c2 (g+8, 2q), c3 (g+8, 2q+1)

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));
}

// the same split by integer arithmetic, bit for bit the same for finite x:
// half of the 13 dropped mantissa bits is added to the magnitude, then
// they are cleared (round to nearest, ties away, as cvt.rna). cvt runs on
// the conversion unit at 1/8 of the FP32 rate; these run at full rate.
__device__ __forceinline__ uint32_t round_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32_alu(float x, uint32_t& hi,
                                               uint32_t& lo) {
  hi = round_tf32(x);
  lo = round_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32, the small products first
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// 16 bytes global -> shared; zeros where !ok (nothing is read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

}  // namespace
