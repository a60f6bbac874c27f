// bf16 tensor-core fragments: mma.sync.m16n8k16 (bf16 in, FP32
// accumulate), the packing of two FP32 values into one fragment register,
// and ldmatrix loads of fragments from shared memory. Shared by
// bf16_gemm.cuh (the bf16 modes' row products and reductions) and
// attention_bf16.cu (K5/K6's bf16 mode).
//
// Fragments of m16n8k16 (g = lane / 4, q = lane % 4), each register two
// bf16, the lower k in the low half:
//   A (16 x 16): a0 (g, 2q..), a1 (g+8, 2q..), a2 (g, 2q+8..), a3 (g+8, 2q+8..)
//   B (16 x 8):  b0 (2q.., g), b1 (2q+8.., g)
//   C (16 x 8):  c0 (g, 2q), c1 (g, 2q+1), c2 (g+8, 2q), c3 (g+8, 2q+1)
// So the C fragments of two adjacent n8 tiles are, packed, the A fragment
// of one k16 step: (c0, c1) of tile 2t -> a0, (c2, c3) -> a1, those of
// tile 2t + 1 -> a2, a3.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8 x 8 bf16 matrices from shared memory: lanes 8i..8i+7 give the
// row addresses (16-byte aligned) of matrix i, and register i receives
// matrix i, lane l holding row l / 4, columns 2(l % 4) and 2(l % 4) + 1
// (with .trans: column l / 4, rows 2(l % 4) and 2(l % 4) + 1).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// two matrices (lanes 0-15 give the addresses), transposed
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(a)
      : "memory");
}

}  // namespace
