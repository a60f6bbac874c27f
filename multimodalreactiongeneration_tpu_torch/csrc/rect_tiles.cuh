// The tiling machinery of rect attention's kernels, shared by both operand
// modes (rect_attention.cu: f32 on 3xTF32; attention_bf16.cu: bf16): the
// rate-aligned causal mask, the fully masked rows, the 64-key blocks of
// the backward, its dQ workspace and the key-block-order dQ sum.
//
// Semantics (ops/rect_attention.py): key j is masked for query i iff
// j*Lq >= (i+1)*Lk or both are padding; a masked logit is the finite
// -1e30, so a row whose keys are all masked averages over all Lk keys.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr float NEG = -1e30f;  // the plain path's masked logit
constexpr int KEY_BLOCK = 64;  // keys of a backward block (and a K/V tile)

// keys visible to query row i: j*Lq < (i+1)*Lk, i.e. ceil((i+1)*Lk/Lq)
__device__ __forceinline__ int visible(int i, int Lq, int Lk) {
  long long v = ((long long)(i + 1) * Lk + Lq - 1) / Lq;
  return v < Lk ? (int)v : Lk;
}

// the first key of a batch row that is not padding (Lk if none)
__device__ int first_unpadded(const unsigned char* kp, int Lk, int* s_min) {
  if (threadIdx.x == 0) *s_min = Lk;
  __syncthreads();
  for (int j = threadIdx.x; j < Lk; j += blockDim.x) {
    if (!kp[j]) {
      atomicMin(s_min, j);
      break;
    }
  }
  __syncthreads();
  return *s_min;
}

// does q tile [i0, i0+rows) hold a row whose every key is masked?
// (rows <= blockDim.x)
__device__ bool tile_has_full_row(const unsigned char* qp, int i0, int rows,
                                  int Lq, int Lk, int fu) {
  bool full = false;
  if (threadIdx.x < rows) {
    int i = i0 + threadIdx.x;
    full = i < Lq && qp[i] && fu >= visible(i, Lq, Lk);
  }
  return __syncthreads_or(full) != 0;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 4 bytes global -> shared; zero where !ok (nothing is read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

// the first q row that sees a key of block jb: floor(jb*KEY_BLOCK*Lq / Lk)
__device__ __forceinline__ int first_row(int jb, int Lq, int Lk) {
  return (int)((long long)jb * KEY_BLOCK * Lq / Lk);
}

// dQ workspace rows of the key blocks before jb (a warp-wide sum: every
// warp gets the same value)
__device__ __forceinline__ int ws_rows_before(int jb, int Lq, int Lk) {
  int s = 0;
  for (int j = threadIdx.x & 31; j < jb; j += 32) s += Lq - first_row(j, Lq, Lk);
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// dQ workspace rows of one (batch row, head): each key block's partials
// for the q rows that see its keys
inline long long ws_rows(int Lq, int Lk) {
  long long n = 0;
  for (long long jb = 0; jb * KEY_BLOCK < Lk; ++jb)
    n += Lq - jb * KEY_BLOCK * Lq / Lk;
  return n;
}

// the backward's grid (key blocks x batch x heads), its workspace rows and
// their 32-bit offsets fit
inline bool rect_shape_ok(int B, int Lq, int Lk, int E, int H) {
  if (!(B > 0 && Lq > 0 && Lk > 0 && H > 0 && E % H == 0 && B <= 65535 &&
        H <= 65535))
    return false;
  const long long nkb = (Lk + KEY_BLOCK - 1) / KEY_BLOCK;
  return nkb * B * H < (1LL << 31) && nkb * Lq < (1LL << 31);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// dQ[b, i, h*DH + d] = scale * the sum of the key blocks' partials of row
// i, in key-block order (no atomics: the bits do not change run to run),
// in dQ's type (FP32, or bf16 rounded once from the FP32 sum)
template <int DH, typename T>
__global__ void rect_attn_bwd_dq_sum(const float* __restrict__ ws,
                                     T* __restrict__ dq, int Lq, int Lk,
                                     int H, int R, float scale) {
  extern __shared__ int tab[];  // per key block: first row, workspace row
  const int nkb = (Lk + KEY_BLOCK - 1) / KEY_BLOCK;
  int* first = tab;
  int* start = tab + nkb;
  if (threadIdx.x < 32) {
    int carry = 0;
    for (int base = 0; base < nkb; base += 32) {
      const int jb = base + threadIdx.x;
      const int r = jb < nkb ? first_row(jb, Lq, Lk) : Lq;
      int n = Lq - r, incl = n;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if ((int)threadIdx.x >= o) incl += y;
      }
      if (jb < nkb) {
        first[jb] = r;
        start[jb] = carry + incl - n;
      }
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
  }
  __syncthreads();
  constexpr int C4 = DH / 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= Lq * C4) return;
  const int i = t / C4, d = (t % C4) * 4;
  const float* wb = ws + ((size_t)b * H + h) * R * DH + d;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int jb = 0; jb < nkb && first[jb] <= i; ++jb) {
    const float4 x = *reinterpret_cast<const float4*>(
        wb + (size_t)(start[jb] + i - first[jb]) * DH);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  store4(dq + ((size_t)b * Lq + i) * H * DH + h * DH + d,
         make_float4(acc.x * scale, acc.y * scale, acc.z * scale,
                     acc.w * scale));
}

template <int DH, typename T>
cudaError_t launch_dq_sum(const float* ws, T* dq, int B, int Lq, int Lk,
                          int H, int R, float scale, cudaStream_t stream) {
  const int nkb = (Lk + KEY_BLOCK - 1) / KEY_BLOCK;
  dim3 grid((Lq * (DH / 4) + 255) / 256, H, B);
  rect_attn_bwd_dq_sum<DH, T><<<grid, 256, 2 * nkb * sizeof(int), stream>>>(
      ws, dq, Lq, Lk, H, R, scale);
  return cudaGetLastError();
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace
