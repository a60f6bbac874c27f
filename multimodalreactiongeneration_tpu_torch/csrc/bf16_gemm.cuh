// Products with bf16 operands on the tensor cores, FP32 sums: the
// weight-gradient reductions over all B*T rows of the bf16 modes of K7
// and K9, and K7's dx.
//
// It replaces no TPU kernel of its own: it is part of the bf16 operand
// mode of K7's backward (_bwd_kernel_layer in multimodalreactiongeneration
// _tpu/ops/pallas_lstm.py: dx = dgates W_ih^T, dW_ih = x^T dgates and
// dW_hh = h_prev^T dgates with both operands cast to the weights' dtype
// and preferred_element_type f32) and of K9's (_bwd_kernel_fused and the
// MRGEN_FUSED_DW=0 einsums in pallas_lstm_stacked.py). In that mode the
// 3xTF32 passes of tc_gemm.cuh are not needed: the operands are rounded
// to bf16 (to nearest, ties to even) as they are staged, so one
// mma.sync.m16n8k16 (bf16 in, FP32 accumulate) a fragment computes JAX's
// product; the reductions' split-K partials are summed in FP32 in split
// order and rounded to bf16 once, where JAX casts its f32 sum to the
// weights' dtype.
//
// Layout (a simple design; making it fast is later work). Blocks of 128
// threads compute a 64 x 64 tile of C, 32 rows of the sum at a time;
// each warp 32 x 32 as 2 x 4 m16n8 tiles, two k16 steps a stage. Each
// thread loads its four 4-element chunks of the next stage into
// registers (FP32 or bf16 sources, rounded to bf16 there) while the
// tensor cores work on this stage, then stores them to the other of two
// shared-memory stages. A tile keeps its source's orientation: k-major
// ([32][64 + 8]) or m-/n-major ([64][32 + 8]); a fragment register takes
// two 16-bit reads from a k-major tile and one 32-bit read from the
// other. The row length of a k-major operand and the K of an m-/n-major
// one are multiples of 4; FP32 sources are 16-byte aligned, bf16 ones
// 8-byte (the callers check).
//
// Fragments of m16n8k16 (g = lane / 4, q = lane % 4), each register two
// bf16, the lower k in the low half:
//   A (16 x 16): a0 (g, 2q..), a1 (g+8, 2q..), a2 (g, 2q+8..), a3 (g+8, 2q+8..)
//   B (16 x 8):  b0 (2q.., g), b1 (2q+8.., g)
//   C (16 x 8):  c0 (g, 2q), c1 (g, 2q+1), c2 (g+8, 2q), c3 (g+8, 2q+1)

#pragma once

#include "lstm_cluster_bwd.cuh"

namespace {

constexpr int BG_BM = 64, BG_BN = 64, BG_BK = 32, BG_THREADS = 128;
constexpr int BG_LDK = BG_BM + 8;  // k-major tile: [BG_BK][BG_LDK]
constexpr int BG_LDX = BG_BK + 8;  // m-/n-major tile: [64][BG_LDX]
constexpr int BG_TILE = BG_BM * BG_LDX;  // bf16 of a stage (the larger)
static_assert(BG_BM == BG_BN, "one tile shape for both operands");
static_assert(BG_BK * BG_LDK <= BG_TILE, "a k-major tile fits a stage");

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// four consecutive elements as four bf16 (rounded from FP32)
__device__ __forceinline__ uint2 load4_bf16(const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  return make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}

__device__ __forceinline__ uint2 load4_bf16(const bf16* p) {
  return *reinterpret_cast<const uint2*>(p);
}

__device__ __forceinline__ void store_c(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_c(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

// chunk j of this thread in a stage: (k, x) of its first element; k-major
// chunks run along x, m-/n-major ones along k
template <bool KMAJOR>
__device__ __forceinline__ void chunk_at(int tid, int j, int& k, int& x) {
  const int c = tid + BG_THREADS * j;  // 512 chunks of 4 elements
  k = KMAJOR ? c / 16 : (c % 8) * 4;
  x = KMAJOR ? (c % 16) * 4 : c / 8;
}

// The four chunks of a stage of operand P at (x from base, k from k0), as
// load_tile of tc_gemm.cuh addresses them: k-major, element (k, x) at
// P[k * dim + x] (with shift_t > 0 row k of the (B, T = shift_t, dim)
// array is read one step back, h0[b] at t = 0), or x-major, at P[x * K +
// k]. Chunks past k_end or dim are zeros.
template <bool KMAJOR, typename T>
__device__ __forceinline__ void load_stage(uint2 (&r)[4], const T* P,
                                           const float* h0, int shift_t,
                                           int dim, int K, int base, int k0,
                                           int k_end, int tid) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int kk, x;
    chunk_at<KMAJOR>(tid, j, kk, x);
    const int gk = k0 + kk, gx = base + x;
    if (gk >= k_end || gx >= dim)
      r[j] = make_uint2(0u, 0u);
    else if (!KMAJOR)
      r[j] = load4_bf16(P + (size_t)gx * K + gk);
    else if (shift_t > 0 && gk % shift_t == 0)
      r[j] = load4_bf16(h0 + (size_t)(gk / shift_t) * dim + gx);
    else
      r[j] = load4_bf16(P + (size_t)(shift_t > 0 ? gk - 1 : gk) * dim + gx);
  }
}

template <bool KMAJOR>
__device__ __forceinline__ void store_stage(bf16* t, const uint2 (&r)[4],
                                            int tid) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int kk, x;
    chunk_at<KMAJOR>(tid, j, kk, x);
    *reinterpret_cast<uint2*>(KMAJOR ? t + kk * BG_LDK + x
                                     : t + x * BG_LDX + kk) = r[j];
  }
}

// elements (k, x) and (k + 1, x) of a staged tile as one register
template <bool KMAJOR>
__device__ __forceinline__ uint32_t pair_at(const bf16* t, int k, int x) {
  if (KMAJOR) {
    const unsigned short* u = reinterpret_cast<const unsigned short*>(t);
    return (uint32_t)u[k * BG_LDK + x] |
           ((uint32_t)u[(k + 1) * BG_LDK + x] << 16);
  }
  return *reinterpret_cast<const uint32_t*>(t + x * BG_LDX + k);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// C[m, n] = sum over k in [k_begin, k_end) of bf16(A(m, k)) bf16(B(k, n)),
// FP32 sums, on tile (blockIdx.y, blockIdx.x), written to C + blockIdx.z
// * M * N in C's type. A_KMAJOR: A(m, k) = A[k * M + m], shifted as
// load_stage says; else A[m * K + k]. B_KMAJOR: B(k, n) = Bm[k * N + n];
// else Bm[n * K + k].
template <bool A_KMAJOR, bool B_KMAJOR, typename TA, typename TB,
          typename TC>
__global__ void __launch_bounds__(BG_THREADS) bf16_gemm_kernel(
    const TA* __restrict__ A, const float* __restrict__ h0,
    const TB* __restrict__ Bm, TC* __restrict__ C, int M, int N, int K,
    int k_per_split, int shift_t) {
  __shared__ __align__(16) bf16 As[2][BG_TILE];
  __shared__ __align__(16) bf16 Bs[2][BG_TILE];
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int m0 = blockIdx.y * BG_BM, n0 = blockIdx.x * BG_BN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int nk = max(0, (k_end - k_begin + BG_BK - 1) / BG_BK);

  uint2 ra[4], rb[4];
  auto load = [&](int kt) {
    const int k0 = k_begin + kt * BG_BK;
    load_stage<A_KMAJOR>(ra, A, h0, shift_t, M, K, m0, k0, k_end, tid);
    load_stage<B_KMAJOR>(rb, Bm, nullptr, 0, N, K, n0, k0, k_end, tid);
  };
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  if (nk > 0) {
    load(0);
    store_stage<A_KMAJOR>(As[0], ra, tid);
    store_stage<B_KMAJOR>(Bs[0], rb, tid);
  }
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load(kt + 1);  // in flight while this stage computes
    const bf16* a = As[kt & 1];
    const bf16* b = Bs[kt & 1];
#pragma unroll
    for (int ks = 0; ks < BG_BK; ks += 16) {
      uint32_t af[2][4], bfr[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm + i * 16 + g;
        af[i][0] = pair_at<A_KMAJOR>(a, ks + 2 * q, r);
        af[i][1] = pair_at<A_KMAJOR>(a, ks + 2 * q, r + 8);
        af[i][2] = pair_at<A_KMAJOR>(a, ks + 2 * q + 8, r);
        af[i][3] = pair_at<A_KMAJOR>(a, ks + 2 * q + 8, r + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = wn + j * 8 + g;
        bfr[j][0] = pair_at<B_KMAJOR>(b, ks + 2 * q, c);
        bfr[j][1] = pair_at<B_KMAJOR>(b, ks + 2 * q + 8, c);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af[i], bfr[j]);
    }
    if (kt + 1 < nk) {  // the other stage: every warp is done with it
      store_stage<A_KMAJOR>(As[(kt + 1) & 1], ra, tid);
      store_stage<B_KMAJOR>(Bs[(kt + 1) & 1], rb, tid);
    }
    __syncthreads();
  }

  TC* out = C + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // fragment elements 2h, 2h + 1: row + 8h
      const int gm = m0 + wm + i * 16 + g + 8 * h;
      if (gm >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int gn = n0 + wn + j * 8 + 2 * q + e;
          if (gn < N) store_c(out + (size_t)gm * N + gn, acc[i][j][2 * h + e]);
        }
    }
}

// out[i] = bf16(sum over s of P[s, i]), summed in split order
__global__ void __launch_bounds__(256) sum_splits_bf16_kernel(
    const float* __restrict__ P, bf16* __restrict__ out, int splits,
    size_t n) {
  const size_t i = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += P[(size_t)k * n + i];
  out[i] = __float2bfloat16(s);
}

// the alignment the stage loads need: 16 bytes for FP32, 8 for bf16
inline bool stage_aligned(const float* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}
inline bool stage_aligned(const bf16* p) {
  return reinterpret_cast<uintptr_t>(p) % 8 == 0;
}

// out (M, N) = bf16 of A'^T B over R rows, both operands rounded to bf16,
// FP32 sums (A' as reduce_rows_tn: with shift_t > 0 the one-step-shifted
// trajectory, h0 at t = 0); deterministic split-K as reduce_rows_tn_tc
template <typename TA>
int reduce_rows_tn_bf16(const TA* A, const float* h0, int shift_t,
                        const float* Bm, bf16* out, float* part, int R, int M,
                        int N, cudaStream_t stream) {
  if (M % 4 || N % 4 || !stage_aligned(A) || !stage_aligned(Bm) ||
      (shift_t > 0 && !stage_aligned(h0)))
    return (int)cudaErrorInvalidValue;
  const size_t mn = (size_t)M * N;
  const int tiles = ((M + BG_BM - 1) / BG_BM) * ((N + BG_BN - 1) / BG_BN);
  int splits = (SPLIT_TARGET_BLOCKS + tiles - 1) / tiles;
  splits = (int)std::min<size_t>(splits, PART_FLOATS / mn);
  splits = std::max(1, std::min(splits, (R + BG_BK - 1) / BG_BK));
  int rps = (R + splits - 1) / splits;
  rps = (rps + BG_BK - 1) / BG_BK * BG_BK;
  splits = (R + rps - 1) / rps;
  const dim3 grid((N + BG_BN - 1) / BG_BN, (M + BG_BM - 1) / BG_BM, splits);
  bf16_gemm_kernel<true, true, TA, float, float>
      <<<grid, BG_THREADS, 0, stream>>>(A, h0, Bm, part, M, N, R, rps,
                                        shift_t);
  int err = check_launch();
  if (err) return err;
  sum_splits_bf16_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(
      part, out, splits, mn);
  return check_launch();
}

// C (M, N) bf16 = A (M, K) @ W^T, W stored (N, K): both operands rounded
// to bf16, FP32 sums, the result rounded to bf16 (K7's dx)
int gemm_nt_bf16(const float* A, const bf16* W, bf16* C, int M, int N, int K,
                 cudaStream_t stream) {
  if (K % 4 || !stage_aligned(A) || !stage_aligned(W))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BG_BN - 1) / BG_BN, (M + BG_BM - 1) / BG_BM, 1);
  bf16_gemm_kernel<false, false, float, bf16, bf16>
      <<<grid, BG_THREADS, 0, stream>>>(A, nullptr, W, C, M, N, K, K, 0);
  return check_launch();
}

}  // namespace
