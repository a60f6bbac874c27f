// FP32 products on the tensor cores in 3xTF32: the weight-gradient
// reductions over all B*T rows of K7's, K9's and K10's backward, K7's dx,
// and K4's weight-gradient reductions, dy and dx over a chunk's rows.
//
// It replaces no TPU kernel of its own: it is part of K7's backward
// (_bwd_kernel_layer in multimodalreactiongeneration_tpu/ops/
// pallas_lstm.py, whose weight gradients the JAX package takes as
// einsums at Precision.HIGHEST), of K9's (_bwd_kernel_fused in
// pallas_lstm_stacked.py), of K4's (_bwd_kernel in pallas_mixer_stack.py)
// and of K10's (the dW_hh einsum of _bwd_impl in pallas_gru.py).
//
// Why 3xTF32 (tf32x3.cuh). The weight gradients are sums over 10^4 to
// 3 x 10^5 rows of products of both signs, and they cancel heavily: one
// TF32 pass (10-bit mantissas) misses the 1e-3 gate.
//
// Layout. Blocks of 128 threads compute a 64 x 64 tile of C, 16 rows of
// the sum at a time; each warp computes 32 x 32 as 2 x 4 m16n8 tiles.
// Tiles come from device memory by cp.async, 16 bytes a thread, three
// stages deep, so the next tiles' loads are in flight while the tensor
// cores work. A tile is kept as its operand is stored: k-major (rows of
// the sum, padded to 72 floats) or m-/n-major (16 floats of the sum,
// padded to 20); both pads leave the fragment reads free of bank
// conflicts. A reduction (TN) splits its rows over the grid's z and
// writes one partial tile per split; the partials are then summed in
// split order (sum_splits_kernel), so the result is the same from run to
// run. Operands are read 4 floats at a time: the row length of a k-major
// operand and the K of an m-/n-major one are multiples of 4, and every
// pointer is 16-byte aligned (the callers check).

#pragma once

#include "lstm_cluster_bwd.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int TC_BM = 64, TC_BN = 64, TC_BK = 16, TC_THREADS = 128;
constexpr int TC_STAGES = 3;
constexpr int TC_LDK = TC_BM + 8;  // k-major tile: [TC_BK][TC_LDK]
constexpr int TC_LDX = TC_BK + 4;  // m-/n-major tile: [64][TC_LDX]
constexpr int TC_TILE = TC_BM * TC_LDX;  // floats of a stage (the larger)
static_assert(TC_BM == TC_BN, "one tile shape for both operands");

// element (k, x) of a staged tile, x the row of A (m) or column of B (n)
template <bool KMAJOR>
__device__ __forceinline__ float tile_at(const float* t, int k, int x) {
  return KMAJOR ? t[k * TC_LDK + x] : t[x * TC_LDX + k];
}

// Stage the 64 x 16 tile of operand P at (x from base, k from k0): P is
// k-major (element (k, x) at P[k * dim + x]; with shift_t > 0 row k of
// the (B, T = shift_t, dim) array is read one step back, h0[b] at t = 0)
// or x-major (element (k, x) at P[x * K + k]). With MAP (k-major), row k
// is row mk(k) of the P plane, with shift_t > 0 the row before it (h0[k
// / mk.n] at step 0 of the plane). Rows k >= k_end and x >= dim are
// zeros.
template <bool KMAJOR, bool MAP = false>
__device__ __forceinline__ void load_tile(float* t, const float* P,
                                          const float* h0, int shift_t,
                                          int dim, int K, int base, int k0,
                                          int k_end, int tid,
                                          RowMap mk = RowMap{}) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int i = tid + TC_THREADS * c;  // 256 chunks of 4 floats
    const int kk = KMAJOR ? i / 16 : (i % 4) * 4;
    const int x = KMAJOR ? (i % 16) * 4 : i / 4;
    const int gk = k0 + kk, gx = base + x;
    const bool ok = gk < k_end && gx < dim;
    const float* src = P;
    if (ok) {
      if (!KMAJOR)
        src = P + (size_t)gx * K + gk;
      else if (MAP && shift_t > 0 && mk.t0 + gk % mk.n == 0)
        src = h0 + (size_t)(gk / mk.n) * dim + gx;
      else if (MAP)
        src = P + (mk(gk) - (shift_t > 0)) * dim + gx;
      else if (shift_t > 0 && gk % shift_t == 0)
        src = h0 + (size_t)(gk / shift_t) * dim + gx;
      else
        src = P + (size_t)(shift_t > 0 ? gk - 1 : gk) * dim + gx;
    }
    cp_async16(KMAJOR ? t + kk * TC_LDK + x : t + x * TC_LDX + kk, src, ok);
  }
}

// C[m, n] = sum over k in [k_begin, k_end) of A(m, k) B(k, n) (+ bias[n]),
// on tile (blockIdx.y, blockIdx.x), written to C + blockIdx.z * M * N.
// A_KMAJOR: A(m, k) = A[k * M + m], shifted as load_tile says; else
// A[m * K + k]; A_MAP (with A_KMAJOR): row k of A is row ma(k) of the A
// plane, as load_tile says. B_KMAJOR: B(k, n) = Bm[k * N + n]; else
// Bm[n * K + k]. D (M, N), if not null, is added; row m of C is row
// mo(m) of the C plane.
template <bool A_KMAJOR, bool B_KMAJOR, bool A_MAP = false>
__global__ void __launch_bounds__(TC_THREADS) tc_gemm_kernel(
    const float* __restrict__ A, const float* __restrict__ h0,
    const float* __restrict__ Bm, const float* __restrict__ bias,
    float* __restrict__ C, int M, int N, int K, int k_per_split,
    int shift_t, RowMap ma, const float* __restrict__ D, RowMap mo) {
  __shared__ __align__(16) float As[TC_STAGES][TC_TILE];
  __shared__ __align__(16) float Bs[TC_STAGES][TC_TILE];
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;  // groupID, thread in group
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int m0 = blockIdx.y * TC_BM, n0 = blockIdx.x * TC_BN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int nk = max(0, (k_end - k_begin + TC_BK - 1) / TC_BK);

  auto load = [&](int stage, int kt) {
    const int k0 = k_begin + kt * TC_BK;
    load_tile<A_KMAJOR, A_MAP>(As[stage], A, h0, shift_t, M, K, m0, k0,
                               k_end, tid, ma);
    load_tile<B_KMAJOR>(Bs[stage], Bm, nullptr, 0, N, K, n0, k0, k_end, tid);
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();  // tile kt landed; every warp is done with kt - 1's
    const int next = kt + TC_STAGES - 1;
    if (next < nk) load(next % TC_STAGES, next);
    cp_async_commit();
    const float* a = As[kt % TC_STAGES];
    const float* b = Bs[kt % TC_STAGES];
#pragma unroll
    for (int k8 = 0; k8 < TC_BK; k8 += 8) {
      uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm + i * 16 + g;
        split_tf32(tile_at<A_KMAJOR>(a, k8 + q, r), ah[i][0], al[i][0]);
        split_tf32(tile_at<A_KMAJOR>(a, k8 + q, r + 8), ah[i][1], al[i][1]);
        split_tf32(tile_at<A_KMAJOR>(a, k8 + q + 4, r), ah[i][2], al[i][2]);
        split_tf32(tile_at<A_KMAJOR>(a, k8 + q + 4, r + 8), ah[i][3],
                   al[i][3]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = wn + j * 8 + g;
        split_tf32(tile_at<B_KMAJOR>(b, k8 + q, c), bh[j][0], bl[j][0]);
        split_tf32(tile_at<B_KMAJOR>(b, k8 + q + 4, c), bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_3xtf32(acc[i][j], ah[i], al[i], bh[j], bl[j]);
    }
  }
  cp_async_wait<0>();

  float* out = C + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // fragment elements 2h, 2h + 1: row + 8h
      const int gm = m0 + wm + i * 16 + g + 8 * h;
      if (gm >= M) continue;
      float* o = out + mo(gm) * N;
      const float* d = D ? D + (size_t)gm * N : nullptr;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int gn = n0 + wn + j * 8 + 2 * q + e;
          if (gn < N) {
            float v = acc[i][j][2 * h + e] + (bias ? bias[gn] : 0.f);
            if (d) v += d[gn];
            o[gn] = v;
          }
        }
    }
}

// every pointer 16-byte aligned (the tiles are read 16 bytes at a time)
template <typename... P>
bool aligned16(const P*... p) {
  return ((reinterpret_cast<uintptr_t>(p) % 16 == 0) && ...);
}

template <bool MAP>
int reduce_rows_tn_tc_impl(const float* A, RowMap ma, const float* h0,
                           int shift_t, const float* Bm, float* out,
                           bool acc, float* part, int R, int M, int N,
                           cudaStream_t stream) {
  if (M % 4 || N % 4 || !aligned16(A, Bm) || (shift_t > 0 && !aligned16(h0)))
    return (int)cudaErrorInvalidValue;
  const size_t mn = (size_t)M * N;
  const int tiles = ((M + TC_BM - 1) / TC_BM) * ((N + TC_BN - 1) / TC_BN);
  int splits = (SPLIT_TARGET_BLOCKS + tiles - 1) / tiles;
  splits = (int)std::min<size_t>(splits, PART_FLOATS / mn);
  splits = std::max(1, std::min(splits, (R + TC_BK - 1) / TC_BK));
  int rps = (R + splits - 1) / splits;
  rps = (rps + TC_BK - 1) / TC_BK * TC_BK;
  splits = (R + rps - 1) / rps;
  const dim3 grid((N + TC_BN - 1) / TC_BN, (M + TC_BM - 1) / TC_BM, splits);
  tc_gemm_kernel<true, true, MAP><<<grid, TC_THREADS, 0, stream>>>(
      A, h0, Bm, nullptr, part, M, N, R, rps, shift_t, ma, nullptr,
      RowMap{M, 0, M});
  int err = check_launch();
  if (err) return err;
  sum_splits_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(
      part, out, splits, mn, acc);
  return check_launch();
}

// out (M, N) = A'^T B over R rows, 3xTF32 (A' as in reduce_rows_tn)
int reduce_rows_tn_tc(const float* A, const float* h0, int shift_t,
                      const float* Bm, float* out, float* part, int R, int M,
                      int N, cudaStream_t stream) {
  return reduce_rows_tn_tc_impl<false>(A, RowMap{}, h0, shift_t, Bm, out,
                                       false, part, R, M, N, stream);
}

// out (M, N) = (with acc: out +) A'^T B over the R rows of a window, in
// 3xTF32: row r of A' is row ma(r) of the A plane or, with h0 not null,
// the row before it (h0 at step 0); B dense (R, N)
int reduce_window_tn_tc(const float* A, RowMap ma, const float* h0,
                        const float* Bm, float* out, bool acc, float* part,
                        int R, int M, int N, cudaStream_t stream) {
  return reduce_rows_tn_tc_impl<true>(A, ma, h0, h0 ? 1 : 0, Bm, out, acc,
                                      part, R, M, N, stream);
}

// C (M rows, N) = A (M, K) @ op(W) (+ bias[N]) (+ D (M, N), dense), in
// 3xTF32; op(W) is W stored (K, N), or with trans_w the transpose of W
// stored (N, K). Row m of C is row mo(m) of the C plane (RowMap{M, 0, M}:
// C dense).
int gemm_tc(const float* A, const float* W, const float* bias,
            const float* D, float* C, RowMap mo, int M, int N, int K,
            bool trans_w, cudaStream_t stream) {
  if (K % 4 || (!trans_w && N % 4) || !aligned16(A, W))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + TC_BN - 1) / TC_BN, (M + TC_BM - 1) / TC_BM, 1);
  if (trans_w)
    tc_gemm_kernel<false, false><<<grid, TC_THREADS, 0, stream>>>(
        A, nullptr, W, bias, C, M, N, K, K, 0, RowMap{}, D, mo);
  else
    tc_gemm_kernel<false, true><<<grid, TC_THREADS, 0, stream>>>(
        A, nullptr, W, bias, C, M, N, K, K, 0, RowMap{}, D, mo);
  return check_launch();
}

}  // namespace
