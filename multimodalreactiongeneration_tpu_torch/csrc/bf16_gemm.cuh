// Products with bf16 operands on the tensor cores, FP32 sums: the
// weight-gradient reductions over all B*T rows of the bf16 modes of K7
// and K9, and K7's dx; the bf16 mode of the encoder stack's row products
// (K3's input and Dense products, K4's dy, dx and weight gradients, over
// a chunk's rows); and the batched per-head products of rect attention's
// bf16 mode (K5, K6: attention_bf16.cu).
//
// It replaces no TPU kernel of its own: it is part of the bf16 operand
// mode of K7's backward (_bwd_kernel_layer in multimodalreactiongeneration
// _tpu/ops/pallas_lstm.py: dx = dgates W_ih^T, dW_ih = x^T dgates and
// dW_hh = h_prev^T dgates with both operands cast to the weights' dtype
// and preferred_element_type f32), of K9's (_bwd_kernel_fused and the
// MRGEN_FUSED_DW=0 einsums in pallas_lstm_stacked.py), of K3's and K4's
// (_fwd_kernel and _bwd_kernel in pallas_mixer_stack.py) and of K5's and
// K6's (pallas_rect_attention.py). In that mode the 3xTF32 passes of
// tc_gemm.cuh are not needed: the operands are rounded to bf16 (to
// nearest, ties to even) as they are staged, so one mma.sync.m16n8k16
// (bf16 in, FP32 accumulate) a fragment computes JAX's product; the
// reductions' split-K partials are summed in FP32 in split order and
// rounded to bf16 once, where JAX casts its f32 sum to the weights' dtype
// (the encoder stack adds its chunks' sums in FP32 and rounds at its end).
// The encoder stack's weight-gradient reductions, whose operands are all
// FP32, stage them as tc_gemm.cuh does (FP32 tiles, cp.async three deep)
// and round them as each fragment is built (bf16_reduce_kernel): the
// register-staged kernel below measured 1.5x slower on them (PERF.md §6,
// PR 19).
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

#include "tc_gemm.cuh"

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

// two bf16 as one fragment register, the lower k in the low half
__device__ __forceinline__ uint32_t pack_bf16_raw(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
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

// Where the rows of an operand (or of the result) lie. Row r of batch z
// starts at P + b * zb + h * zh + map(r) * ld (b = z / heads, h = z %
// heads; the identity map is RowMap{IDENTITY, 0, IDENTITY}). A row is a
// k of a k-major operand, an x (m or n) of an m-/n-major one, an m of
// the result. With shift (k-major operands), row r reads plane row map(r)
// - 1, and h0's row r / map.n where map(r) is step 0 of its (B, T)
// plane: the one-step-shifted trajectory h_{t-1} of the reductions.
constexpr int IDENTITY = 1 << 30;

struct Rows {
  int ld;
  RowMap map;
  long long zb, zh;
  bool shift;
  const float* h0;
};

__host__ __device__ inline Rows dense_rows(int ld) {
  return Rows{ld, RowMap{IDENTITY, 0, IDENTITY}, 0, 0, false, nullptr};
}

// The four chunks of a stage of operand P at (x from base, k from k0):
// k-major, element (k, x) at row k, column x; or x-major, at row x,
// column k. Chunks past k_end or dim are zeros; a chunk's other three
// elements lie in its row (ld holds them).
template <bool KMAJOR, typename T>
__device__ __forceinline__ void load_stage(uint2 (&r)[4], const T* P,
                                           const Rows& o, int dim, int base,
                                           int k0, int k_end, int tid) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int kk, x;
    chunk_at<KMAJOR>(tid, j, kk, x);
    const int gk = k0 + kk, gx = base + x;
    if (gk >= k_end || gx >= dim) {
      r[j] = make_uint2(0u, 0u);
    } else if (!KMAJOR) {
      r[j] = load4_bf16(P + o.map(gx) * o.ld + gk);
    } else if (o.shift && o.map.t0 + gk % o.map.n == 0) {
      r[j] = load4_bf16(o.h0 + (size_t)(gk / o.map.n) * o.ld + gx);
    } else {
      r[j] = load4_bf16(P + (o.map(gk) - (o.shift ? 1 : 0)) * o.ld + gx);
    }
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

// The products of one launch: C = alpha * sum over k of bf16(A(m, k))
// bf16(B(k, n)), FP32 sums, (+ bias[n]) (+ D[m, n], dense (M, N)), in C's
// type. blockIdx.z = batch * splits + split: the batch selects the rows'
// offsets (Rows), the split the k range [split * k_per_split, ...) and
// C's offset split * c_split (the partials of a split-K reduction).
struct BfGemm {
  Rows a, b, c;
  const float* bias;
  const float* D;
  float alpha;
  int M, N, K, k_per_split, splits, heads;
  long long c_split;
};

// A_KMAJOR: A(m, k) at row k, column m of A; else row m, column k.
// B_KMAJOR: B(k, n) at row k, column n; else row n, column k.
template <bool A_KMAJOR, bool B_KMAJOR, typename TA, typename TB,
          typename TC>
__global__ void __launch_bounds__(BG_THREADS) bf16_gemm_kernel(
    const TA* __restrict__ A, const TB* __restrict__ Bm, TC* __restrict__ C,
    BfGemm p) {
  __shared__ __align__(16) bf16 As[2][BG_TILE];
  __shared__ __align__(16) bf16 Bs[2][BG_TILE];
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int m0 = blockIdx.y * BG_BM, n0 = blockIdx.x * BG_BN;
  const int batch = blockIdx.z / p.splits, split = blockIdx.z % p.splits;
  const int bb = batch / p.heads, bh = batch % p.heads;
  const int k_begin = split * p.k_per_split;
  const int k_end = min(p.K, k_begin + p.k_per_split);
  const int nk = max(0, (k_end - k_begin + BG_BK - 1) / BG_BK);
  A += bb * p.a.zb + bh * p.a.zh;
  Bm += bb * p.b.zb + bh * p.b.zh;

  uint2 ra[4], rb[4];
  auto load = [&](int kt) {
    const int k0 = k_begin + kt * BG_BK;
    load_stage<A_KMAJOR>(ra, A, p.a, p.M, m0, k0, k_end, tid);
    load_stage<B_KMAJOR>(rb, Bm, p.b, p.N, n0, k0, k_end, tid);
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

  TC* out = C + bb * p.c.zb + bh * p.c.zh + split * p.c_split;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // fragment elements 2h, 2h + 1: row + 8h
      const int gm = m0 + wm + i * 16 + g + 8 * h;
      if (gm >= p.M) continue;
      TC* o = out + p.c.map(gm) * p.c.ld;
      const float* d = p.D ? p.D + (size_t)gm * p.N : nullptr;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int gn = n0 + wn + j * 8 + 2 * q + e;
          if (gn >= p.N) continue;
          float v = p.alpha * acc[i][j][2 * h + e];
          if (p.bias) v += p.bias[gn];
          if (d) v += d[gn];
          store_c(o + gn, v);
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

template <bool A_KMAJOR, bool B_KMAJOR, typename TA, typename TB,
          typename TC>
int launch_bf16_gemm(const TA* A, const TB* Bm, TC* C, const BfGemm& p,
                     int batches, cudaStream_t stream) {
  const dim3 grid((p.N + BG_BN - 1) / BG_BN, (p.M + BG_BM - 1) / BG_BM,
                  batches * p.splits);
  bf16_gemm_kernel<A_KMAJOR, B_KMAJOR, TA, TB, TC>
      <<<grid, BG_THREADS, 0, stream>>>(A, Bm, C, p);
  return check_launch();
}

// The split-K reduction P[s] = A'^T B over the rows of split s (both
// operands k-major, A's rows as `ra` says, B dense (R, N)); returns the
// number of splits (the caller sums the partials in split order), or
// -1 if the operands are misaligned.
template <typename TA>
int reduce_partials_bf16(const TA* A, const Rows& ra, const float* Bm,
                         float* part, int R, int M, int N,
                         cudaStream_t stream) {
  if (M % 4 || N % 4 || !stage_aligned(A) || !stage_aligned(Bm) ||
      (ra.shift && !stage_aligned(ra.h0)))
    return -1;
  const size_t mn = (size_t)M * N;
  const int tiles = ((M + BG_BM - 1) / BG_BM) * ((N + BG_BN - 1) / BG_BN);
  int splits = (SPLIT_TARGET_BLOCKS + tiles - 1) / tiles;
  splits = (int)std::min<size_t>(splits, PART_FLOATS / mn);
  splits = std::max(1, std::min(splits, (R + BG_BK - 1) / BG_BK));
  int rps = (R + splits - 1) / splits;
  rps = (rps + BG_BK - 1) / BG_BK * BG_BK;
  splits = (R + rps - 1) / rps;
  BfGemm p{ra, dense_rows(N), dense_rows(N), nullptr, nullptr, 1.f,
           M, N, R, rps, splits, 1, (long long)mn};
  if (launch_bf16_gemm<true, true>(A, Bm, part, p, 1, stream)) return -1;
  return splits;
}

// out (M, N) = bf16 of A'^T B over R rows, both operands rounded to bf16,
// FP32 sums (A' as reduce_rows_tn: with shift_t > 0 the one-step-shifted
// trajectory of the (B, T = shift_t, M) array, h0 at t = 0);
// deterministic split-K as reduce_rows_tn_tc
template <typename TA>
int reduce_rows_tn_bf16(const TA* A, const float* h0, int shift_t,
                        const float* Bm, bf16* out, float* part, int R, int M,
                        int N, cudaStream_t stream) {
  Rows ra = dense_rows(M);
  if (shift_t > 0) {
    ra.map = RowMap{shift_t, 0, shift_t};
    ra.shift = true;
    ra.h0 = h0;
  }
  const int splits = reduce_partials_bf16(A, ra, Bm, part, R, M, N, stream);
  if (splits < 0) return (int)cudaErrorInvalidValue;
  const size_t mn = (size_t)M * N;
  sum_splits_bf16_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(
      part, out, splits, mn);
  return check_launch();
}

// The split-K partials of A'^T B for FP32 operands, both k-major (the
// encoder stack's weight gradients): tc_gemm.cuh's FP32 tiles, staged by
// cp.async three stages deep (load_tile, row maps and the shifted h_{t-1}
// included), each operand rounded to bf16 (to nearest, ties to even) as
// its fragment is built, one m16n8k16 per 16 rows of the sum. Tile (y,
// x) of split z is written to C + z * M * N; arguments as tc_gemm_kernel.
template <bool MAP>
__global__ void __launch_bounds__(TC_THREADS) bf16_reduce_kernel(
    const float* __restrict__ A, const float* __restrict__ h0,
    const float* __restrict__ Bm, float* __restrict__ C, int M, int N,
    int K, int k_per_split, int shift_t, RowMap ma) {
  static_assert(TC_BK == 16, "one m16n8k16 a stage");
  __shared__ __align__(16) float As[TC_STAGES][TC_TILE];
  __shared__ __align__(16) float Bs[TC_STAGES][TC_TILE];
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int m0 = blockIdx.y * TC_BM, n0 = blockIdx.x * TC_BN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int nk = max(0, (k_end - k_begin + TC_BK - 1) / TC_BK);

  auto load = [&](int stage, int kt) {
    const int k0 = k_begin + kt * TC_BK;
    load_tile<true, MAP>(As[stage], A, h0, shift_t, M, K, m0, k0, k_end,
                         tid, ma);
    load_tile<true>(Bs[stage], Bm, nullptr, 0, N, K, n0, k0, k_end, tid);
  };
  // elements (k, x) and (k + 1, x) of a k-major FP32 tile as two bf16
  auto pair = [](const float* t, int k, int x) {
    return pack_bf16(tile_at<true>(t, k, x), tile_at<true>(t, k + 1, x));
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
    uint32_t af[2][4], bfr[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = wm + i * 16 + g;
      af[i][0] = pair(a, 2 * q, r);
      af[i][1] = pair(a, 2 * q, r + 8);
      af[i][2] = pair(a, 2 * q + 8, r);
      af[i][3] = pair(a, 2 * q + 8, r + 8);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = wn + j * 8 + g;
      bfr[j][0] = pair(b, 2 * q, c);
      bfr[j][1] = pair(b, 2 * q + 8, c);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af[i], bfr[j]);
  }
  cp_async_wait<0>();

  float* out = C + (size_t)blockIdx.z * M * N;
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
          if (gn < N) out[(size_t)gm * N + gn] = acc[i][j][2 * h + e];
        }
    }
}

// The split-K partials of A'^T B on bf16_reduce_kernel (A' as
// load_tile reads it: with MAP, row r is row ma(r) of the A plane, with
// shift_t > 0 the row before it; without MAP and shift_t > 0 the one-step
// shifted trajectory of the (B, T = shift_t, M) array, h0 at t = 0), the
// rows split as reduce_rows_tn_tc splits them; `splits` gets the number
// of partial tiles, summed by the caller in split order.
template <bool MAP>
int reduce_partials_bf16_tc(const float* A, RowMap ma, const float* h0,
                            int shift_t, const float* Bm, float* part,
                            int R, int M, int N, int& splits,
                            cudaStream_t stream) {
  if (M % 4 || N % 4 || !aligned16(A, Bm) || (shift_t > 0 && !aligned16(h0)))
    return (int)cudaErrorInvalidValue;
  const size_t mn = (size_t)M * N;
  const int tiles = ((M + TC_BM - 1) / TC_BM) * ((N + TC_BN - 1) / TC_BN);
  splits = (SPLIT_TARGET_BLOCKS + tiles - 1) / tiles;
  splits = (int)std::min<size_t>(splits, PART_FLOATS / mn);
  splits = std::max(1, std::min(splits, (R + TC_BK - 1) / TC_BK));
  int rps = (R + splits - 1) / splits;
  rps = (rps + TC_BK - 1) / TC_BK * TC_BK;
  splits = (R + rps - 1) / rps;
  const dim3 grid((N + TC_BN - 1) / TC_BN, (M + TC_BM - 1) / TC_BM, splits);
  bf16_reduce_kernel<MAP><<<grid, TC_THREADS, 0, stream>>>(
      A, h0, Bm, part, M, N, R, rps, shift_t, ma);
  return check_launch();
}

// out (M, N) = (with acc: out +) A'^T B over the R rows of a window, both
// operands rounded to bf16, FP32 sums and an FP32 result: row r of A' is
// row ma(r) of the A plane or, with h0 not null, the row before it (h0 at
// step 0); B dense (R, N). The bf16 mode's reduce_window_tn_tc, on
// bf16_reduce_kernel; deterministic split-K as it.
int reduce_window_tn_bf16(const float* A, RowMap ma, const float* h0,
                          const float* Bm, float* out, bool acc, float* part,
                          int R, int M, int N, cudaStream_t stream) {
  int splits = 0;
  int err = reduce_partials_bf16_tc<true>(A, ma, h0, h0 ? 1 : 0, Bm, part,
                                          R, M, N, splits, stream);
  if (err) return err;
  const size_t mn = (size_t)M * N;
  sum_splits_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(
      part, out, splits, mn, acc);
  return check_launch();
}

// out (M, N) bf16 = A'^T B over R rows of FP32 operands, A' the one-step
// shifted trajectory of the (B, T = shift_t, M) array (h0 at t = 0), B
// dense (R, N): each operand rounded to bf16 at the fragments, FP32 sums
// in split order, rounded to bf16 once (the dW_hh of K8's and K10's bf16
// modes: JAX's einsum of the bf16-cast operands, preferred f32, cast to
// the weights' dtype)
int reduce_rows_tn_bf16_tc(const float* A, const float* h0, int shift_t,
                           const float* Bm, bf16* out, float* part, int R,
                           int M, int N, cudaStream_t stream) {
  int splits = 0;
  int err = reduce_partials_bf16_tc<false>(A, RowMap{}, h0, shift_t, Bm,
                                           part, R, M, N, splits, stream);
  if (err) return err;
  const size_t mn = (size_t)M * N;
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
  const BfGemm p{dense_rows(K), dense_rows(K), dense_rows(N), nullptr,
                 nullptr, 1.f, M, N, K, K, 1, 1, 0};
  return launch_bf16_gemm<false, false>(A, W, C, p, 1, stream);
}

// C (M rows, N) = bf16(A (M, K)) @ op(W) (+ bias[N]) (+ D (M, N), dense),
// FP32 sums and result: op(W) is W stored (K, N), or with trans_w the
// transpose of W stored (N, K). Row m of A is row ma(m) of the A plane,
// row m of C row mo(m) of the C plane. The bf16 mode's gemm_rows and
// gemm_tc (the encoder stack's row products).
int gemm_rows_bf16(const float* A, RowMap ma, const bf16* W,
                   const float* bias, const float* D, float* C, RowMap mo,
                   int M, int N, int K, bool trans_w, cudaStream_t stream) {
  if (K % 4 || N % 4 || !stage_aligned(A) || !stage_aligned(W))
    return (int)cudaErrorInvalidValue;
  const Rows ra{K, ma, 0, 0, false, nullptr}, rc{N, mo, 0, 0, false, nullptr};
  const BfGemm p{ra, dense_rows(trans_w ? K : N), rc, bias, D, 1.f,
                 M, N, K, K, 1, 1, 0};
  return trans_w ? launch_bf16_gemm<false, false>(A, W, C, p, 1, stream)
                 : launch_bf16_gemm<false, true>(A, W, C, p, 1, stream);
}

}  // namespace
