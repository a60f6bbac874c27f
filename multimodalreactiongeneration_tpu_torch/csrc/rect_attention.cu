// Rectangular-causal + pad-pair multi-head attention, forward and backward.
//
// Replaces, in multimodalreactiongeneration_tpu/ops/pallas_rect_attention.py
// (rect_attention):
//   rect_attention_forward_f32    _fwd_kernel  (_rect_attention_fwd_impl)
//   rect_attention_backward_f32   _bwd_kernel  (_rect_attention_bwd_impl)
//
// Semantics (the plain version, ops/rect_attention.py): key j is masked
// for query i iff j*Lq >= (i+1)*Lk (rate-aligned causal) or both are
// padding; masked logits take the finite -1e30, so a row whose keys are
// all masked is the uniform average over all Lk keys; softmax and sums in
// f32. Operands stay in the projection layout: q (B, Lq, E), k/v
// (B, Lk, E), head h in columns [h*Dh, (h+1)*Dh); the context lands in
// (B, Lq, E) with no head transposes.
//
// Bound, at the flagship audio integrator (B32, Lq 252, Lk 2016, E 256,
// 4 heads, Dh 64): the forward does 4*B*H*Lq*Lk*Dh = 16.6 GFLOP dense, 8.3
// GFLOP over the keys the causal mask leaves. On the tensor cores in
// 3xTF32 that is three TF32 passes at 495 TFLOP/s (0.05 ms); it moves q,
// k, v and the context once, ~150 MB against 3.35 TB/s (0.045 ms). The
// backward's five products, 10 FLOPs per visible (query, key) pair and
// head dim, are 20.8 GFLOP: 0.126 ms as three TF32 passes at 495 TFLOP/s
// (0.31 ms as FP32 FMAs at 67).
//
// Design. The TPU kernel keeps a 128-row q block's logits for the whole
// key range in VMEM (~1 MB per head); no SM holds that. So:
//   * forward: one block of 4 warps per (q tile of 64 rows, head, batch);
//     each warp owns 16 q rows and streams 64-key tiles of K and V with
//     an online softmax (running max and sum in registers, FP32), and
//     the block stops at the last key the causal mask leaves visible to
//     the tile, about half the audio keys. A tile that holds a fully
//     masked row reads every key, since that row averages over all of
//     them. Key columns past Lk are excluded outright, not given -1e30.
//     Under grad it writes each row's max and sum, (B, H, Lq) each, for
//     the backward. Both products, S = Q K^T and O += P V, run on the
//     tensor cores in 3xTF32 (tf32x3.cuh: mma.sync.m16n8k8, FP32
//     accumulation in a fixed order), so the result holds to the f32
//     plain path. The warp keeps its Q fragments (hi and lo) in
//     registers for the whole key loop. K and V tiles stream through a
//     two-stage ring in shared memory by 16-byte cp.async, so tile j+1
//     loads while tile j is multiplied. P never leaves registers: the
//     accumulator of S holds keys 2q and 2q+1 of each 8-key group in
//     thread q of a quad, and P V reads them as the A fragment's columns
//     q and q+4, with V's rows taken in the same order (a permutation of
//     the sum over keys). Shared rows are Dh+4 floats, so the fragment
//     reads of K (row g, column q) and of V (rows 2q, 2q+1, column g) hit
//     32 different banks. Blocks of the longest key ranges start first;
//   * backward: D = rowsum(dO * O) in a small pre-pass; then one block
//     of 4 warps per (64-key block, head, batch), the blocks of the
//     longest q range first. K (split once into TF32 hi and lo) and V
//     stay in shared memory; the block streams the 16-row q tiles that
//     see its keys (rows from floor(j0*Lq/Lk) on) through a two-stage
//     cp.async ring: Q, dO, and the rows' max, sum and D. Each warp owns
//     16 keys and computes S^T = K Q^T and dP^T = V dO^T once per (q
//     tile, key block) pair, P^T from the forward's max and sum, dS^T =
//     P^T (dP^T - D), zero where the mask is set (as autograd through the
//     plain masked_fill gives it), and keeps dV += P^T dO and dK += dS^T
//     Q in registers; P^T and dS^T feed those products from registers by
//     the forward's permutation of the sum (q rows 2q, 2q+1 as columns
//     q, q+4). A q tile before the block's first seeing row is visited
//     only if it holds a row whose every key is masked: that row
//     averages over all Lk keys, so it adds to dV alone. dQ: dS goes to
//     shared memory (rows of 72 floats: the A fragments load as float2
//     without bank conflicts), each warp takes a quarter of the tile's
//     dS K, and the block's partial dQ lands in a workspace, rows from
//     floor(j0*Lq/Lk) on only (134 MB at the flagship audio shape); a
//     second kernel sums each row's partials in key-block order. No
//     atomics: the result is the same bits run to run. All five products
//     are 3xTF32 on mma.sync; the operands are split by integer rounding
//     (tf32x3.cuh split_tf32_alu, the bits of cvt.rna at full ALU rate),
//     and each product's B fragments are loaded and split before its
//     MMAs. 16 q rows a step, three blocks an SM (74.6 KB of shared
//     memory, at most 170 registers a thread) came from a sweep over 16,
//     32 and 64 rows, two and three stages, 4 and 8 warps; so did the
//     dQ route (PERF.md): at B32 x 252 x 2016 on an H100 SXM (700 W), a
//     second pass that recomputed S and dP for dQ alone (seven products)
//     took 1.06 ms against 0.73.

#include <cuda_runtime.h>
#include <math.h>

#include "rect_tiles.cuh"

namespace {

// forward: FQ_WARPS warps of 16 q rows, FK-key tiles, F_STAGES in flight
// (measured against 8 warps of a 128-row tile and against 3 stages: both
// slower at the flagship's audio shape)
constexpr int FQ_WARPS = 4;
constexpr int FQ = 16 * FQ_WARPS;
constexpr int FK = 64;
constexpr int F_THREADS = 32 * FQ_WARPS;
constexpr int F_STAGES = 2;

// backward (K6): BW warps of 16 keys (BK keys a block), BQ q rows a step,
// B_STAGES stages of Q and dO in flight, three blocks an SM (at most 170
// registers a thread); chosen by a sweep (PERF.md)
constexpr int BW = 4;
constexpr int BK = 16 * BW;
static_assert(BK == KEY_BLOCK && FK == KEY_BLOCK, "rect_tiles.cuh's blocks");
constexpr int BQ = 16;
constexpr int B_STAGES = 2;
constexpr int B_THREADS = 32 * BW;
constexpr int B_MIN_BLOCKS = 3;

// keys [j0, j0+FK) of one head's columns of k and v into a ring stage
// (rows of DH+4 floats) by cp.async; rows past Lk are zeros
template <int DH>
__device__ __forceinline__ void load_kv(float* ks, float* vs, const float* kb,
                                        const float* vb, int j0, int Lk,
                                        int E, int col0) {
  constexpr int LDF = DH + 4, CPR = DH / 4;  // 16-byte chunks per row
#pragma unroll
  for (int c = threadIdx.x; c < FK * CPR; c += F_THREADS) {
    const int r = c / CPR, d = (c % CPR) * 4, row = j0 + r;
    const bool ok = row < Lk;
    const size_t at = ok ? (size_t)row * E + col0 + d : 0;
    cp_async16(ks + r * LDF + d, kb + at, ok);
    cp_async16(vs + r * LDF + d, vb + at, ok);
  }
}

template <int DH>
__global__ void __launch_bounds__(F_THREADS, 2)
    rect_attn_fwd(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v,
                  const unsigned char* __restrict__ qpad,
                  const unsigned char* __restrict__ kpad,
                  float* __restrict__ out, float* __restrict__ mrow,
                  float* __restrict__ lrow, int Lq, int Lk, int H,
                  float scale) {
  constexpr int LDF = DH + 4;    // shared row stride
  constexpr int KS = DH / 8;     // k-steps of Q K^T
  constexpr int NT = FK / 8;     // 8-key groups of a tile
  constexpr int DT = DH / 8;     // 8-column groups of O
  constexpr int STAGE = 2 * FK * LDF;  // floats of a ring stage (K, V)
  extern __shared__ __align__(16) float ring[];
  __shared__ int s_fu;
  const int i0 = (gridDim.x - 1 - blockIdx.x) * FQ;  // longest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int E = H * DH, col0 = h * DH;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const float* qb = q + (size_t)b * Lq * E;
  const float* kb = k + (size_t)b * Lk * E;
  const float* vb = v + (size_t)b * Lk * E;
  const unsigned char* qp = qpad + (size_t)b * Lq;
  const unsigned char* kp = kpad + (size_t)b * Lk;

  const int fu = first_unpadded(kp, Lk, &s_fu);
  const int i_end = min(i0 + FQ, Lq);
  const int kend = tile_has_full_row(qp, i0, FQ, Lq, Lk, fu)
                       ? Lk
                       : visible(i_end - 1, Lq, Lk);
  const int ntiles = (kend + FK - 1) / FK;

#pragma unroll
  for (int s = 0; s < F_STAGES - 1; ++s) {
    if (s < ntiles) {
      float* st = ring + s * STAGE;
      load_kv<DH>(st, st + FK * LDF, kb, vb, s * FK, Lk, E, col0);
    }
    cp_async_commit();
  }

  // this warp's rows r0 = i0 + 16 warp + g and r1 = r0 + 8: Q as A
  // fragments (hi, lo), masks, running max and (per-thread partial) sum
  const int r0 = i0 + warp * 16 + g, r1 = r0 + 8;
  uint32_t qh[KS][4], ql[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int d = col0 + kk * 8 + t4;
    const float a[4] = {
        r0 < Lq ? __ldg(qb + (size_t)r0 * E + d) : 0.f,
        r1 < Lq ? __ldg(qb + (size_t)r1 * E + d) : 0.f,
        r0 < Lq ? __ldg(qb + (size_t)r0 * E + d + 4) : 0.f,
        r1 < Lq ? __ldg(qb + (size_t)r1 * E + d + 4) : 0.f};
#pragma unroll
    for (int c = 0; c < 4; ++c) split_tf32(a[c], qh[kk][c], ql[kk][c]);
  }
  const int lim0 = r0 < Lq ? visible(r0, Lq, Lk) : 0;
  const int lim1 = r1 < Lq ? visible(r1, Lq, Lk) : 0;
  const bool qp0 = r0 < Lq && qp[r0], qp1 = r1 < Lq && qp[r1];
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[dt][c] = 0.f;

  for (int jt = 0; jt < ntiles; ++jt) {
    cp_async_wait<F_STAGES - 2>();
    __syncthreads();  // tile jt landed; every warp is done with jt - 1's
    const int nx = jt + F_STAGES - 1;
    if (nx < ntiles) {
      float* st = ring + (nx % F_STAGES) * STAGE;
      load_kv<DH>(st, st + FK * LDF, kb, vb, nx * FK, Lk, E, col0);
    }
    cp_async_commit();
    const float* ks = ring + (jt % F_STAGES) * STAGE;
    const float* vs = ks + FK * LDF;
    const int j0 = jt * FK;

    // S = Q K^T: s[nt] is rows (g, g+8) x keys j0 + 8nt + (2t4, 2t4 + 1)
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[nt][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float* kr = ks + (nt * 8 + g) * LDF + kk * 8 + t4;
        uint32_t bh[2], bl[2];
        split_tf32(kr[0], bh[0], bl[0]);
        split_tf32(kr[4], bh[1], bl[1]);
        mma_3xtf32(s[nt], qh[kk], ql[kk], bh, bl);
      }

    // scale and mask as the plain path; the tile's row maxima
    float mt0 = -INFINITY, mt1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = j0 + nt * 8 + 2 * t4 + c;
        const bool jin = j < Lk;
        const bool kpj = jin && kp[j];
        float x0 = s[nt][c] * scale, x1 = s[nt][2 + c] * scale;
        if (j >= lim0 || (qp0 && kpj)) x0 = NEG;
        if (j >= lim1 || (qp1 && kpj)) x1 = NEG;
        if (!jin) x0 = x1 = -INFINITY;  // block padding: excluded
        s[nt][c] = x0;
        s[nt][2 + c] = x1;
        mt0 = fmaxf(mt0, x0);
        mt1 = fmaxf(mt1, x1);
      }
    const float mn0 = fmaxf(m0, quad_max(mt0));
    const float mn1 = fmaxf(m1, quad_max(mt1));
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= al0;
    l1 *= al1;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      o[dt][0] *= al0;
      o[dt][1] *= al0;
      o[dt][2] *= al1;
      o[dt][3] *= al1;
    }

    // O += P V over the tile's keys, 8 at a time: the S accumulator of
    // group nt is the A fragment of keys (2 t4 -> column t4, 2 t4 + 1 ->
    // column t4 + 4), and V's rows are read in that order
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float p0 = expf(s[nt][0] - m0), p1 = expf(s[nt][1] - m0);
      const float p2 = expf(s[nt][2] - m1), p3 = expf(s[nt][3] - m1);
      l0 += p0 + p1;
      l1 += p2 + p3;
      uint32_t ph[4], pl[4];
      split_tf32(p0, ph[0], pl[0]);
      split_tf32(p2, ph[1], pl[1]);
      split_tf32(p1, ph[2], pl[2]);
      split_tf32(p3, ph[3], pl[3]);
      const float* vr = vs + (nt * 8 + 2 * t4) * LDF + g;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        uint32_t bh[2], bl[2];
        split_tf32(vr[dt * 8], bh[0], bl[0]);
        split_tf32(vr[LDF + dt * 8], bh[1], bl[1]);
        mma_3xtf32(o[dt], ph, pl, bh, bl);
      }
    }
  }
  cp_async_wait<0>();

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  float* ob = out + (size_t)b * Lq * E + col0 + 2 * t4;
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    if (r0 < Lq)
      *reinterpret_cast<float2*>(ob + (size_t)r0 * E + dt * 8) =
          make_float2(o[dt][0] * inv0, o[dt][1] * inv0);
    if (r1 < Lq)
      *reinterpret_cast<float2*>(ob + (size_t)r1 * E + dt * 8) =
          make_float2(o[dt][2] * inv1, o[dt][3] * inv1);
  }
  if (mrow != nullptr && t4 == 0) {
    const size_t at = ((size_t)b * H + h) * Lq;
    if (r0 < Lq) {
      mrow[at + r0] = m0;
      lrow[at + r0] = l0;
    }
    if (r1 < Lq) {
      mrow[at + r1] = m1;
      lrow[at + r1] = l1;
    }
  }
}

// D[b, h, i] = sum_d dO[b, i, h*DH+d] * O[b, i, h*DH+d]
template <int DH>
__global__ void rect_attn_bwd_dot(const float* __restrict__ o,
                                  const float* __restrict__ g,
                                  float* __restrict__ D, int B, int Lq,
                                  int H) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * Lq * H) return;
  int h = (int)(idx % H);
  long long bi = idx / H;
  int b = (int)(bi / Lq), i = (int)(bi % Lq);
  const float4* op = reinterpret_cast<const float4*>(o + bi * H * DH + h * DH);
  const float4* gp = reinterpret_cast<const float4*>(g + bi * H * DH + h * DH);
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < DH / 4; ++d) {
    float4 a = op[d], c = gp[d];
    acc += a.x * c.x + a.y * c.y + a.z * c.z + a.w * c.w;
  }
  D[((long long)b * H + h) * Lq + i] = acc;
}

// Q and dO rows [i0, i0+BQ) of one head's columns (rows of DH+4 floats),
// then the rows' m, l and D, into a ring stage by cp.async; rows past Lq
// are zeros
template <int DH>
__device__ __forceinline__ void load_q_stage(float* st, const float* qb,
                                             const float* gb, const float* mb,
                                             const float* lb, const float* Db,
                                             int i0, int Lq, int E, int col0) {
  constexpr int LDF = DH + 4, CPR = DH / 4;
  float* gs = st + BQ * LDF;
  float* rs = gs + BQ * LDF;
#pragma unroll
  for (int c = threadIdx.x; c < BQ * CPR; c += B_THREADS) {
    const int r = c / CPR, d = (c % CPR) * 4, row = i0 + r;
    const bool ok = row < Lq;
    const size_t at = ok ? (size_t)row * E + col0 + d : 0;
    cp_async16(st + r * LDF + d, qb + at, ok);
    cp_async16(gs + r * LDF + d, gb + at, ok);
  }
  for (int c = threadIdx.x; c < 3 * BQ; c += B_THREADS) {
    const int r = c % BQ, row = i0 + r;
    const float* src = c < BQ ? mb : c < 2 * BQ ? lb : Db;
    const bool ok = row < Lq;
    cp_async4(rs + c, src + (ok ? row : 0), ok);
  }
}

__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }

// d[n] += a b[n] for n < N in 3xTF32, issued pass by pass (lo*hi, hi*lo,
// hi*hi over every n), so that N - 1 independent products stand between
// two of one accumulator; each accumulator sums in mma_3xtf32's order
template <int N>
__device__ __forceinline__ void mma_3xtf32_n(float (*d)[4],
                                             const uint32_t (&ah)[4],
                                             const uint32_t (&al)[4],
                                             const uint32_t (*bh)[2],
                                             const uint32_t (*bl)[2]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[n], al, bh[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[n], ah, bl[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[n], ah, bh[n]);
}

// the same for two sets at once: d[n] += a b[n] and e[n] += c f[n]
template <int N>
__device__ __forceinline__ void mma_3xtf32_2n(
    float (*d)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
    const uint32_t (*bh)[2], const uint32_t (*bl)[2], float (*e)[4],
    const uint32_t (&ch)[4], const uint32_t (&cl)[4],
    const uint32_t (*fh)[2], const uint32_t (*fl)[2]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    mma_tf32(d[n], al, bh[n]);
    mma_tf32(e[n], cl, fh[n]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    mma_tf32(d[n], ah, bl[n]);
    mma_tf32(e[n], ch, fl[n]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    mma_tf32(d[n], ah, bh[n]);
    mma_tf32(e[n], ch, fh[n]);
  }
}

// dK, dV and the dQ partials of one key block: see the source note
template <int DH>
__global__ void __launch_bounds__(B_THREADS, B_MIN_BLOCKS)
    rect_attn_bwd_kv(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const unsigned char* __restrict__ qpad,
                     const unsigned char* __restrict__ kpad,
                     const float* __restrict__ g,
                     const float* __restrict__ mrow,
                     const float* __restrict__ lrow,
                     const float* __restrict__ Drow, float* __restrict__ dk,
                     float* __restrict__ dv, float* __restrict__ ws, int B,
                     int Lq, int Lk, int H, int R, float scale) {
  constexpr int LDF = DH + 4;  // rows of K, V, Q and dO in shared memory
  constexpr int LDS = BK + 8;  // rows of dS
  constexpr int KS = DH / 8;   // k-steps over the head dim
  constexpr int NQ = BQ / 8;   // 8-row q groups of a step
  constexpr int DT = DH / 8;   // 8-column groups of the head dim
  constexpr int DG = DT < 4 ? DT : 4;  // groups of dV/dK a pass goes over
  constexpr int STAGE = 2 * BQ * LDF + 3 * BQ;
  constexpr int PPW = (BQ / 16) * DT / BW;  // dQ (m tile, group) pairs a warp
  static_assert(PPW >= 1 && DT % PPW == 0, "dQ pairs must split evenly");
  extern __shared__ __align__(16) float sm[];
  float* Kh = sm;
  float* Kl = Kh + BK * LDF;
  float* Vs = Kl + BK * LDF;
  float* ring = Vs + BK * LDF;
  float* dSs = ring + B_STAGES * STAGE;
  const int nqt = (Lq + BQ - 1) / BQ;
  int* full = reinterpret_cast<int*>(dSs + BQ * LDS);
  int* tiles = full + nqt;
  __shared__ int s_fu, s_ntl;

  // key blocks in order of their q range, the longest first
  const int jb = blockIdx.x / (B * H), bh = blockIdx.x % (B * H);
  const int b = bh / H, h = bh % H;
  const int j0 = jb * BK, E = H * DH, col0 = h * DH;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const size_t rows = (size_t)bh * Lq;
  const float* qb = q + (size_t)b * Lq * E;
  const float* gb = g + (size_t)b * Lq * E;
  const float* kb = k + (size_t)b * Lk * E;
  const float* vb = v + (size_t)b * Lk * E;
  const unsigned char* qp = qpad + (size_t)b * Lq;
  const unsigned char* kp = kpad + (size_t)b * Lk;

  // V by cp.async (in the first group); K split once into TF32 hi and lo
  for (int c = threadIdx.x; c < BK * (DH / 4); c += B_THREADS) {
    const int r = c / (DH / 4), d = (c % (DH / 4)) * 4, row = j0 + r;
    const bool ok = row < Lk;
    const size_t at = ok ? (size_t)row * E + col0 + d : 0;
    cp_async16(Vs + r * LDF + d, vb + at, ok);
    const float4 x = ok ? __ldg(reinterpret_cast<const float4*>(kb + at))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t hi, lo;
      split_tf32_alu(xs[e], hi, lo);
      Kh[r * LDF + d + e] = __uint_as_float(hi);
      Kl[r * LDF + d + e] = __uint_as_float(lo);
    }
  }

  // the q tiles to visit, in order: those that see a key of the block
  // (from the tile of row r0 on), and before them each tile holding a
  // row whose every key is masked (it averages over all Lk keys: dV only)
  const int fu = first_unpadded(kp, Lk, &s_fu);
  const int r0 = first_row(jb, Lq, Lk), q_first = r0 / BQ;
  for (int t = threadIdx.x; t < nqt; t += B_THREADS) full[t] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < q_first * BQ; i += B_THREADS)
    if (qp[i] && fu >= visible(i, Lq, Lk)) full[i / BQ] = 1;
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int base = 0; base < nqt; base += 32) {
      const int qt = base + lane;
      const bool need = qt < nqt && (qt >= q_first || full[qt]);
      const unsigned bal = __ballot_sync(0xffffffffu, need);
      if (need) tiles[n + __popc(bal & ((1u << lane) - 1u))] = qt;
      n += __popc(bal);
    }
    if (lane == 0) s_ntl = n;
  }
  const int off = ws_rows_before(jb, Lq, Lk);
  __syncthreads();
  const int ntl = s_ntl;
  // row i (>= r0) of this block's dQ partials
  float* wsb = ws + ((size_t)bh * R + off - r0) * DH;

#pragma unroll
  for (int s = 0; s < B_STAGES - 1; ++s) {
    if (s < ntl)
      load_q_stage<DH>(ring + s * STAGE, qb, gb, mrow + rows, lrow + rows,
                       Drow + rows, tiles[s] * BQ, Lq, E, col0);
    cp_async_commit();
  }

  // this warp's keys ka and ka + 8 of the block
  const int ka = warp * 16 + g8;
  const int jk[2] = {j0 + ka, j0 + ka + 8};
  const bool kin[2] = {jk[0] < Lk, jk[1] < Lk};
  const bool kpd[2] = {kin[0] && kp[jk[0]], kin[1] && kp[jk[1]]};
  const long long jL[2] = {(long long)jk[0] * Lq, (long long)jk[1] * Lq};
  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int c = 0; c < 4; ++c) dka[dt][c] = dva[dt][c] = 0.f;

  for (int t = 0; t < ntl; ++t) {
    cp_async_wait<B_STAGES - 2>();
    __syncthreads();  // stage t landed; every warp is done with step t - 1
    const int nx = t + B_STAGES - 1;
    if (nx < ntl)
      load_q_stage<DH>(ring + (nx % B_STAGES) * STAGE, qb, gb, mrow + rows,
                       lrow + rows, Drow + rows, tiles[nx] * BQ, Lq, E, col0);
    cp_async_commit();
    const float* Qs = ring + (t % B_STAGES) * STAGE;
    const float* Gs = Qs + BQ * LDF;
    const float* Ms = Gs + BQ * LDF;
    const float* Ls = Ms + BQ;
    const float* Ds = Ls + BQ;
    const int i0 = tiles[t] * BQ;
    const bool vis = tiles[t] >= q_first;  // else every pair is masked

    // S^T = K Q^T and dP^T = V dO^T: s[nt] and dp[nt] hold keys (ka,
    // ka + 8) x q rows i0 + 8nt + (2t4, 2t4 + 1)
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[nt][c] = dp[nt][c] = 0.f;
    if (vis) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int at = ka * LDF + kk * 8 + t4;
        const uint32_t ah[4] = {bits(Kh[at]), bits(Kh[at + 8 * LDF]),
                                bits(Kh[at + 4]), bits(Kh[at + 8 * LDF + 4])};
        const uint32_t al[4] = {bits(Kl[at]), bits(Kl[at + 8 * LDF]),
                                bits(Kl[at + 4]), bits(Kl[at + 8 * LDF + 4])};
        uint32_t vh[4], vl[4];
        split_tf32_alu(Vs[at], vh[0], vl[0]);
        split_tf32_alu(Vs[at + 8 * LDF], vh[1], vl[1]);
        split_tf32_alu(Vs[at + 4], vh[2], vl[2]);
        split_tf32_alu(Vs[at + 8 * LDF + 4], vh[3], vl[3]);
        uint32_t qh[NQ][2], ql[NQ][2], gh[NQ][2], gl[NQ][2];
#pragma unroll
        for (int nt = 0; nt < NQ; ++nt) {
          const int bt = (nt * 8 + g8) * LDF + kk * 8 + t4;
          split_tf32_alu(Qs[bt], qh[nt][0], ql[nt][0]);
          split_tf32_alu(Qs[bt + 4], qh[nt][1], ql[nt][1]);
          split_tf32_alu(Gs[bt], gh[nt][0], gl[nt][0]);
          split_tf32_alu(Gs[bt + 4], gh[nt][1], gl[nt][1]);
        }
        mma_3xtf32_2n<NQ>(s, ah, al, qh, ql, dp, vh, vl, gh, gl);
      }
    }

    // P^T from the forward's max and sum, and dS^T = P^T (dP^T - D), zero
    // where the mask is set; key columns past Lk are excluded (P = 0)
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = nt * 8 + 2 * t4 + c, i = i0 + col;
        const bool in = i < Lq;
        const float mq = Ms[col], il = in ? __frcp_rn(Ls[col]) : 0.f;
        const float Dq = Ds[col];
        const bool qpi = in && qp[i];
        const long long iL = (long long)(i + 1) * Lk;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int e = 2 * rr + c;
          const bool masked = jL[rr] >= iL || (qpi && kpd[rr]);
          const float x = masked ? NEG : s[nt][e] * scale;
          const float p = kin[rr] ? expf(x - mq) * il : 0.f;
          dp[nt][e] = masked ? 0.f : p * (dp[nt][e] - Dq);
          s[nt][e] = p;
        }
      }
    if (vis) {  // dS for the dQ product, rows q, columns keys
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dSs[(nt * 8 + 2 * t4 + (e & 1)) * LDS + ka + 8 * (e >> 1)] =
              dp[nt][e];
    }

    // dV += P^T dO and dK += dS^T Q over the step's q rows, 8 at a time:
    // the accumulator of group kt is the A fragment (q row 2t4 -> column
    // t4, 2t4 + 1 -> t4 + 4), and dO's and Q's rows are read in that order
#pragma unroll
    for (int kt = 0; kt < NQ; ++kt) {
      uint32_t ph[4], pl[4], dh[4], dl[4];
      split_tf32_alu(s[kt][0], ph[0], pl[0]);
      split_tf32_alu(s[kt][2], ph[1], pl[1]);
      split_tf32_alu(s[kt][1], ph[2], pl[2]);
      split_tf32_alu(s[kt][3], ph[3], pl[3]);
      if (vis) {
        split_tf32_alu(dp[kt][0], dh[0], dl[0]);
        split_tf32_alu(dp[kt][2], dh[1], dl[1]);
        split_tf32_alu(dp[kt][1], dh[2], dl[2]);
        split_tf32_alu(dp[kt][3], dh[3], dl[3]);
      }
      const int bt = (kt * 8 + 2 * t4) * LDF + g8;
#pragma unroll
      for (int d0 = 0; d0 < DT; d0 += DG) {
        uint32_t oh[DG][2], ol[DG][2], xh[DG][2], xl[DG][2];
#pragma unroll
        for (int j = 0; j < DG; ++j) {
          const int at = bt + (d0 + j) * 8;
          split_tf32_alu(Gs[at], oh[j][0], ol[j][0]);
          split_tf32_alu(Gs[at + LDF], oh[j][1], ol[j][1]);
          if (vis) {
            split_tf32_alu(Qs[at], xh[j][0], xl[j][0]);
            split_tf32_alu(Qs[at + LDF], xh[j][1], xl[j][1]);
          }
        }
        if (vis)
          mma_3xtf32_2n<DG>(dva + d0, ph, pl, oh, ol, dka + d0, dh, dl, xh,
                            xl);
        else
          mma_3xtf32_n<DG>(dva + d0, ph, pl, oh, ol);
      }
    }

    // this block's part of dQ for the step's rows, dS K over its BK keys
    // (the keys taken in the order 2t4, 2t4 + 1 as above), into the
    // workspace; each warp takes PPW (16-row tile, 8-column group) pairs
    if (vis) {
      __syncthreads();  // dS complete
      const int p0 = warp * PPW, mt = p0 / DT, dt0 = p0 % DT;
      float acc[PPW][4];
#pragma unroll
      for (int u = 0; u < PPW; ++u)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[u][c] = 0.f;
#pragma unroll
      for (int kt = 0; kt < BK / 8; ++kt) {
        const float* ar = dSs + (mt * 16 + g8) * LDS + kt * 8 + 2 * t4;
        const float2 x0 = *reinterpret_cast<const float2*>(ar);
        const float2 x1 = *reinterpret_cast<const float2*>(ar + 8 * LDS);
        uint32_t ah[4], al[4];
        split_tf32_alu(x0.x, ah[0], al[0]);
        split_tf32_alu(x1.x, ah[1], al[1]);
        split_tf32_alu(x0.y, ah[2], al[2]);
        split_tf32_alu(x1.y, ah[3], al[3]);
        const int bt = (kt * 8 + 2 * t4) * LDF + g8;
        uint32_t bh[PPW][2], bl[PPW][2];
#pragma unroll
        for (int u = 0; u < PPW; ++u) {
          const int at = bt + (dt0 + u) * 8;
          bh[u][0] = bits(Kh[at]);
          bh[u][1] = bits(Kh[at + LDF]);
          bl[u][0] = bits(Kl[at]);
          bl[u][1] = bits(Kl[at + LDF]);
        }
        mma_3xtf32_n<PPW>(acc, ah, al, bh, bl);
      }
      const int ia = i0 + mt * 16 + g8, ib = ia + 8;
#pragma unroll
      for (int u = 0; u < PPW; ++u) {
        const int d = (dt0 + u) * 8 + 2 * t4;
        if (ia >= r0 && ia < Lq)
          *reinterpret_cast<float2*>(wsb + (size_t)ia * DH + d) =
              make_float2(acc[u][0], acc[u][1]);
        if (ib >= r0 && ib < Lq)
          *reinterpret_cast<float2*>(wsb + (size_t)ib * DH + d) =
              make_float2(acc[u][2], acc[u][3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (!kin[rr]) continue;
    const size_t at = ((size_t)b * Lk + jk[rr]) * E + col0 + 2 * t4;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      *reinterpret_cast<float2*>(dk + at + dt * 8) = make_float2(
          dka[dt][2 * rr] * scale, dka[dt][2 * rr + 1] * scale);
      *reinterpret_cast<float2*>(dv + at + dt * 8) =
          make_float2(dva[dt][2 * rr], dva[dt][2 * rr + 1]);
    }
  }
}

template <int DH>
int forward(const float* q, const float* k, const float* v,
            const unsigned char* qpad, const unsigned char* kpad, float* out,
            float* mrow, float* lrow, int B, int Lq, int Lk, int H,
            cudaStream_t stream) {
  const int smem = F_STAGES * 2 * FK * (DH + 4) * (int)sizeof(float);
  cudaError_t err = set_smem(rect_attn_fwd<DH>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lq + FQ - 1) / FQ, H, B);
  rect_attn_fwd<DH><<<grid, F_THREADS, smem, stream>>>(
      q, k, v, qpad, kpad, out, mrow, lrow, Lq, Lk, H, rsqrtf((float)DH));
  return (int)cudaGetLastError();
}

template <int DH>
int backward(const float* q, const float* k, const float* v,
             const unsigned char* qpad, const unsigned char* kpad,
             const float* out, const float* g, const float* mrow,
             const float* lrow, float* dq, float* dk, float* dv, float* D,
             float* ws, int B, int Lq, int Lk, int H, cudaStream_t stream) {
  const float scale = rsqrtf((float)DH);
  long long rows = (long long)B * Lq * H;
  rect_attn_bwd_dot<DH><<<(unsigned)((rows + 255) / 256), 256, 0, stream>>>(
      out, g, D, B, Lq, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  constexpr int LDF = DH + 4;
  const int R = (int)ws_rows(Lq, Lk);
  const int nqt = (Lq + BQ - 1) / BQ, nkb = (Lk + BK - 1) / BK;
  const int smem = (3 * BK * LDF + B_STAGES * (2 * BQ * LDF + 3 * BQ) +
                    BQ * (BK + 8)) * (int)sizeof(float) +
                   2 * nqt * (int)sizeof(int);
  if ((err = set_smem(rect_attn_bwd_kv<DH>, smem)) != cudaSuccess)
    return (int)err;
  rect_attn_bwd_kv<DH><<<(unsigned)(nkb * B * H), B_THREADS, smem, stream>>>(
      q, k, v, qpad, kpad, g, mrow, lrow, D, dk, dv, ws, B, Lq, Lk, H, R,
      scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  return (int)launch_dq_sum<DH>(ws, dq, B, Lq, Lk, H, R, scale, stream);
}

}  // namespace

extern "C" {

// q (B,Lq,E), k/v (B,Lk,E) f32; qpad (B,Lq), kpad (B,Lk) bytes (1 = pad).
// Writes out (B,Lq,E) and, when mrow/lrow are not null, each row's
// softmax max and sum, (B,H,Lq) each. Head dim E/H must be 32 or 64.
int rect_attention_forward_f32(const float* q, const float* k, const float* v,
                               const unsigned char* qpad,
                               const unsigned char* kpad, float* out,
                               float* mrow, float* lrow, int B, int Lq, int Lk,
                               int E, int H, void* stream_ptr) {
  if (!rect_shape_ok(B, Lq, Lk, E, H)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream_ptr;
  switch (E / H) {
    case 32:
      return forward<32>(q, k, v, qpad, kpad, out, mrow, lrow, B, Lq, Lk, H, s);
    case 64:
      return forward<64>(q, k, v, qpad, kpad, out, mrow, lrow, B, Lq, Lk, H, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Floats of the backward's dQ workspace for these shapes.
long long rect_attention_backward_workspace_floats(int B, int Lq, int Lk,
                                                   int E, int H) {
  if (!rect_shape_ok(B, Lq, Lk, E, H)) return -1;
  return (long long)B * E * ws_rows(Lq, Lk);
}

// From the forward's out, mrow, lrow and the cotangent g (B,Lq,E):
// dq (B,Lq,E), dk, dv (B,Lk,E). D is (B,H,Lq) f32 scratch, ws the dQ
// workspace (rect_attention_backward_workspace_floats).
int rect_attention_backward_f32(const float* q, const float* k,
                                const float* v, const unsigned char* qpad,
                                const unsigned char* kpad, const float* out,
                                const float* g, const float* mrow,
                                const float* lrow, float* dq, float* dk,
                                float* dv, float* D, float* ws, int B, int Lq,
                                int Lk, int E, int H, void* stream_ptr) {
  if (!rect_shape_ok(B, Lq, Lk, E, H)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream_ptr;
  switch (E / H) {
    case 32:
      return backward<32>(q, k, v, qpad, kpad, out, g, mrow, lrow, dq, dk, dv,
                          D, ws, B, Lq, Lk, H, s);
    case 64:
      return backward<64>(q, k, v, qpad, kpad, out, g, mrow, lrow, dq, dk, dv,
                          D, ws, B, Lq, Lk, H, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
