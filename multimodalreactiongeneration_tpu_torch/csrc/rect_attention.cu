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
// backward's 20.8 GFLOP run as FP32 FMAs at 67 TFLOP/s (0.31 ms).
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
//   * backward: D = rowsum(dO * O) in a small pre-pass; dK/dV with one
//     block per (key tile, head, batch) looping over the q tiles that can
//     see it, recomputing P from the saved max and sum; dQ in a second
//     pass with one block per q tile looping over its visible key tiles.
//     No atomics: the result is deterministic. dS is zero where the mask
//     is set, as autograd through the plain masked_fill gives it.
//     Arithmetic is FP32 FMAs (SIMT). Each thread of a 16 x 16 block owns
//     4 rows (ty*4 + r) and 4 strided columns (tx + 16*c) of every 64 x
//     64 tile; shared rows are padded to 65 floats so that every shared
//     read is conflict-free or a broadcast.

#include <cuda_runtime.h>
#include <math.h>

#include "tf32x3.cuh"

namespace {

constexpr int BM = 64;          // rows of a q tile and of a key tile
constexpr int LD = BM + 1;      // shared row stride
constexpr int TILE = BM * LD;   // floats of one shared tile
constexpr int THREADS = 256;    // 16 x 16 (backward)
constexpr float NEG = -1e30f;   // the plain path's masked logit

// forward: FQ_WARPS warps of 16 q rows, FK-key tiles, F_STAGES in flight
// (measured against 8 warps of a 128-row tile and against 3 stages: both
// slower at the flagship's audio shape)
constexpr int FQ_WARPS = 4;
constexpr int FQ = 16 * FQ_WARPS;
constexpr int FK = 64;
constexpr int F_THREADS = 32 * FQ_WARPS;
constexpr int F_STAGES = 2;

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

// rows [r0, r0+BM) of one head's columns of x (row stride E) into a
// shared tile; rows past nrows are zero
template <int DH>
__device__ void load_tile(float* s, const float* x, int r0, int nrows, int E,
                          int col0) {
  for (int e = threadIdx.x; e < BM * DH; e += THREADS) {
    int r = e / DH, d = e % DH, row = r0 + r;
    s[r * LD + d] = row < nrows ? x[(long long)row * E + col0 + d] : 0.f;
  }
}

__device__ __forceinline__ float row_max16(float x) {
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// acc[r][c] = sum_k A[(ty*4+r)][k] * Bt[(tx+16c)][k] over k < DH
template <int DH>
__device__ __forceinline__ void tile_dot(const float* A, const float* Bt,
                                         int ty, int tx, float acc[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll 8
  for (int k = 0; k < DH; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = A[(ty * 4 + r) * LD + k];
#pragma unroll
    for (int c = 0; c < 4; ++c) b[c] = Bt[(tx + 16 * c) * LD + k];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
}

// acc[r][c] += sum_m W[m][wcol(r)] * X[m][tx+16c] over m < BM, where
// wcol(r) = ty*4+r reads W transposed (colT) or W[ty*4+r][m] (rows)
template <int NC, bool COLT>
__device__ __forceinline__ void tile_acc(const float* W, const float* X,
                                         int ty, int tx, float acc[4][NC]) {
#pragma unroll 4
  for (int m = 0; m < BM; ++m) {
    float w[4], x[NC];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      w[r] = COLT ? W[m * LD + ty * 4 + r] : W[(ty * 4 + r) * LD + m];
#pragma unroll
    for (int c = 0; c < NC; ++c) x[c] = X[m * LD + tx + 16 * c];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(w[r], x[c], acc[r][c]);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

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

// P and dS of one (q tile, key tile) pair from the tiles in shared
// memory: thread rows ty*4+r are q rows, columns tx+16c keys.
struct RowInfo {
  float m[4], l[4], D[4];
  int lim[4];
  bool qp[4], in[4];
};

__device__ __forceinline__ void load_rows(RowInfo& ri, const float* mrow,
                                          const float* lrow, const float* Drow,
                                          const unsigned char* qp, int i0,
                                          int Lq, int Lk, int ty) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    int i = i0 + ty * 4 + r;
    ri.in[r] = i < Lq;
    ri.m[r] = ri.in[r] ? mrow[i] : 0.f;
    ri.l[r] = ri.in[r] ? lrow[i] : 1.f;
    ri.D[r] = ri.in[r] ? Drow[i] : 0.f;
    ri.lim[r] = ri.in[r] ? visible(i, Lq, Lk) : 0;
    ri.qp[r] = ri.in[r] && qp[i];
  }
}

template <int DH>
__device__ __forceinline__ void p_and_ds(const float* Qs, const float* Ks,
                                         const float* Gs, const float* Vs,
                                         const RowInfo& ri,
                                         const unsigned char* kp, int j0,
                                         int Lk, float scale, int ty, int tx,
                                         float p[4][4], float ds[4][4]) {
  float s[4][4], dp[4][4];
  tile_dot<DH>(Qs, Ks, ty, tx, s);
  tile_dot<DH>(Gs, Vs, ty, tx, dp);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    int j = j0 + tx + 16 * c;
    bool jin = j < Lk;
    bool kpj = jin && kp[j];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (!jin || !ri.in[r]) {
        p[r][c] = 0.f;
        ds[r][c] = 0.f;
        continue;
      }
      bool masked = j >= ri.lim[r] || (ri.qp[r] && kpj);
      float x = masked ? NEG : s[r][c] * scale;
      float pv = expf(x - ri.m[r]) / ri.l[r];
      p[r][c] = pv;
      ds[r][c] = masked ? 0.f : pv * (dp[r][c] - ri.D[r]);
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
    rect_attn_bwd_dkdv(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const unsigned char* __restrict__ qpad,
                       const unsigned char* __restrict__ kpad,
                       const float* __restrict__ g,
                       const float* __restrict__ mrow,
                       const float* __restrict__ lrow,
                       const float* __restrict__ Drow, float* __restrict__ dk,
                       float* __restrict__ dv, int Lq, int Lk, int H,
                       float scale) {
  constexpr int NC = DH / 16;
  extern __shared__ float sm[];
  float* Ks = sm;
  float* Vs = Ks + TILE;
  float* Qs = Vs + TILE;
  float* Gs = Qs + TILE;
  float* Ps = Gs + TILE;
  float* Ss = Ps + TILE;
  __shared__ int s_fu;
  const int j0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int E = H * DH, col0 = h * DH;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long bh = (long long)b * H + h;
  const float* qb = q + (long long)b * Lq * E;
  const float* gb = g + (long long)b * Lq * E;
  const unsigned char* qp = qpad + (long long)b * Lq;
  const unsigned char* kp = kpad + (long long)b * Lk;

  const int fu = first_unpadded(kp, Lk, &s_fu);
  load_tile<DH>(Ks, k + (long long)b * Lk * E, j0, Lk, E, col0);
  load_tile<DH>(Vs, v + (long long)b * Lk * E, j0, Lk, E, col0);

  float dka[4][NC], dva[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) dka[r][c] = dva[r][c] = 0.f;

  // the first q row that sees key j0: i >= floor(j0*Lq/Lk)
  const int q_first = (int)((long long)j0 * Lq / Lk) / BM;
  const int nqt = (Lq + BM - 1) / BM;
  for (int qt = 0; qt < nqt; ++qt) {
    const int i0 = qt * BM;
    if (qt < q_first && !tile_has_full_row(qp, i0, BM, Lq, Lk, fu))
      continue;
    __syncthreads();  // the last tile's readers are done
    load_tile<DH>(Qs, qb, i0, Lq, E, col0);
    load_tile<DH>(Gs, gb, i0, Lq, E, col0);
    __syncthreads();
    RowInfo ri;
    load_rows(ri, mrow + bh * Lq, lrow + bh * Lq, Drow + bh * Lq, qp, i0, Lq,
              Lk, ty);
    float p[4][4], ds[4][4];
    p_and_ds<DH>(Qs, Ks, Gs, Vs, ri, kp, j0, Lk, scale, ty, tx, p, ds);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        Ps[(ty * 4 + r) * LD + tx + 16 * c] = p[r][c];
        Ss[(ty * 4 + r) * LD + tx + 16 * c] = ds[r][c];
      }
    __syncthreads();
    // thread rows are now keys: dV += P^T dO, dK += dS^T Q
    tile_acc<NC, true>(Ps, Gs, ty, tx, dva);
    tile_acc<NC, true>(Ss, Qs, ty, tx, dka);
  }

  const long long base = (long long)b * Lk * E;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    int j = j0 + ty * 4 + r;
    if (j >= Lk) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      long long at = base + (long long)j * E + col0 + tx + 16 * c;
      dk[at] = dka[r][c] * scale;
      dv[at] = dva[r][c];
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
    rect_attn_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const unsigned char* __restrict__ qpad,
                     const unsigned char* __restrict__ kpad,
                     const float* __restrict__ g,
                     const float* __restrict__ mrow,
                     const float* __restrict__ lrow,
                     const float* __restrict__ Drow, float* __restrict__ dq,
                     int Lq, int Lk, int H, float scale) {
  constexpr int NC = DH / 16;
  extern __shared__ float sm[];
  float* Qs = sm;
  float* Gs = Qs + TILE;
  float* Ks = Gs + TILE;
  float* Vs = Ks + TILE;
  float* Ss = Vs + TILE;
  const int i0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int E = H * DH, col0 = h * DH;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long bh = (long long)b * H + h;
  const float* kb = k + (long long)b * Lk * E;
  const float* vb = v + (long long)b * Lk * E;
  const unsigned char* qp = qpad + (long long)b * Lq;
  const unsigned char* kp = kpad + (long long)b * Lk;

  load_tile<DH>(Qs, q + (long long)b * Lq * E, i0, Lq, E, col0);
  load_tile<DH>(Gs, g + (long long)b * Lq * E, i0, Lq, E, col0);
  RowInfo ri;
  load_rows(ri, mrow + bh * Lq, lrow + bh * Lq, Drow + bh * Lq, qp, i0, Lq,
            Lk, ty);
  // dS is zero on masked entries, so a fully masked row adds nothing and
  // only the causally visible keys are read
  const int kend = visible(min(i0 + BM, Lq) - 1, Lq, Lk);

  float dqa[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) dqa[r][c] = 0.f;

  for (int j0 = 0; j0 < kend; j0 += BM) {
    __syncthreads();  // the last tile's readers are done
    load_tile<DH>(Ks, kb, j0, Lk, E, col0);
    load_tile<DH>(Vs, vb, j0, Lk, E, col0);
    __syncthreads();
    float p[4][4], ds[4][4];
    p_and_ds<DH>(Qs, Ks, Gs, Vs, ri, kp, j0, Lk, scale, ty, tx, p, ds);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) Ss[(ty * 4 + r) * LD + tx + 16 * c] = ds[r][c];
    __syncthreads();
    tile_acc<NC, false>(Ss, Ks, ty, tx, dqa);  // dQ += dS K
  }

  float* dqb = dq + (long long)b * Lq * E;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    int i = i0 + ty * 4 + r;
    if (i >= Lq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      dqb[(long long)i * E + col0 + tx + 16 * c] = dqa[r][c] * scale;
  }
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
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
             int B, int Lq, int Lk, int H, cudaStream_t stream) {
  const float scale = rsqrtf((float)DH);
  long long rows = (long long)B * Lq * H;
  rect_attn_bwd_dot<DH><<<(unsigned)((rows + 255) / 256), 256, 0, stream>>>(
      out, g, D, B, Lq, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int smem_kv = 6 * TILE * (int)sizeof(float);
  if ((err = set_smem(rect_attn_bwd_dkdv<DH>, smem_kv)) != cudaSuccess)
    return (int)err;
  dim3 grid_kv((Lk + BM - 1) / BM, H, B);
  rect_attn_bwd_dkdv<DH><<<grid_kv, THREADS, smem_kv, stream>>>(
      q, k, v, qpad, kpad, g, mrow, lrow, D, dk, dv, Lq, Lk, H, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int smem_q = 5 * TILE * (int)sizeof(float);
  if ((err = set_smem(rect_attn_bwd_dq<DH>, smem_q)) != cudaSuccess)
    return (int)err;
  dim3 grid_q((Lq + BM - 1) / BM, H, B);
  rect_attn_bwd_dq<DH><<<grid_q, THREADS, smem_q, stream>>>(
      q, k, v, qpad, kpad, g, mrow, lrow, D, dq, Lq, Lk, H, scale);
  return (int)cudaGetLastError();
}

bool shape_ok(int B, int Lq, int Lk, int E, int H) {
  return B > 0 && Lq > 0 && Lk > 0 && H > 0 && E % H == 0 && B <= 65535 &&
         H <= 65535;
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
  if (!shape_ok(B, Lq, Lk, E, H)) return (int)cudaErrorInvalidValue;
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

// From the forward's out, mrow, lrow and the cotangent g (B,Lq,E):
// dq (B,Lq,E), dk, dv (B,Lk,E). D is (B,H,Lq) f32 scratch.
int rect_attention_backward_f32(const float* q, const float* k,
                                const float* v, const unsigned char* qpad,
                                const unsigned char* kpad, const float* out,
                                const float* g, const float* mrow,
                                const float* lrow, float* dq, float* dk,
                                float* dv, float* D, int B, int Lq, int Lk,
                                int E, int H, void* stream_ptr) {
  if (!shape_ok(B, Lq, Lk, E, H)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream_ptr;
  switch (E / H) {
    case 32:
      return backward<32>(q, k, v, qpad, kpad, out, g, mrow, lrow, dq, dk, dv,
                          D, B, Lq, Lk, H, s);
    case 64:
      return backward<64>(q, k, v, qpad, kpad, out, g, mrow, lrow, dq, dk, dv,
                          D, B, Lq, Lk, H, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
