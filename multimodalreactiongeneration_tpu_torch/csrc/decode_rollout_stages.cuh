// Device stages of the persistent decode-rollout kernel
// (decode_rollout.cu). Every stage runs on all blocks of the grid;
// stages are separated by grid barriers. Activations that cross a
// barrier live in an FP32 scratch in device memory (L2-resident) and
// are read with __ldcg so no stale L1 line is ever used.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rollout {

constexpr int H = 256;           // hidden width
constexpr int HEADS = 4;         // attention heads
constexpr int HD = HEADS * H;    // folded attention width
constexpr int BT = 16;           // batch rows per launch
constexpr int NT = 256;          // threads per block
constexpr int NW = NT / 32;      // warps per block
constexpr int CH = 128;          // ring slots per logits work unit
constexpr int SMAX = 2048;       // longest ring
constexpr float LN_EPS = 1e-5f;
constexpr float NEG = -1e30f;
constexpr float LOWEST = -3.0e38f;  // below every logit, masked ones included

// ---- element types: FP32 (parity mode) or BF16 (production) ----------
__device__ __forceinline__ float tof(float v) { return v; }
__device__ __forceinline__ float tof(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T fromf(float v);
template <> __device__ __forceinline__ float fromf<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 fromf<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}
// round to T's precision, keep computing in FP32
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return tof(fromf<T>(v));
}
// weights: read-only for the whole launch
__device__ __forceinline__ float ldw(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldw(const __nv_bfloat16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}
// rings: written in-kernel, read through L2
// 2 consecutive ring elements (aligned to their pair)
__device__ __forceinline__ float2 ldr2(const float* p) {
  return __ldcg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 ldr2(const __nv_bfloat16* p) {
  const unsigned int u = __ldcg(reinterpret_cast<const unsigned int*>(p));
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}
// 8 consecutive ring elements (16-byte aligned)
__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcg(reinterpret_cast<const float4*>(p + 4));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 u = __ldcg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float sigmoid_(float x) {
  return 1.f / (1.f + expf(-x));
}

// ---- grid barrier ----------------------------------------------------
// The launch is cooperative, so every block is resident and a counter
// barrier is safe. bar[0] counts arrivals, bar[1] is the generation.
__device__ __forceinline__ void grid_sync(unsigned int* bar,
                                          unsigned int& gen) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    ++gen;
    if (atomicAdd(&bar[0], 1u) == gridDim.x - 1) {
      atomicExch(&bar[0], 0u);
      __threadfence();
      atomicExch(&bar[1], gen);
    } else {
      while (*reinterpret_cast<volatile unsigned int*>(&bar[1]) < gen) {
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// ---- prologues: stage a (BT x K) activation in shared memory ----------
// Loops that read L2 issue a batch of independent loads before using
// any of them: one load per iteration would wait a full L2 round trip
// each time, and at 16 rows these stages are latency-bound.
constexpr int INFLIGHT = 8;
constexpr int MM_INFLIGHT = 16;   // weight loads per lane in a matmul
constexpr int CTX_INFLIGHT = 16;  // ring loads per lane in the context sum

// A split-K matmul stage leaves P partial sums of its output, BT x N
// apart, that the next stage's prologue adds up (P is a template
// argument so the loads of all parts are issued together).

// act[b][koff + k] = f(sum_p src[p][b][k]), rounded to the panel type T,
// with f = relu when asked (K % 4 == 0). The FP32 value also goes to dst
// when dst is given.
template <typename T, int P = 1>
__device__ void prologue_copy(float* act, int ldk, int koff,
                              const float* src, int K, int bt,
                              bool relu = false, float* dst = nullptr) {
  constexpr int ITEMS = INFLIGHT / P > 0 ? INFLIGHT / P : 1;
  const int k4 = K / 4, n = bt * k4;
  const size_t part = (size_t)BT * K;
  for (int i0 = threadIdx.x; i0 < n; i0 += NT * ITEMS) {
    float4 u[ITEMS][P];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int i = i0 + j * NT;
      if (i >= n) continue;
      const float* q = src + (size_t)(i / k4) * K + (i % k4) * 4;
#pragma unroll
      for (int p = 0; p < P; ++p)
        u[j][p] = __ldcg(reinterpret_cast<const float4*>(q + p * part));
    }
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int i = i0 + j * NT;
      if (i >= n) continue;
      float4 v = u[j][0];
#pragma unroll
      for (int p = 1; p < P; ++p) {
        v.x += u[j][p].x;
        v.y += u[j][p].y;
        v.z += u[j][p].z;
        v.w += u[j][p].w;
      }
      if (relu) {
        v.x = fmaxf(v.x, 0.f);
        v.y = fmaxf(v.y, 0.f);
        v.z = fmaxf(v.z, 0.f);
        v.w = fmaxf(v.w, 0.f);
      }
      const int b = i / k4, k = (i % k4) * 4;
      float* d = act + b * ldk + koff + k;
      d[0] = rnd<T>(v.x);
      d[1] = rnd<T>(v.y);
      d[2] = rnd<T>(v.z);
      d[3] = rnd<T>(v.w);
      if (dst) __stcg(reinterpret_cast<float4*>(dst + b * K + k), v);
    }
  }
}

// act[b][koff + k] = LN(sum_p a[p][b] + r[b]) (rounded); the FP32 value
// also goes to dst when dst is given. One warp per row, 8 values per lane.
template <typename T, int P = 1>
__device__ void prologue_ln(float* act, int ldk, int koff, const float* a,
                            const float* r, const float* g,
                            const float* be, float* dst, int bt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int b = warp; b < bt; b += NW) {
    float v[8], s = 0.f, ss = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int k = lane + 32 * i;
      v[i] = __ldcg(r + b * H + k);
#pragma unroll
      for (int p = 0; p < P; ++p) v[i] += __ldcg(a + (p * BT + b) * H + k);
      s += v[i];
      ss += v[i] * v[i];
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mu = s / H;
    const float rstd = rsqrtf(ss / H - mu * mu + LN_EPS);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int k = lane + 32 * i;
      const float o = (v[i] - mu) * rstd * g[k] + be[k];
      act[b * ldk + koff + k] = rnd<T>(o);
      if (dst) __stcg(dst + b * H + k, o);
    }
  }
}

// ---- one 32-column group of out = act[:, kb:kb+K] @ W[kb:kb+K] + bias --
// W is (K_total, N) row-major; the 8 warps split the K range (K % 32 ==
// 0), lanes own columns, and the warp partials meet in shared memory.
// Epilogue: bias (when given: part 0 of a split-K stage), optional relu,
// optional blend  m * v + (1 - m) * gt[b][n]  (the AR feedback).
template <typename T>
__device__ void mm_group(const float* act, int ldk, int kb, int K,
                         const T* __restrict__ W, int N, int n0,
                         const float* __restrict__ bias, bool relu,
                         float* out, int ldo, const float* gt, int ldg,
                         float m, int bt, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kw = K / NW, k0 = kb + warp * kw;
  const int n = n0 + lane;
  const bool ok = n < N;
  float acc[BT];
#pragma unroll
  for (int b = 0; b < BT; ++b) acc[b] = 0.f;
  const int k1 = k0 + kw;  // kw % 4 == 0: activations read as float4
  for (int k = k0; k < k1; k += MM_INFLIGHT) {
    float w[MM_INFLIGHT];
#pragma unroll
    for (int j = 0; j < MM_INFLIGHT; ++j)
      w[j] = ok && k + j < k1 ? ldw(W + (size_t)(k + j) * N + n) : 0.f;
#pragma unroll
    for (int j = 0; j < MM_INFLIGHT; j += 4) {
      if (k + j < k1) {
#pragma unroll
        for (int b = 0; b < BT; ++b) {
          const float4 a =
              *reinterpret_cast<const float4*>(act + b * ldk + k + j);
          acc[b] = fmaf(a.x, w[j], acc[b]);
          acc[b] = fmaf(a.y, w[j + 1], acc[b]);
          acc[b] = fmaf(a.z, w[j + 2], acc[b]);
          acc[b] = fmaf(a.w, w[j + 3], acc[b]);
        }
      }
    }
  }
#pragma unroll
  for (int b = 0; b < BT; ++b) red[(warp * BT + b) * 32 + lane] = acc[b];
  __syncthreads();
  for (int b = warp; b < bt; b += NW) {
    float v = 0.f;
#pragma unroll
    for (int w2 = 0; w2 < NW; ++w2) v += red[(w2 * BT + b) * 32 + lane];
    if (ok) {
      if (bias) v += bias[n];
      if (relu) v = fmaxf(v, 0.f);
      if (gt) v = m * v + (1.f - m) * gt[(size_t)b * ldg + n];
      __stcg(out + (size_t)b * ldo + n, v);
    }
  }
  __syncthreads();
}

// ---- LSTM cell for hidden units [8g, 8g+8) ----------------------------
// act = [x | h] (BT x 2H, rounded); gates = x@W_ih + h@W_hh + b, gate
// order i, f, g, o. Lane l owns gate column (l / 8) * H + 8g + l % 8 and
// issues its 64 weight loads in two batches; warps 0-3 take the x half
// of K, warps 4-7 the h half.
template <typename T>
__device__ void cell_group(const float* act, const T* __restrict__ wih,
                           const T* __restrict__ whh,
                           const float* __restrict__ bg, float* c_state,
                           float* h_out, int g, int bt, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = (lane >> 3) * H + g * 8 + (lane & 7);
  constexpr int KW = 2 * H / NW;
  const int k0 = warp * KW;
  const T* W = (k0 < H ? wih : whh) + (size_t)(k0 < H ? k0 : k0 - H) * 4 * H;
  float acc[BT];
#pragma unroll
  for (int b = 0; b < BT; ++b) acc[b] = 0.f;
  constexpr int KB = KW / 2;  // two batches of weight loads
#pragma unroll
  for (int j0 = 0; j0 < KW; j0 += KB) {
    float w[KB];
#pragma unroll
    for (int j = 0; j < KB; ++j)
      w[j] = ldw(W + (size_t)(j0 + j) * 4 * H + col);
#pragma unroll
    for (int j = 0; j < KB; j += 4) {
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        const float4 a =
            *reinterpret_cast<const float4*>(act + b * 2 * H + k0 + j0 + j);
        acc[b] = fmaf(a.x, w[j], acc[b]);
        acc[b] = fmaf(a.y, w[j + 1], acc[b]);
        acc[b] = fmaf(a.z, w[j + 2], acc[b]);
        acc[b] = fmaf(a.w, w[j + 3], acc[b]);
      }
    }
  }
#pragma unroll
  for (int b = 0; b < BT; ++b) red[(warp * BT + b) * 32 + lane] = acc[b];
  __syncthreads();
  if (threadIdx.x < bt * 8) {
    const int b = threadIdx.x >> 3, uu = threadIdx.x & 7, u = g * 8 + uu;
    float gs[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float v = 0.f;
#pragma unroll
      for (int w2 = 0; w2 < NW; ++w2) v += red[(w2 * BT + b) * 32 + q * 8 + uu];
      gs[q] = v + bg[q * H + u];
    }
    const float c = __ldcg(c_state + b * H + u);
    const float c2 = sigmoid_(gs[1]) * c + sigmoid_(gs[0]) * tanhf(gs[2]);
    const float h2 = sigmoid_(gs[3]) * tanhf(c2);
    __stcg(c_state + b * H + u, c2);
    __stcg(h_out + b * H + u, h2);
  }
  __syncthreads();
}

// ---- attention, pass 1: logits of ring slots [CH*ch, CH*ch + CH) -------
// for one dialog b and all heads, plus the chunk's max and sum of exp.
// The folded query is rounded to the ring type; products sum in FP32.
template <typename T>
__device__ void logits_unit(const T* ring, int S, int vis, const float* q,
                            int b, int ch, int nch, float scale,
                            float* logit, float* stat, float* lg_sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float qr[HEADS][8];
#pragma unroll
  for (int h = 0; h < HEADS; ++h)
#pragma unroll
    for (int i = 0; i < 8; ++i)
      qr[h][i] = rnd<T>(__ldcg(q + (size_t)b * HD + h * H + lane * 8 + i));
  const int s0 = ch * CH, s1 = min(s0 + CH, S);
  constexpr int SB = INFLIGHT / 2;  // slots loaded per batch
  for (int sb = s0 + warp; sb < s1; sb += SB * NW) {
    float v[SB][8];
#pragma unroll
    for (int j = 0; j < SB; ++j) {
      const int s = sb + j * NW;
      if (s < s1 && s < vis)
        load8(ring + ((size_t)b * S + s) * H + lane * 8, v[j]);
    }
#pragma unroll
    for (int j = 0; j < SB; ++j) {
      const int s = sb + j * NW;
      if (s >= s1) continue;
      float d[HEADS];
      if (s < vis) {
#pragma unroll
        for (int h = 0; h < HEADS; ++h) {
          float acc = 0.f;
#pragma unroll
          for (int i = 0; i < 8; ++i) acc = fmaf(qr[h][i], v[j][i], acc);
          d[h] = warp_sum(acc) * scale;
        }
      } else {
#pragma unroll
        for (int h = 0; h < HEADS; ++h) d[h] = NEG;
      }
      if (lane == 0) {
#pragma unroll
        for (int h = 0; h < HEADS; ++h) {
          lg_sm[h * CH + s - s0] = d[h];
          __stcg(logit + ((size_t)b * HEADS + h) * S + s, d[h]);
        }
      }
    }
  }
  __syncthreads();
  if (warp < HEADS) {
    const int h = warp, n = s1 - s0;
    float mx = LOWEST;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, lg_sm[h * CH + j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) sum += expf(lg_sm[h * CH + j] - mx);
    sum = warp_sum(sum);
    if (lane == 0) {
      float* st = stat + (((size_t)b * HEADS + h) * nch + ch) * 2;
      __stcg(st, mx);
      __stcg(st + 1, sum);
    }
  }
  __syncthreads();
}

// ---- attention, pass 2: softmax weights and the context sum -----------
// for dialog b, all heads, raw columns [64kg, 64kg + 64), two per lane
// (one round of units for 16 dialogs and two rings). The weights
// are rounded to the ring type before the sum, as in the TPU kernel.
// Slots at or past `vis` carry weight exactly 0 and are skipped.
template <typename T>
__device__ void context_unit(const T* ring, int S, int vis,
                             const float* logit, const float* stat, int nch,
                             int b, int kg, float* ctx, float* wsm,
                             float* red, float* ml) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tid = threadIdx.x;
  if (warp < HEADS) {  // chunk statistics, one lane per chunk
    const float* st = stat + ((size_t)b * HEADS + warp) * nch * 2;
    const float mc = lane < nch ? __ldcg(st + 2 * lane) : LOWEST;
    const float lc = lane < nch ? __ldcg(st + 2 * lane + 1) : 0.f;
    const float M = warp_max(mc);
    const float L = warp_sum(lc * expf(mc - M));
    if (lane == 0) {
      ml[warp] = M;
      ml[HEADS + warp] = L;
    }
  }
  __syncthreads();
  for (int i0 = tid; i0 < HEADS * vis; i0 += NT * INFLIGHT) {
    float lg[INFLIGHT];
#pragma unroll
    for (int j = 0; j < INFLIGHT; ++j) {
      const int i = i0 + j * NT;
      if (i < HEADS * vis)
        lg[j] = __ldcg(logit + ((size_t)b * HEADS + i / vis) * S + i % vis);
    }
#pragma unroll
    for (int j = 0; j < INFLIGHT; ++j) {
      const int i = i0 + j * NT;
      if (i >= HEADS * vis) continue;
      const int h = i / vis;
      wsm[h * SMAX + i % vis] = rnd<T>(expf(lg[j] - ml[h]) / ml[HEADS + h]);
    }
  }
  __syncthreads();
  const int k = kg * 64 + 2 * lane;
  float2 acc[HEADS];
#pragma unroll
  for (int h = 0; h < HEADS; ++h) acc[h] = make_float2(0.f, 0.f);
  for (int s0 = warp; s0 < vis; s0 += NW * CTX_INFLIGHT) {
    float2 v[CTX_INFLIGHT];
#pragma unroll
    for (int j = 0; j < CTX_INFLIGHT; ++j) {
      const int s = s0 + j * NW;
      if (s < vis) v[j] = ldr2(ring + ((size_t)b * S + s) * H + k);
    }
#pragma unroll
    for (int j = 0; j < CTX_INFLIGHT; ++j) {
      const int s = s0 + j * NW;
      if (s >= vis) continue;
#pragma unroll
      for (int h = 0; h < HEADS; ++h) {
        const float w = wsm[h * SMAX + s];
        acc[h].x = fmaf(w, v[j].x, acc[h].x);
        acc[h].y = fmaf(w, v[j].y, acc[h].y);
      }
    }
  }
#pragma unroll
  for (int h = 0; h < HEADS; ++h) {
    red[(warp * HEADS + h) * 64 + 2 * lane] = acc[h].x;
    red[(warp * HEADS + h) * 64 + 2 * lane + 1] = acc[h].y;
  }
  __syncthreads();
  static_assert(HEADS * 64 == NT, "one context output per thread");
  {
    const int h = tid / 64, c = tid % 64;
    float v = 0.f;
#pragma unroll
    for (int w2 = 0; w2 < NW; ++w2) v += red[(w2 * HEADS + h) * 64 + c];
    __stcg(ctx + (size_t)b * HD + h * H + kg * 64 + c, v);
  }
  __syncthreads();
}

}  // namespace rollout
