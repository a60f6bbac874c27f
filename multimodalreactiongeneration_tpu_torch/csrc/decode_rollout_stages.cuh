// Device stages of the persistent decode-rollout kernel
// (decode_rollout.cu). Every stage runs on all blocks of the grid;
// stages are separated by grid barriers (GridSync). Activations that
// cross a barrier live in an FP32 scratch in device memory (L2-resident)
// and are read with __ldcg so no stale L1 line is ever used.
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
// rings: written in-kernel, read through L2. Eight consecutive ring
// elements (16-byte aligned) load packed, 16 bytes in bf16 and 32 in
// f32, and unpack to FP32 where they are used, so a lane keeps more rows
// in flight for the same registers.
template <typename T> struct Pack8;
template <> struct Pack8<__nv_bfloat16> { uint4 u; };
template <> struct Pack8<float> { float4 a, b; };
__device__ __forceinline__ void ldpack(const __nv_bfloat16* p,
                                       Pack8<__nv_bfloat16>& x) {
  x.u = __ldcg(reinterpret_cast<const uint4*>(p));
}
__device__ __forceinline__ void ldpack(const float* p, Pack8<float>& x) {
  x.a = __ldcg(reinterpret_cast<const float4*>(p));
  x.b = __ldcg(reinterpret_cast<const float4*>(p + 4));
}
__device__ __forceinline__ void unpack(const Pack8<__nv_bfloat16>& x,
                                       float v[8]) {
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&x.u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack(const Pack8<float>& x, float v[8]) {
  v[0] = x.a.x; v[1] = x.a.y; v[2] = x.a.z; v[3] = x.a.w;
  v[4] = x.b.x; v[5] = x.b.y; v[6] = x.b.z; v[7] = x.b.w;
}
// packed rows in flight per lane in the attention loops: 32 registers
template <typename T>
constexpr int ROWS_INFLIGHT = sizeof(T) == 2 ? 8 : 4;

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
// The warp sums of four values at once, in 6 shuffles instead of 20:
// lane l ends with the sum over all lanes of v[(l >> 3) & 3].
__device__ __forceinline__ float sum4_by_lane(const float v[4]) {
  const int lane = threadIdx.x & 31;
  const bool hi = lane & 16, mid = lane & 8;
  float k0 = hi ? v[2] : v[0], k1 = hi ? v[3] : v[1];
  k0 += __shfl_xor_sync(0xffffffffu, hi ? v[0] : v[2], 16);
  k1 += __shfl_xor_sync(0xffffffffu, hi ? v[1] : v[3], 16);
  float k = mid ? k1 : k0;
  k += __shfl_xor_sync(0xffffffffu, mid ? k0 : k1, 8);
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) k += __shfl_xor_sync(0xffffffffu, k, o);
  return k;
}
__device__ __forceinline__ float sigmoid_(float x) {
  return 1.f / (1.f + expf(-x));
}

// ---- grid barrier ----------------------------------------------------
// The launch is cooperative, so every block is resident and a counter
// barrier is safe. bar[0] counts arrivals over the whole launch (zeroed
// by the wrapper), bar[1] is the generation the last arrival released.
// Thread 0 of each block arrives with a release add and waits with
// acquire loads; the block's __syncthreads on either side orders its
// other threads' writes and reads (release and acquire are cumulative).
//
// Built with -DROLLOUT_STAMPS (a build only a measuring tool asks for),
// each block also stamps %globaltimer as it arrives and as it leaves,
// with the units of work it ran in the stage, for steps [STAMP_T0,
// STAMP_T0 + STAMP_STEPS); decode_rollout_stamps() reads them back.
#ifdef ROLLOUT_STAMPS
constexpr int STAMP_T0 = 240, STAMP_STEPS = 8, STAMP_STAGES = 64;
constexpr int STAMP_GRID = 160;
__device__ unsigned long long
    g_stamps[STAMP_STEPS][STAMP_STAGES][STAMP_GRID][3];
__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#endif

struct GridSync {
  unsigned int* bar;
  unsigned int gen;
#ifdef ROLLOUT_STAMPS
  int step, stage;
#endif

  __device__ explicit GridSync(unsigned int* b) : bar(b), gen(0) {
#ifdef ROLLOUT_STAMPS
    step = -1;
    stage = 0;
#endif
  }

  __device__ void begin_step(int t) {
#ifdef ROLLOUT_STAMPS
    step = t - STAMP_T0;
    stage = 0;
#endif
  }

  // Every block waits here until all have arrived. `units` is the number
  // of work units of the stage that ends here (block u % grid runs unit u).
  __device__ void operator()(int units) {
    __syncthreads();
    if (threadIdx.x == 0) {
#ifdef ROLLOUT_STAMPS
      const unsigned long long t_arrive = globaltimer();
#endif
      ++gen;
      unsigned int arrived;
      asm volatile("atom.add.release.gpu.global.u32 %0, [%1], 1;"
                   : "=r"(arrived)
                   : "l"(bar)
                   : "memory");
      if (arrived + 1 == gen * gridDim.x) {
        asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(bar + 1),
                     "r"(gen)
                     : "memory");
      } else {
        unsigned int seen;
        do {
          asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                       : "=r"(seen)
                       : "l"(bar + 1)
                       : "memory");
        } while (seen < gen);
      }
#ifdef ROLLOUT_STAMPS
      if (step >= 0 && step < STAMP_STEPS && stage < STAMP_STAGES &&
          blockIdx.x < STAMP_GRID) {
        unsigned long long* st = g_stamps[step][stage][blockIdx.x];
        st[0] = t_arrive;
        st[1] = globaltimer();
        st[2] = units > (int)blockIdx.x
                    ? (units - blockIdx.x + gridDim.x - 1) / gridDim.x
                    : 0;
      }
      ++stage;
#endif
    }
    __syncthreads();
  }
};

// ---- prologues: stage a (BT x K) activation in shared memory ----------
// Loops that read L2 issue a batch of independent loads before using
// any of them: one load per iteration would wait a full L2 round trip
// each time, and at 16 rows these stages are latency-bound.
constexpr int INFLIGHT = 8;
constexpr int MM_INFLIGHT = 16;   // weight loads per lane in a matmul
constexpr int CTX_INFLIGHT = 16;  // logit loads per thread for the weights

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

// ---- attention, pass 1: logits of ring slots [cs*ch, cs*ch + cs) -------
// for one dialog b and all heads, plus the chunk's max and sum of exp.
// The chunk size cs is the host's (ops/decode_rollout.py logit_chunk).
// The folded query is rounded to the ring type; products sum in FP32.
template <typename T>
__device__ void logits_unit(const T* ring, int S, int vis, const float* q,
                            int b, int ch, int cs, int nch, float scale,
                            float* logit, float* stat, float* lg_sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float qr[HEADS][8];
#pragma unroll
  for (int h = 0; h < HEADS; ++h)
#pragma unroll
    for (int i = 0; i < 8; ++i)
      qr[h][i] = rnd<T>(__ldcg(q + (size_t)b * HD + h * H + lane * 8 + i));
  const int s0 = ch * cs, s1 = min(s0 + cs, S);
  constexpr int SB = ROWS_INFLIGHT<T>;  // slots a warp loads per batch
  for (int sb = s0 + warp; sb < s1; sb += SB * NW) {
    Pack8<T> v[SB];
#pragma unroll
    for (int j = 0; j < SB; ++j) {
      const int s = sb + j * NW;
      if (s < s1 && s < vis)
        ldpack(ring + ((size_t)b * S + s) * H + lane * 8, v[j]);
    }
#pragma unroll
    for (int j = 0; j < SB; ++j) {
      const int s = sb + j * NW;
      if (s >= s1) continue;
      float d = NEG;  // head lane / 8's logit, in lanes 0, 8, 16, 24
      if (s < vis) {
        float x[8], part[HEADS];
        unpack(v[j], x);
#pragma unroll
        for (int h = 0; h < HEADS; ++h) {
          part[h] = 0.f;
#pragma unroll
          for (int i = 0; i < 8; ++i) part[h] = fmaf(qr[h][i], x[i], part[h]);
        }
        d = sum4_by_lane(part) * scale;
      }
      if ((lane & 7) == 0) {
        const int h = lane >> 3;
        lg_sm[h * cs + s - s0] = d;
        __stcg(logit + ((size_t)b * HEADS + h) * S + s, d);
      }
    }
  }
  __syncthreads();
  if (warp < HEADS) {
    const int h = warp, n = s1 - s0;
    float mx = LOWEST;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, lg_sm[h * cs + j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) sum += expf(lg_sm[h * cs + j] - mx);
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
// for dialog b, all heads, raw columns [64kg, 64kg + 64) (one round of
// units for 16 dialogs and two rings). The weights are rounded to the
// ring type before the sum, as in the TPU kernel. Slots at or past `vis`
// carry weight exactly 0 and are skipped. In the sum, lane l loads 8
// columns (8 (l % 8)) of slot (4 warp + l / 8) of each group of 32 slots,
// ROWS_INFLIGHT groups per batch; the four lanes of a column group then
// add their partial sums.
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
  for (int i0 = tid; i0 < HEADS * vis; i0 += NT * CTX_INFLIGHT) {
    float lg[CTX_INFLIGHT];
#pragma unroll
    for (int j = 0; j < CTX_INFLIGHT; ++j) {
      const int i = i0 + j * NT;
      if (i < HEADS * vis)
        lg[j] = __ldcg(logit + ((size_t)b * HEADS + i / vis) * S + i % vis);
    }
#pragma unroll
    for (int j = 0; j < CTX_INFLIGHT; ++j) {
      const int i = i0 + j * NT;
      if (i >= HEADS * vis) continue;
      const int h = i / vis;
      wsm[h * SMAX + i % vis] = rnd<T>(expf(lg[j] - ml[h]) / ml[HEADS + h]);
    }
  }
  __syncthreads();
  constexpr int J = ROWS_INFLIGHT<T>;
  const int cg = lane & 7, sub = lane >> 3;
  const T* rb = ring + (size_t)b * S * H + kg * 64 + cg * 8;
  float acc[HEADS][8];
#pragma unroll
  for (int h = 0; h < HEADS; ++h)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[h][i] = 0.f;
  for (int base = warp * 4 + sub; base < vis; base += 32 * J) {
    Pack8<T> v[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int s = base + 32 * j;
      if (s < vis) ldpack(rb + (size_t)s * H, v[j]);
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int s = base + 32 * j;
      if (s >= vis) continue;
      float x[8];
      unpack(v[j], x);
#pragma unroll
      for (int h = 0; h < HEADS; ++h) {
        const float w = wsm[h * SMAX + s];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[h][i] = fmaf(w, x[i], acc[h][i]);
      }
    }
  }
#pragma unroll
  for (int h = 0; h < HEADS; ++h)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      acc[h][i] += __shfl_xor_sync(0xffffffffu, acc[h][i], 8);
      acc[h][i] += __shfl_xor_sync(0xffffffffu, acc[h][i], 16);
    }
  if (sub == 0) {
#pragma unroll
    for (int h = 0; h < HEADS; ++h)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        red[(warp * HEADS + h) * 64 + cg * 8 + i] = acc[h][i];
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
