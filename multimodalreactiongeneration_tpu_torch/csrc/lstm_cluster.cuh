// Forward building blocks of the recurrent kernels: a tiled FP32 GEMM,
// the row-parallel add+LayerNorm, and the cluster LSTM recurrence.
//
// Used by csrc/mixer_stack.cu (the encoder stack, inference and training
// forward) and csrc/lstm_layer.cu (one LSTM layer); csrc/gru.cu and
// csrc/lstm_recurrence.cu (K10, K8: tensor-core chains of their own) take
// only its constants and helpers. The recurrence's design is in
// mixer_stack.cu's source note: W_hh split over an 8-CTA cluster in
// shared memory, h exchanged through distributed shared memory, one
// cluster barrier per step, R batch rows per cluster (a template
// parameter: 16 for the encoder stack, mixer_stack.cu STACK_ROWS; K7
// picks 16, 24 or 32, lstm_layer.cu).
// The encoder stack runs the recurrence in windows of steps
// (lstm_window_kernel) and its GEMMs and LayerNorms on the rows of a
// window (RowMap).
//
// Numerics: FP32 throughout (no tensor cores, so no TF32 rounding);
// LayerNorm in the fast-variance form E[x^2] - mean^2, eps 1e-5; gate
// order i, f, g, o. The recurrence also has a bf16 operand mode (TW =
// __nv_bfloat16, K7's bf16 instantiation): W_hh's slice is kept in
// shared memory as bf16 (half the bytes), h is rounded to bf16 where it
// enters the product (the exchanged copy; the state and the outputs stay
// FP32), and the product sums in FP32, as the JAX kernels' bf16 mode
// (ops/lstm_bf16.py); the encoder stack's bf16 mode instantiates the
// window kernel so (mixer_stack.cu).

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr float LN_EPS = 1e-5f;

// Rows of a (B, n) window at step t0 of a (B, T) plane: task row r is
// plane row (r / n) * T + t0 + r % n. {n, 0, n} is a dense (B, n) plane.
struct RowMap {
  int T, t0, n;
  __host__ __device__ size_t operator()(int r) const {
    return (size_t)(r / n) * T + t0 + r % n;
  }
};

// ---------------------------------------------------------------------
// C[mc(m), :] = A[ma(m), :] @ W (+ bias), row-major FP32, for the M rows of
// a window: row m of A is row ma(m) of the A plane (K wide), row m of C
// row mc(m) of the C plane (N wide); W stored (K, N); bias may be null.
// Each output element's sum runs in the same order whatever the window.
// ---------------------------------------------------------------------
constexpr int GM_BM = 64, GM_BN = 64, GM_BK = 16;
constexpr int GM_AROWS = GM_BM * GM_BK / 256;  // A-tile rows a thread loads

__global__ void __launch_bounds__(256) gemm_kernel(
    const float* __restrict__ A, const float* __restrict__ W,
    const float* __restrict__ bias, float* __restrict__ C, int M, int N,
    int K, RowMap ma, RowMap mc) {
  __shared__ float As[GM_BK][GM_BM + 4];  // A tile, transposed: As[k][m]
  __shared__ __align__(16) float Ws[GM_BK][GM_BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * GM_BM, n0 = blockIdx.x * GM_BN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  // a thread loads the same GM_AROWS rows of A at every k0
  size_t arow[GM_AROWS];
#pragma unroll
  for (int j = 0; j < GM_AROWS; ++j) {
    const int gm = m0 + (tid + 256 * j) / GM_BK;
    arow[j] = gm < M ? ma(gm) * K : 0;
  }

  for (int k0 = 0; k0 < K; k0 += GM_BK) {
#pragma unroll
    for (int j = 0; j < GM_AROWS; ++j) {
      const int i = tid + 256 * j;
      const int r = i / GM_BK, c = i % GM_BK;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? A[arow[j] + gk] : 0.f;
    }
    for (int i = tid; i < GM_BK * GM_BN; i += 256) {
      const int r = i / GM_BN, c = i % GM_BN;
      const int gk = k0 + r, gn = n0 + c;
      Ws[r][c] = (gk < K && gn < N) ? W[(size_t)gk * N + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GM_BK; ++kk) {
      float a[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = Ws[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
    const size_t cr = mc(gm);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn >= N) continue;
      float v = acc[i][j];
      if (bias) v += bias[gn];
      C[cr * N + gn] = v;
    }
  }
}

// ---------------------------------------------------------------------
// out[r, :] = LN(a[r, :] + b[r, :]) * g + beta, one warp per row; row r
// of a, b and out is row ma(r), mb(r) and mo(r) of its plane
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(256) add_ln_kernel(
    const float* __restrict__ a, RowMap ma, const float* __restrict__ b,
    RowMap mb, const float* __restrict__ g, const float* __restrict__ beta,
    float* __restrict__ out, RowMap mo, int rows, int H) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* pa = a + ma(row) * H;
  const float* pb = b + mb(row) * H;
  float s = 0.f, ss = 0.f;
  for (int k = lane; k < H; k += 32) {
    const float v = pa[k] + pb[k];
    s += v;
    ss += v * v;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  }
  const float mu = s / H;
  const float rstd = rsqrtf(ss / H - mu * mu + LN_EPS);
  float* po = out + mo(row) * H;
  for (int k = lane; k < H; k += 32) {
    const float v = pa[k] + pb[k];
    po[k] = (v - mu) * rstd * g[k] + beta[k];
  }
}

// ---------------------------------------------------------------------
// LSTM recurrence over xw = x @ W_ih + b, W_hh split over a cluster
// ---------------------------------------------------------------------
constexpr int CL = 8;     // CTAs per cluster (W_hh column split)
constexpr int BT = 16;    // batch rows per cluster but for K7 and K9's choice
constexpr int NT = 256;   // threads per CTA
constexpr int MAX_H = 256;
// a block's shared memory on sm_90 (227 KB)
constexpr size_t SMEM_LIMIT = 232448;

// H the recurrence kernels take: a CTA owns H/8 units, i.e. H/2 gate
// columns, and the step's thread layout needs at least 64 of them
inline bool hidden_ok(int H) { return H % 128 == 0 && H <= MAX_H; }

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.f / (1.f + expf(-x));
}

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// x as it enters a product with weights of type TW: rounded to bf16
// (to nearest, ties to even) in the bf16 mode, as it is in FP32
template <typename TW>
__device__ __forceinline__ float operand(float x) {
  if constexpr (std::is_same_v<TW, bf16>)
    return __bfloat162float(__float2bfloat16(x));
  else
    return x;
}

// R batch rows per cluster (16, 24 or 32); wbytes: bytes of a weight
// (4 FP32, 2 bf16)
size_t lstm_smem_bytes(int H, int R, int wbytes = 4) {
  const int nc = H / 2;  // 4 gates x H/8 units
  return (size_t)wbytes * H * nc +
         sizeof(float) * (2 * (size_t)R * H + (size_t)R * nc);
}

// acts (B, T, 4H) and cs (B, T, H) are the training residuals: the gate
// activations i, f, g, o and the cell state of every step. Null skips
// them (the inference forward). R batch rows per cluster: the step's
// product runs in 4 row groups of R/4 rows (64 threads each, one or two
// gate columns a thread), and each thread owns up to R/8 (row, unit)
// cells for the whole sequence. A step's xw loads are issued before its
// product, which hides them (loading them a step ahead measured slower).
// WINDOW runs the n steps t0 .. t0+n-1 of the (B, T) planes rnn, acts
// and cs from xw laid out (B, n, 4H); without it t0 = 0, n = T. TW: the
// weights' type (bf16: the operand mode above).
template <int R, bool WINDOW, typename TW = float>
__device__ __forceinline__ void lstm_cluster_steps(
    const float* __restrict__ xw, const TW* __restrict__ w_hh_t,
    const float* __restrict__ h0, const float* __restrict__ c0,
    float* __restrict__ rnn, float* __restrict__ hn, float* __restrict__ cn,
    float* __restrict__ acts, float* __restrict__ cs, int B, int T, int H,
    int t0, int n) {
  const int steps = WINDOW ? n : T;  // steps run, and xw's row stride
  const int tb = WINDOW ? t0 : 0;
  constexpr int RG = R / 4;  // rows of a row group
  constexpr int MC = R / 8;  // most cells a thread owns (H <= 256)
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b0 = (blockIdx.x / CL) * R;
  const int U = H / CL;   // hidden units owned by this CTA
  const int NC = 4 * U;   // gate columns owned by this CTA
  const int tid = threadIdx.x;
  const size_t G = 4 * (size_t)H;

  extern __shared__ __align__(16) float smem[];
  TW* Ws = reinterpret_cast<TW*>(smem);                 // [H][NC]
  float* hbuf = reinterpret_cast<float*>(Ws + H * NC);  // [2][R][H]
  float* gsm = hbuf + 2 * R * H;                        // [R][NC]

  // local column lc = g*U + u  <->  global gate column g*H + rank*U + u
  for (int i = tid; i < H * NC; i += NT) {
    const int k = i / NC, lc = i % NC;
    const int g = lc / U, u = lc % U;
    Ws[i] = w_hh_t[(size_t)k * 4 * H + g * H + rank * U + u];
  }
  // hbuf holds h as the product takes it (operand<TW>); the state h of a
  // thread's own cells stays in hreg
  for (int i = tid; i < R * H; i += NT) {
    const int b = b0 + i / H;
    hbuf[i] = operand<TW>((b < B) ? h0[(size_t)b * H + i % H] : 0.f);
  }
  // own_in: the cell exists; own_ok: and its row is a batch row (rows
  // past B run on zeros and are never stored)
  float creg[MC], hreg[MC];
  int own_r[MC], own_u[MC];
  bool own_in[MC], own_ok[MC];
#pragma unroll
  for (int j = 0; j < MC; ++j) {
    const int p = tid + NT * j;
    own_r[j] = p / U;
    own_u[j] = p % U;
    own_in[j] = p < R * U;
    own_ok[j] = own_in[j] && b0 + own_r[j] < B;
    creg[j] = own_ok[j]
        ? c0[(size_t)(b0 + own_r[j]) * H + rank * U + own_u[j]] : 0.f;
    hreg[j] = own_ok[j]
        ? h0[(size_t)(b0 + own_r[j]) * H + rank * U + own_u[j]] : 0.f;
  }
  auto load_xw = [&](int t, float (&x)[MC][4]) {
#pragma unroll
    for (int j = 0; j < MC; ++j) {
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        x[j][g] = own_ok[j]
            ? xw[((size_t)(b0 + own_r[j]) * steps + t) * G + g * H +
                 rank * U + own_u[j]]
            : 0.f;
      }
    }
  };
  cluster.sync();

  const int rg = tid / 64;  // rows rg*RG .. rg*RG+RG-1
  const int cl = tid % 64;  // columns cl and cl+64
  const bool col2 = cl + 64 < NC;

  for (int t = 0; t < steps; ++t) {
    const float* hcur = hbuf + (t & 1) * R * H;
    const int nxt_off = ((t + 1) & 1) * R * H;
    float xg[MC][4];
    load_xw(t, xg);

    float acc[RG][2];
#pragma unroll
    for (int i = 0; i < RG; ++i) acc[i][0] = acc[i][1] = 0.f;
    for (int k = 0; k < H; k += 4) {
      float4 hv[RG];
#pragma unroll
      for (int i = 0; i < RG; ++i)
        hv[i] = *reinterpret_cast<const float4*>(&hcur[(rg * RG + i) * H + k]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float w0 = to_f(Ws[(k + kk) * NC + cl]);
        const float w1 = col2 ? to_f(Ws[(k + kk) * NC + cl + 64]) : 0.f;
#pragma unroll
        for (int i = 0; i < RG; ++i) {
          const float hk = kk == 0 ? hv[i].x
                         : kk == 1 ? hv[i].y
                         : kk == 2 ? hv[i].z
                                   : hv[i].w;
          acc[i][0] = fmaf(hk, w0, acc[i][0]);
          acc[i][1] = fmaf(hk, w1, acc[i][1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RG; ++i) {
      gsm[(rg * RG + i) * NC + cl] = acc[i][0];
      if (col2) gsm[(rg * RG + i) * NC + cl + 64] = acc[i][1];
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < MC; ++j) {
      if (!own_in[j]) continue;
      const int r = own_r[j], u = own_u[j];
      const float* gr = gsm + r * NC;
      const float gi = sigmoidf_(gr[u] + xg[j][0]);
      const float gf = sigmoidf_(gr[U + u] + xg[j][1]);
      const float gg = tanhf(gr[2 * U + u] + xg[j][2]);
      const float go = sigmoidf_(gr[3 * U + u] + xg[j][3]);
      const float c = gf * creg[j] + gi * gg;
      const float h = go * tanhf(c);
      creg[j] = c;
      hreg[j] = h;
      const int slot = nxt_off + r * H + rank * U + u;
      const float hop = operand<TW>(h);
#pragma unroll
      for (int q = 0; q < CL; ++q)
        cluster.map_shared_rank(hbuf, q)[slot] = hop;
      if (own_ok[j]) {
        const size_t row = (size_t)(b0 + r) * T + tb + t;
        const int col = rank * U + u;
        rnn[row * H + col] = h;
        if (acts) {
          float* a = acts + row * G + col;
          a[0] = gi;
          a[H] = gf;
          a[2 * H] = gg;
          a[3 * H] = go;
          cs[row * H + col] = c;
        }
      }
    }
    cluster.sync();
  }

#pragma unroll
  for (int j = 0; j < MC; ++j) {
    if (!own_ok[j]) continue;
    const size_t o = (size_t)(b0 + own_r[j]) * H + rank * U + own_u[j];
    hn[o] = hreg[j];
    cn[o] = creg[j];
  }
}

// The whole sequence: xw (B, T, 4H); rnn (B, T, H); h0, c0, hn, cn (B, H)
template <int R, typename TW = float>
__global__ void __launch_bounds__(NT, 1) lstm_cluster_kernel(
    const float* __restrict__ xw, const TW* __restrict__ w_hh_t,
    const float* __restrict__ h0, const float* __restrict__ c0,
    float* __restrict__ rnn, float* __restrict__ hn, float* __restrict__ cn,
    float* __restrict__ acts, float* __restrict__ cs, int B, int T, int H) {
  lstm_cluster_steps<R, false, TW>(xw, w_hh_t, h0, c0, rnn, hn, cn, acts, cs,
                                   B, T, H, 0, T);
}

// A window of n steps from step t0 (the encoder stack's chunks): xw (B,
// n, 4H); rnn, acts, cs the (B, T) planes; h0, c0 the state before step
// t0, hn, cn after step t0 + n - 1 (other buffers than h0, c0). TW: the
// weights' type, as lstm_cluster_steps.
template <int R, typename TW = float>
__global__ void __launch_bounds__(NT, 1) lstm_window_kernel(
    const float* __restrict__ xw, const TW* __restrict__ w_hh_t,
    const float* __restrict__ h0, const float* __restrict__ c0,
    float* __restrict__ rnn, float* __restrict__ hn, float* __restrict__ cn,
    float* __restrict__ acts, float* __restrict__ cs, int B, int T, int H,
    int t0, int n) {
  lstm_cluster_steps<R, true, TW>(xw, w_hh_t, h0, c0, rnn, hn, cn, acts, cs,
                                  B, T, H, t0, n);
}

int check_launch() { return (int)cudaGetLastError(); }

cudaLaunchConfig_t cluster_config(unsigned clusters, size_t smem,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL * clusters);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// launch `kernel` on ceil(B / rows) clusters of 8 CTAs
template <typename Kernel, typename... Args>
int launch_cluster(Kernel kernel, size_t smem, int B, int rows,
                   cudaStream_t stream, Args... args) {
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      cluster_config((unsigned)((B + rows - 1) / rows), smem, attr);
  cfg.stream = stream;
  err = (int)cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err) return err;
  return check_launch();
}

// How many clusters of `kernel` the card holds at once (the occupancy
// query); a launch of more runs in waves. -1 on an error.
template <typename Kernel>
int resident_clusters(Kernel kernel, size_t smem) {
  if (!kernel || smem > SMEM_LIMIT) return -1;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem))
    return -1;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(1, smem, attr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg)) return -1;
  return n;
}

// C[mc(m)] = A[ma(m)] @ W (+ bias) for the M rows of a window
int gemm_rows(const float* A, RowMap ma, const float* W, const float* bias,
              float* C, RowMap mc, int M, int N, int K, cudaStream_t stream) {
  const dim3 grid((N + GM_BN - 1) / GM_BN, (M + GM_BM - 1) / GM_BM);
  gemm_kernel<<<grid, 256, 0, stream>>>(A, W, bias, C, M, N, K, ma, mc);
  return check_launch();
}

int add_ln(const float* a, RowMap ma, const float* b, RowMap mb,
           const float* g, const float* beta, float* out, RowMap mo,
           int rows, int H, cudaStream_t stream) {
  const unsigned blocks = (unsigned)(((size_t)rows * 32 + 255) / 256);
  add_ln_kernel<<<blocks, 256, 0, stream>>>(a, ma, b, mb, g, beta, out, mo,
                                            rows, H);
  return check_launch();
}

}  // namespace
