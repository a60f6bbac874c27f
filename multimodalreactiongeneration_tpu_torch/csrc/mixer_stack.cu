// Recurrent-mixer block stack, forward only (the decode encoder pass).
//
// Replaces: multimodalreactiongeneration_tpu/ops/pallas_mixer_stack.py
//   mixer_stack_recurrence -> _make_fwd_light -> _fwd_kernel_light.
// Each of the L blocks computes  LSTM -> +x -> LN -> Dense(H->H) -> +res
// -> LN  over (B, T, H); the stack returns the top block's output and
// every block's final (h, c).
//
// What bounds it on the H100: the LSTM recurrence. Its T cell steps are
// a dependent chain, and each step is a small (B x H) @ (H x 4H) product
// plus the gate math; at B16, H256 that is 4.2 MFLOP, far too little to
// fill the card, so the time is the per-step latency times L*T. The
// input projection and the block tail are parallel over all B*T rows
// and are bounded by FP32 FMA throughput (about 110 GFLOP at the audio
// encoder shape B16 x T2096 x L5).
//
// Design (layer-major, simple first):
//   1. gemm_bias_kernel: x_l @ W_ih + (b_ih + b_hh) for all B*T rows, a
//      shared-memory tiled FP32 GEMM (64x64 tiles, 4x4 per thread);
//   2. lstm_cluster_kernel: one persistent launch per block runs the T
//      cells. W_hh (H x 4H f32 = 1 MB at H256) does not fit one SM, so a
//      cluster of 8 CTAs splits it: CTA r keeps the four gate columns of
//      hidden units [r*H/8, (r+1)*H/8) in shared memory (128 KB) for the
//      whole sequence and never re-reads it. Each step every CTA forms
//      its gate slice from the full h, updates its units' cells, and
//      writes its slice of the new h into every CTA's double-buffered h
//      through distributed shared memory; one cluster barrier per step
//      orders the exchange. The chain per step is then one 256-deep
//      shared-memory dot loop, the gate math and one cluster barrier.
//      A cluster serves 16 batch rows; larger batches add clusters.
//   3. add_ln_kernel + gemm_bias_kernel + add_ln_kernel: the block tail,
//      LN(h + x) -> Dense -> LN(z + y), parallel over rows.
// The sequential chain is L*T cell steps. The TPU kernel's chunk-lag
// wavefront (T + (L-1)*8 steps) is later work.
//
// Numerics: FP32 throughout (no tensor cores, so no TF32 rounding);
// LayerNorm in the fast-variance form E[x^2] - mean^2, eps 1e-5; gate
// order i, f, g, o.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float LN_EPS = 1e-5f;

// ---------------------------------------------------------------------
// C[M, N] = A[M, K] @ W[K, N] + bias[N], row-major FP32
// ---------------------------------------------------------------------
constexpr int GM_BM = 64, GM_BN = 64, GM_BK = 16;

__global__ void __launch_bounds__(256) gemm_bias_kernel(
    const float* __restrict__ A, const float* __restrict__ W,
    const float* __restrict__ bias, float* __restrict__ C,
    int M, int N, int K) {
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

  for (int k0 = 0; k0 < K; k0 += GM_BK) {
    for (int i = tid; i < GM_BM * GM_BK; i += 256) {
      const int r = i / GM_BK, c = i % GM_BK;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? A[(size_t)gm * K + gk] : 0.f;
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
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < N) C[(size_t)gm * N + gn] = acc[i][j] + bias[gn];
    }
  }
}

// ---------------------------------------------------------------------
// out[r, :] = LN(a[r, :] + b[r, :]) * g + beta, one warp per row
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(256) add_ln_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ g, const float* __restrict__ beta,
    float* __restrict__ out, int rows, int H) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* pa = a + (size_t)row * H;
  const float* pb = b + (size_t)row * H;
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
  float* po = out + (size_t)row * H;
  for (int k = lane; k < H; k += 32) {
    const float v = pa[k] + pb[k];
    po[k] = (v - mu) * rstd * g[k] + beta[k];
  }
}

// ---------------------------------------------------------------------
// LSTM recurrence over xw = x @ W_ih + b, W_hh split over a cluster
// ---------------------------------------------------------------------
constexpr int CL = 8;     // CTAs per cluster (W_hh column split)
constexpr int BT = 16;    // batch rows per cluster
constexpr int NT = 256;   // threads per CTA
constexpr int MAX_H = 256;

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.f / (1.f + expf(-x));
}

size_t lstm_smem_bytes(int H) {
  const int nc = H / 2;  // 4 gates x H/8 units
  return sizeof(float) * ((size_t)H * nc + 2 * BT * H + BT * nc);
}

__global__ void __launch_bounds__(NT, 1) lstm_cluster_kernel(
    const float* __restrict__ xw,      // (B, T, 4H)
    const float* __restrict__ w_hh_t,  // (H, 4H)
    const float* __restrict__ h0,      // (B, H)
    const float* __restrict__ c0,      // (B, H)
    float* __restrict__ rnn,           // (B, T, H)
    float* __restrict__ hn,            // (B, H)
    float* __restrict__ cn,            // (B, H)
    int B, int T, int H) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b0 = (blockIdx.x / CL) * BT;
  const int U = H / CL;   // hidden units owned by this CTA
  const int NC = 4 * U;   // gate columns owned by this CTA
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) float smem[];
  float* Ws = smem;                  // [H][NC]
  float* hbuf = Ws + H * NC;         // [2][BT][H]
  float* gsm = hbuf + 2 * BT * H;    // [BT][NC]

  // local column lc = g*U + u  <->  global gate column g*H + rank*U + u
  for (int i = tid; i < H * NC; i += NT) {
    const int k = i / NC, lc = i % NC;
    const int g = lc / U, u = lc % U;
    Ws[i] = w_hh_t[(size_t)k * 4 * H + g * H + rank * U + u];
  }
  for (int i = tid; i < BT * H; i += NT) {
    const int b = b0 + i / H;
    hbuf[i] = (b < B) ? h0[(size_t)b * H + i % H] : 0.f;
  }
  // each thread owns up to two (row, unit) cells for the whole sequence
  float creg[2] = {0.f, 0.f};
  int own_r[2], own_u[2];
  bool own_ok[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int p = tid + NT * j;
    own_r[j] = p / U;
    own_u[j] = p % U;
    own_ok[j] = p < BT * U && b0 + own_r[j] < B;
    if (own_ok[j])
      creg[j] = c0[(size_t)(b0 + own_r[j]) * H + rank * U + own_u[j]];
  }
  cluster.sync();

  const int rg = tid / 64;  // rows rg*4 .. rg*4+3
  const int cl = tid % 64;  // columns cl and cl+64
  const bool col2 = cl + 64 < NC;
  const size_t G = 4 * (size_t)H;

  for (int t = 0; t < T; ++t) {
    const float* hcur = hbuf + (t & 1) * BT * H;
    const int nxt_off = ((t + 1) & 1) * BT * H;

    float xg[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        xg[j][g] = own_ok[j]
            ? xw[((size_t)(b0 + own_r[j]) * T + t) * G + g * H + rank * U +
                 own_u[j]]
            : 0.f;
      }
    }

    float acc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = 0.f;
    for (int k = 0; k < H; k += 4) {
      float4 hv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        hv[i] = *reinterpret_cast<const float4*>(&hcur[(rg * 4 + i) * H + k]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float w0 = Ws[(k + kk) * NC + cl];
        const float w1 = col2 ? Ws[(k + kk) * NC + cl + 64] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
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
    for (int i = 0; i < 4; ++i) {
      gsm[(rg * 4 + i) * NC + cl] = acc[i][0];
      if (col2) gsm[(rg * 4 + i) * NC + cl + 64] = acc[i][1];
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int p = tid + NT * j;
      if (p >= BT * U) continue;
      const int r = own_r[j], u = own_u[j];
      const float* gr = gsm + r * NC;
      const float gi = sigmoidf_(gr[u] + xg[j][0]);
      const float gf = sigmoidf_(gr[U + u] + xg[j][1]);
      const float gg = tanhf(gr[2 * U + u] + xg[j][2]);
      const float go = sigmoidf_(gr[3 * U + u] + xg[j][3]);
      const float c = gf * creg[j] + gi * gg;
      const float h = go * tanhf(c);
      creg[j] = c;
      const int slot = nxt_off + r * H + rank * U + u;
#pragma unroll
      for (int q = 0; q < CL; ++q) cluster.map_shared_rank(hbuf, q)[slot] = h;
      if (own_ok[j]) rnn[((size_t)(b0 + r) * T + t) * H + rank * U + u] = h;
    }
    cluster.sync();
  }

  const float* hlast = hbuf + (T & 1) * BT * H;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (!own_ok[j]) continue;
    const size_t o = (size_t)(b0 + own_r[j]) * H + rank * U + own_u[j];
    hn[o] = hlast[own_r[j] * H + rank * U + own_u[j]];
    cn[o] = creg[j];
  }
}

int check_launch() { return (int)cudaGetLastError(); }

}  // namespace

extern "C" {

// floats of scratch mixer_stack_forward_f32 needs: xw (4H) + rnn, y, z
// and two ping-pong block outputs (H each), per row of B*T
long long mixer_stack_workspace_floats(int B, int T, int H) {
  return (long long)B * T * 9 * H;
}

// x0 (B,T,H); w_ih_t, w_hh_t (L,H,4H); b_g (L,4H); w_ff (L,H,H);
// b_ff, g1, b1, g2, b2 (L,H); h0, c0 (L,B,H). Writes out (B,T,H),
// hn, cn (L,B,H). Returns 0 or the first CUDA error code.
int mixer_stack_forward_f32(
    const float* x0, const float* w_ih_t, const float* b_g,
    const float* w_hh_t, const float* w_ff, const float* b_ff,
    const float* g1, const float* b1, const float* g2, const float* b2,
    const float* h0, const float* c0, float* out, float* hn, float* cn,
    float* ws, int B, int T, int H, int L, void* stream_ptr) {
  if (H % 64 != 0 || H > MAX_H || B <= 0 || T <= 0 || L <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const size_t rows = (size_t)B * T;
  const size_t bth = rows * H;
  float* xw = ws;
  float* rnn = xw + 4 * bth;
  float* y = rnn + bth;
  float* z = y + bth;
  float* xa = z + bth;
  float* xb = xa + bth;

  const size_t smem = lstm_smem_bytes(H);
  int err = (int)cudaFuncSetAttribute(
      lstm_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err) return err;

  const dim3 gemm_block(256);
  const dim3 grid_ih((4 * H + GM_BN - 1) / GM_BN,
                     (unsigned)((rows + GM_BM - 1) / GM_BM));
  const dim3 grid_ff((H + GM_BN - 1) / GM_BN,
                     (unsigned)((rows + GM_BM - 1) / GM_BM));
  const unsigned ln_blocks = (unsigned)((rows * 32 + 255) / 256);
  const int tiles = (B + BT - 1) / BT;

  const float* xin = x0;
  for (int l = 0; l < L; ++l) {
    const size_t wo = (size_t)l * H * 4 * H;
    gemm_bias_kernel<<<grid_ih, gemm_block, 0, stream>>>(
        xin, w_ih_t + wo, b_g + (size_t)l * 4 * H, xw, (int)rows, 4 * H, H);
    if ((err = check_launch())) return err;

    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(CL * tiles);
    cfg.blockDim = dim3(NT);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CL;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const size_t so = (size_t)l * B * H;
    err = (int)cudaLaunchKernelEx(&cfg, lstm_cluster_kernel,
                                  (const float*)xw, w_hh_t + wo, h0 + so,
                                  c0 + so, rnn, hn + so, cn + so, B, T, H);
    if (err) return err;
    if ((err = check_launch())) return err;

    add_ln_kernel<<<ln_blocks, 256, 0, stream>>>(
        rnn, xin, g1 + (size_t)l * H, b1 + (size_t)l * H, y, (int)rows, H);
    if ((err = check_launch())) return err;
    gemm_bias_kernel<<<grid_ff, gemm_block, 0, stream>>>(
        y, w_ff + (size_t)l * H * H, b_ff + (size_t)l * H, z, (int)rows, H,
        H);
    if ((err = check_launch())) return err;
    float* xout = (l == L - 1) ? out : ((l % 2 == 0) ? xa : xb);
    add_ln_kernel<<<ln_blocks, 256, 0, stream>>>(
        z, y, g2 + (size_t)l * H, b2 + (size_t)l * H, xout, (int)rows, H);
    if ((err = check_launch())) return err;
    xin = xout;
  }
  return 0;
}

}  // extern "C"
