// A stacked unidirectional LSTM run as one wavefront, forward and backward.
//
// Replaces, in multimodalreactiongeneration_tpu/ops/pallas_lstm_stacked.py
// (lstm_stacked_recurrence):
//   lstm_stacked_forward_f32, residuals on    _fwd_kernel_acts   (_vjp_fwd)
//   lstm_stacked_forward_f32, residuals off   _fwd_kernel        (the primal)
//   lstm_stacked_backward_f32                 _bwd_kernel_fused  (_vjp_bwd)
// (and _bwd_kernel, the same backward under MRGEN_FUSED_DW=0), and the
// same in JAX's bf16 operand mode (bf16 W_ih and W_hh):
//   lstm_stacked_forward_bf16, lstm_stacked_backward_bf16.
//
// What it computes. L LSTM layers over precomputed layer-0 inputs
// xw0 = x W_ih0^T + b_ih0 + b_hh0 (outside, as the JAX package leaves it
// to XLA). At wavefront slot s, layer l runs time t = s - l: every layer
// of a slot reads only the previous slot's h of itself and of the layer
// below, so the L cell updates of a slot are independent and the chain
// is T + L - 1 dependent slots instead of L x T steps. A layer outside
// its slots (s < l or s >= l + T) keeps its state frozen, so each
// layer's final state is its state after the last slot.
//
// Design. It extends the cluster recurrence of lstm_cluster.cuh: one
// persistent 8-CTA cluster per R batch rows, R = 16, 24 or 32 (a ragged
// last cluster is masked). At H = 128 every recurrent weight of the stack
// fits the cluster's shared memory: CTA r keeps the 64 gate columns of
// hidden units [16r, 16r+16) of W_hh_0..W_hh_{L-1} and W_ih_1..W_ih_{L-1}
// (L = 2: 96 KB, L = 3: 160 KB per CTA). Per slot each CTA computes its
// columns' gates of all layers from the previous slot's h of all layers
// (4 row groups of R/4 rows, one gate column a thread), updates its cells
// (cell state in registers; a thread owns unit tid % 16 of rows tid / 16
// and tid / 16 + 16), and broadcasts the new h of every layer to the 8
// CTAs through distributed shared memory: one cluster barrier per slot.
// Under grad the forward writes K7's residual layout per layer, acts
// (L, B, T, 4H) = [i, f, g, o] and cs (L, B, T, H), plus the h
// trajectories of the lower layers (L-1, B, T, H); at B256 x T1120 x L2
// that is 1.76 GB (the JAX A/M layout would be ~2.7 GB).
//
// Rows per cluster. A CTA needs 136 / 156 / 176 KB at L = 2 and R = 16 /
// 24 / 32, forward and backward alike, so an SM holds one, and an H100
// holds 15 such clusters at once (the occupancy query,
// lstm_stacked_resident_clusters). At R 16, lstm_with_sampling's batch of
// 256 needs 16 clusters: the 16th ran its whole chain in a second wave,
// doubling the kernel's time. The wrapper (ops/lstm_stacked.py) picks the
// smallest R whose clusters the card holds in one wave: R 24 at B256 (11
// clusters). L = 3 takes 220 KB at R 16 and does not fit more rows: it
// keeps R 16, in waves beyond 240 rows.
//
// The backward is the reverse wavefront. At reverse slot s, layer l
// (time t = s - l) takes
//   dh = dys_t (top layer) + dhn (t = T-1)
//        + [dgates_l(t+1) W_hh_l^T + dgates_{l+1}(t) W_ih_{l+1}^T],
// and both products in brackets come from the dgates of the previous
// reverse slot s+1. Each CTA keeps its 64 columns of every matrix,
// transposed, multiplies its columns' dgates into a PARTIAL of the
// bracket over all H units, and writes each CTA q's units into q's
// shared memory (slot r of 8); after one cluster barrier every CTA sums
// its 8 slots (double-buffered by slot parity, as lstm_cluster_bwd.cuh).
// A slot's dy, gate activations and cell states are loaded during the
// slot before. The sum read by layer l one slot before its first step is
// dh0_l. The dgates of every layer go to device memory (L, B, T, 4H);
// layer 0's are dxw0. dW_hh_l = h_l(t-1)^T dgates_l and dW_ih_l =
// h_{l-1}(t)^T dgates_l are deterministic split-K reductions over all
// B*T rows on the tensor cores in 3xTF32 (tc_gemm.cuh: FP32 accuracy, the
// sums cancel heavily), db_l = colsum(dgates_l) in FP32.
//
// What bounds it. The chain of T + L - 1 dependent slots, each a
// cluster barrier plus an (R x 128) x (128 x 64) FP32 product per matrix
// per CTA on the CUDA cores. Its FLOP bound at B256 x T1120 x H128 x L2
// is 2 B T 4H H (2L-1) FLOPs at 67 TFLOP/s = 1.7 ms forward (3.4 ms
// backward); the per-slot products on the tensor cores are later work.
//
// Shapes: H = 128, L = 2 or 3, any B, any T >= 1. FP32 throughout in the
// FP32 mode.
//
// The bf16 operand mode (TW = bf16). The weight slices are held as bf16
// (L = 2: 48 KB a CTA where FP32 takes 96), every h is rounded to bf16
// where it enters a product (the exchanged copy; each thread keeps its
// cells' FP32 state in registers), and the backward's dgates where they
// enter the bracket's products; FP32 sums, state and residuals. dW_hh and
// dW_ih are bf16 operand products (bf16_gemm.cuh: one mma.sync.m16n8k16
// pass where the FP32 mode takes three TF32 passes), each FP32 sum
// rounded once to bf16; db and dxw0 stay FP32, from the unrounded dgates,
// as in JAX's bf16 mode (ops/lstm_bf16.py).

#include "bf16_gemm.cuh"
#include "tc_gemm.cuh"

namespace {

constexpr int SH = 128;         // the hidden size the kernels take
constexpr int SU = SH / CL;     // hidden units per CTA: 16
constexpr int SNC = 4 * SU;     // gate columns per CTA and matrix: 64

// shared memory at R rows per cluster: the 2L-1 weight slices (wbytes a
// weight: 4 FP32, 2 bf16), then the kernel's buffers
size_t stacked_fwd_smem_bytes(int L, int R, int wbytes = 4) {
  return (size_t)wbytes * (2 * L - 1) * SH * SNC +
         sizeof(float) * (2 * (size_t)L * R * SH + (size_t)L * R * SNC);
}

size_t stacked_bwd_smem_bytes(int L, int R, int wbytes = 4) {
  return (size_t)wbytes * (2 * L - 1) * SNC * SH +
         sizeof(float) * ((size_t)L * SNC * R + 2 * (size_t)L * CL * R * SU);
}

// cells a thread owns per layer at R rows: R x 16 units over 256 threads
__host__ __device__ constexpr int stacked_cells(int R) {
  return (R * SU + NT - 1) / NT;
}

// a0 += h[rows] . w0[:, cl]; with UP also a1 += h[rows] . w1[:, cl]
// (w0 = W_hh of layer l, w1 = W_ih of layer l+1: both read h_l); rows
// rg*RG .. rg*RG+RG-1
template <bool UP, int RG, typename TW>
__device__ __forceinline__ void mac_rows(const float* __restrict__ h,
                                         const TW* __restrict__ w0,
                                         const TW* __restrict__ w1,
                                         int rg, int cl, float (&a0)[RG],
                                         float (&a1)[RG]) {
  for (int k = 0; k < SH; k += 4) {
    float4 hv[RG];
#pragma unroll
    for (int i = 0; i < RG; ++i)
      hv[i] = *reinterpret_cast<const float4*>(&h[(rg * RG + i) * SH + k]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float x0 = to_f(w0[(k + kk) * SNC + cl]);
      const float x1 = UP ? to_f(w1[(k + kk) * SNC + cl]) : 0.f;
#pragma unroll
      for (int i = 0; i < RG; ++i) {
        const float hk = kk == 0 ? hv[i].x
                       : kk == 1 ? hv[i].y
                       : kk == 2 ? hv[i].z
                                 : hv[i].w;
        a0[i] = fmaf(hk, x0, a0[i]);
        if (UP) a1[i] = fmaf(hk, x1, a1[i]);
      }
    }
  }
}

// R rows per cluster, L layers, TW the weights' type. hs, acts and cs
// null: no training residuals (the inference forward)
template <int R, int L, typename TW = float>
__global__ void __launch_bounds__(NT, 1) lstm_stacked_fwd_kernel(
    const float* __restrict__ xw0,     // (B, T, 4H)
    const TW* __restrict__ w_ih_t,     // (L-1, H, 4H)
    const float* __restrict__ b_rest,  // (L-1, 4H)
    const TW* __restrict__ w_hh_t,     // (L, H, 4H)
    const float* __restrict__ h0,      // (L, B, H)
    const float* __restrict__ c0,      // (L, B, H)
    float* __restrict__ ys,            // (B, T, H) the top layer's h
    float* __restrict__ hn,            // (L, B, H)
    float* __restrict__ cn,            // (L, B, H)
    float* __restrict__ hs,            // (L-1, B, T, H) or null
    float* __restrict__ acts,          // (L, B, T, 4H) or null
    float* __restrict__ cs,            // (L, B, T, H) or null
    int B, int T) {
  constexpr int H = SH, U = SU, NC = SNC;
  constexpr int RG = R / 4, MC = stacked_cells(R);
  constexpr size_t G = 4 * SH;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b0 = (blockIdx.x / CL) * R;
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) float smem[];
  TW* Ws = reinterpret_cast<TW*>(smem);  // [2L-1][H][NC]
  // [2][L][R][H]: h as the products take it (operand<TW>)
  float* hbuf = reinterpret_cast<float*>(Ws + (2 * L - 1) * H * NC);
  float* gsm = hbuf + 2 * L * R * H;     // [L][R][NC]

  // matrix m < L is W_hh_m, m >= L is W_ih_{m-L+1}; local column
  // lc = g*U + u  <->  global gate column g*H + rank*U + u
  for (int i = tid; i < (2 * L - 1) * H * NC; i += NT) {
    const int m = i / (H * NC), k = (i / NC) % H, lc = i % NC;
    const TW* w = m < L ? w_hh_t + (size_t)m * H * G
                        : w_ih_t + (size_t)(m - L) * H * G;
    Ws[i] = w[(size_t)k * G + (lc / U) * H + rank * U + lc % U];
  }
  for (int i = tid; i < L * R * H; i += NT) {
    const int l = i / (R * H), b = b0 + (i / H) % R;
    hbuf[i] = operand<TW>(b < B ? h0[((size_t)l * B + b) * H + i % H] : 0.f);
  }
  // each thread owns the cells of unit own_u in rows own_r[j] of every
  // layer; own_in: the row is one of the cluster's R, row_ok: and a batch
  // row (rows past B run on zeros and are never stored)
  const int own_u = tid % U;
  const int col = rank * U + own_u;
  int own_r[MC];
  bool own_in[MC], row_ok[MC];
  // creg, hreg: the FP32 state of the thread's cells
  float creg[L][MC], hreg[L][MC], bias[L][4];
#pragma unroll
  for (int j = 0; j < MC; ++j) {
    own_r[j] = tid / U + (NT / U) * j;
    own_in[j] = own_r[j] < R;
    row_ok[j] = own_in[j] && b0 + own_r[j] < B;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const size_t st = ((size_t)l * B + b0 + own_r[j]) * H + col;
      creg[l][j] = row_ok[j] ? c0[st] : 0.f;
      hreg[l][j] = row_ok[j] ? h0[st] : 0.f;
    }
  }
#pragma unroll
  for (int l = 0; l < L; ++l)
#pragma unroll
    for (int g = 0; g < 4; ++g)
      bias[l][g] = l > 0 ? b_rest[(l - 1) * G + g * H + col] : 0.f;
  // layer 0's input at slot s (t = s), loaded before the slot's product
  auto load_xw = [&](int s, float (&x)[MC][4]) {
#pragma unroll
    for (int j = 0; j < MC; ++j)
#pragma unroll
      for (int g = 0; g < 4; ++g)
        x[j][g] = row_ok[j] && s < T
            ? xw0[((size_t)(b0 + own_r[j]) * T + s) * G + g * H + col]
            : 0.f;
  };
  cluster.sync();

  const int rg = tid / 64;  // rows rg*RG .. rg*RG+RG-1
  const int cl = tid % 64;  // local gate column
  const int S = T + L - 1;
  for (int s = 0; s < S; ++s) {
    const float* hcur = hbuf + (s & 1) * L * R * H;
    const int nxt = ((s + 1) & 1) * L * R * H;
    float xg[MC][4];
    load_xw(s, xg);

    float acc[L][RG];
#pragma unroll
    for (int l = 0; l < L; ++l)
#pragma unroll
      for (int i = 0; i < RG; ++i) acc[l][i] = 0.f;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const float* hl = hcur + l * R * H;
      const TW* whh = Ws + l * H * NC;
      if (l + 1 < L)
        mac_rows<true, RG>(hl, whh, Ws + (L + l) * H * NC, rg, cl, acc[l],
                           acc[l + 1 < L ? l + 1 : l]);
      else
        mac_rows<false, RG>(hl, whh, whh, rg, cl, acc[l], acc[l]);
    }
#pragma unroll
    for (int l = 0; l < L; ++l)
#pragma unroll
      for (int i = 0; i < RG; ++i)
        gsm[(l * R + rg * RG + i) * NC + cl] = acc[l][i];
    __syncthreads();

#pragma unroll
    for (int l = 0; l < L; ++l) {
      const int t = s - l;
      const bool valid = t >= 0 && t < T;
#pragma unroll
      for (int j = 0; j < MC; ++j) {
        if (!own_in[j]) continue;
        const float* gr = gsm + (l * R + own_r[j]) * NC;
        float in[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) in[g] = l == 0 ? xg[j][g] : bias[l][g];
        const float gi = sigmoidf_(gr[own_u] + in[0]);
        const float gf = sigmoidf_(gr[U + own_u] + in[1]);
        const float gg = tanhf(gr[2 * U + own_u] + in[2]);
        const float go = sigmoidf_(gr[3 * U + own_u] + in[3]);
        const float c = gf * creg[l][j] + gi * gg;
        const float h = go * tanhf(c);
        const int cell = (l * R + own_r[j]) * H + col;
        if (valid) {
          creg[l][j] = c;
          hreg[l][j] = h;
        }
        const float h_op = operand<TW>(hreg[l][j]);
#pragma unroll
        for (int q = 0; q < CL; ++q)
          cluster.map_shared_rank(hbuf, q)[nxt + cell] = h_op;
        if (row_ok[j] && valid) {
          const size_t row = (size_t)(b0 + own_r[j]) * T + t;
          const size_t lrow = (size_t)l * B * T + row;
          if (l == L - 1) ys[row * H + col] = h;
          if (acts) {
            float* a = acts + lrow * G + col;
            a[0] = gi;
            a[H] = gf;
            a[2 * H] = gg;
            a[3 * H] = go;
            cs[lrow * H + col] = c;
            if (l < L - 1) hs[lrow * H + col] = h;
          }
        }
      }
    }
    cluster.sync();
  }

#pragma unroll
  for (int j = 0; j < MC; ++j) {
    if (!row_ok[j]) continue;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const size_t o = ((size_t)l * B + b0 + own_r[j]) * H + col;
      hn[o] = hreg[l][j];
      cn[o] = creg[l][j];
    }
  }
}

// acc[r] += sum over this CTA's columns lc of d[lc][r] * wT[lc][k]
template <int R, typename TW>
__device__ __forceinline__ void mac_cols(const float* __restrict__ d,
                                         const TW* __restrict__ wT, int k,
                                         float (&acc)[R]) {
  for (int lc = 0; lc < SNC; ++lc) {
    const float w = to_f(wT[lc * SH + k]);
    const float4* d4 = reinterpret_cast<const float4*>(d + lc * R);
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      const float4 v = d4[q];
      acc[4 * q] = fmaf(v.x, w, acc[4 * q]);
      acc[4 * q + 1] = fmaf(v.y, w, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(v.z, w, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(v.w, w, acc[4 * q + 3]);
    }
  }
}

template <int R, int L, typename TW = float>
__global__ void __launch_bounds__(NT, 1) lstm_stacked_bwd_kernel(
    const float* __restrict__ acts,    // (L, B, T, 4H) i, f, g, o
    const float* __restrict__ cs,      // (L, B, T, H) cell states
    const float* __restrict__ c0,      // (L, B, H)
    const float* __restrict__ dys,     // (B, T, H) cotangent of the top h
    const TW* __restrict__ w_ih_t,     // (L-1, H, 4H)
    const TW* __restrict__ w_hh_t,     // (L, H, 4H)
    const float* __restrict__ dhn,     // (L, B, H)
    const float* __restrict__ dcn,     // (L, B, H)
    float* __restrict__ dgates,        // (L, B, T, 4H)
    float* __restrict__ dh0,           // (L, B, H)
    float* __restrict__ dc0,           // (L, B, H)
    int B, int T) {
  constexpr int H = SH, U = SU, NC = SNC, MC = stacked_cells(R);
  constexpr size_t G = 4 * SH;
  constexpr int SLOT = R * U;  // one CTA's partial for one target CTA
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b0 = (blockIdx.x / CL) * R;
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) float smem[];
  TW* WsT = reinterpret_cast<TW*>(smem);  // [2L-1][NC][H], transposed
  // [L][NC][R] this slot's dgates, as the products take them
  float* dg = reinterpret_cast<float*>(WsT + (2 * L - 1) * NC * H);
  float* red = dg + L * NC * R;              // [2][L][CL][R][U] partials

  for (int i = tid; i < (2 * L - 1) * H * NC; i += NT) {
    const int m = i / (H * NC), k = (i / NC) % H, lc = i % NC;
    const TW* w = m < L ? w_hh_t + (size_t)m * H * G
                        : w_ih_t + (size_t)(m - L) * H * G;
    WsT[(m * NC + lc) * H + k] =
        w[(size_t)k * G + (lc / U) * H + rank * U + lc % U];
  }
  for (int i = tid; i < 2 * L * CL * SLOT; i += NT) red[i] = 0.f;
  const int own_u = tid % U;
  const int col = rank * U + own_u;
  int own_r[MC];
  bool own_in[MC], row_ok[MC];
  float dcreg[L][MC];
  StepIn cur[L][MC], nxt[L][MC];
  const int S = T + L - 1;
  // layer l's step inputs at slot s (t = s - l); dys only for the top
  auto load = [&](StepIn (&in)[L][MC], int s) {
#pragma unroll
    for (int l = 0; l < L; ++l)
#pragma unroll
      for (int j = 0; j < MC; ++j)
        load_step_in(in[l][j], row_ok[j], l == L - 1 ? dys : nullptr,
                     acts + (size_t)l * B * T * G, cs + (size_t)l * B * T * H,
                     c0 + (size_t)l * B * H, b0 + own_r[j], s - l, T, 0, T,
                     H, col);
  };
#pragma unroll
  for (int j = 0; j < MC; ++j) {
    own_r[j] = tid / U + (NT / U) * j;
    own_in[j] = own_r[j] < R;
    row_ok[j] = own_in[j] && b0 + own_r[j] < B;
#pragma unroll
    for (int l = 0; l < L; ++l)
      dcreg[l][j] =
          row_ok[j] ? dcn[((size_t)l * B + b0 + own_r[j]) * H + col] : 0.f;
  }
  load(cur, S - 1);
  cluster.sync();  // every CTA is zeroed and running before remote writes

  // slot -1 only reads: the sum layer 0 gets there is its dh0
  for (int s = S - 1; s >= -1; --s) {
    const float* rd = red + ((s + 1) & 1) * L * CL * SLOT;
    load(nxt, s - 1);
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const int t = s - l;
#pragma unroll
      for (int j = 0; j < MC; ++j) {
        if (!own_in[j]) continue;
        const int r = own_r[j];
        float dh = 0.f;
#pragma unroll
        for (int q = 0; q < CL; ++q)
          dh += rd[(l * CL + q) * SLOT + r * U + own_u];
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        const size_t st = ((size_t)l * B + b0 + r) * H + col;
        if (row_ok[j] && t >= 0 && t < T) {
          dh += cur[l][j].dy;
          if (t == T - 1) dh += dhn[st];
          cell_bwd(cur[l][j], dh, dcreg[l][j], d);
          float* o = dgates + ((size_t)l * B * T + (size_t)(b0 + r) * T + t) *
                                  G + col;
          o[0] = d[0];
          o[H] = d[1];
          o[2 * H] = d[2];
          o[3 * H] = d[3];
        } else if (row_ok[j] && t == -1) {
          dh0[st] = dh;
          dc0[st] = dcreg[l][j];
        }
#pragma unroll
        for (int g = 0; g < 4; ++g)
          dg[(l * NC + g * U + own_u) * R + r] = operand<TW>(d[g]);
      }
    }
    if (s < 0) break;
    __syncthreads();

    // the partial bracket of target layer m, unit k, over this CTA's
    // columns: dgates_m W_hh_m^T + dgates_{m+1} W_ih_{m+1}^T
    for (int p = tid; p < L * H; p += NT) {
      const int m = p / H, k = p % H;
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.f;
      mac_cols<R>(dg + m * NC * R, WsT + m * NC * H, k, acc);
      if (m + 1 < L)
        mac_cols<R>(dg + (m + 1) * NC * R, WsT + (L + m) * NC * H, k, acc);
      float* dst = cluster.map_shared_rank(red, k / U) +
                   (((s & 1) * L + m) * CL + rank) * SLOT + k % U;
#pragma unroll
      for (int r = 0; r < R; ++r) dst[r * U] = acc[r];
    }
    cluster.sync();
#pragma unroll
    for (int l = 0; l < L; ++l)
#pragma unroll
      for (int j = 0; j < MC; ++j) cur[l][j] = nxt[l][j];
  }
}

template <typename TW>
using StackedFwd = decltype(&lstm_stacked_fwd_kernel<16, 2, TW>);
template <typename TW>
using StackedBwd = decltype(&lstm_stacked_bwd_kernel<16, 2, TW>);

// the instantiations, per weight type: L 2 at R 16, 24 and 32; L 3 only
// at R 16 (its 2L-1 = 5 FP32 weight slices leave no room for more rows)
template <typename TW>
StackedFwd<TW> stacked_fwd(int L, int R) {
  if (L == 3) return R == 16 ? lstm_stacked_fwd_kernel<16, 3, TW> : nullptr;
  if (L != 2) return nullptr;
  switch (R) {
    case 16: return lstm_stacked_fwd_kernel<16, 2, TW>;
    case 24: return lstm_stacked_fwd_kernel<24, 2, TW>;
    case 32: return lstm_stacked_fwd_kernel<32, 2, TW>;
  }
  return nullptr;
}

template <typename TW>
StackedBwd<TW> stacked_bwd(int L, int R) {
  if (L == 3) return R == 16 ? lstm_stacked_bwd_kernel<16, 3, TW> : nullptr;
  if (L != 2) return nullptr;
  switch (R) {
    case 16: return lstm_stacked_bwd_kernel<16, 2, TW>;
    case 24: return lstm_stacked_bwd_kernel<24, 2, TW>;
    case 32: return lstm_stacked_bwd_kernel<32, 2, TW>;
  }
  return nullptr;
}

template <typename TW>
int stacked_forward(const float* xw0, const TW* w_ih_t, const float* b_rest,
                    const TW* w_hh_t, const float* h0, const float* c0,
                    float* ys, float* hn, float* cn, float* hs, float* acts,
                    float* cs, int B, int T, int L, int R, void* stream_ptr) {
  const StackedFwd<TW> kernel = stacked_fwd<TW>(L, R);
  if (!kernel || B <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  return launch_cluster(kernel,
                        stacked_fwd_smem_bytes(L, R, (int)sizeof(TW)), B, R,
                        (cudaStream_t)stream_ptr, xw0, w_ih_t, b_rest, w_hh_t,
                        h0, c0, ys, hn, cn, hs, acts, cs, B, T);
}

template <typename TW>
int resident_stacked(int L, int backward, int R, size_t smem) {
  return backward ? resident_clusters(stacked_bwd<TW>(L, R), smem)
                  : resident_clusters(stacked_fwd<TW>(L, R), smem);
}

}  // namespace

extern "C" {

// shared memory of one CTA of the forward (backward) at R rows, of the
// FP32 or (bf != 0) the bf16 mode; more than a block can use where no
// kernel is instantiated (L 3 beyond R 16), so no caller picks that R
long long lstm_stacked_smem_bytes(int L, int backward, int R, int bf) {
  if (!stacked_fwd<float>(L, R)) return (long long)SMEM_LIMIT + 1;
  const int wb = bf ? 2 : 4;
  return (long long)(backward ? stacked_bwd_smem_bytes(L, R, wb)
                              : stacked_fwd_smem_bytes(L, R, wb));
}

// xw0 (B,T,4H); w_ih_t (L-1,H,4H); b_rest (L-1,4H); w_hh_t (L,H,4H);
// h0, c0 (L,B,H). Writes ys (B,T,H), hn, cn (L,B,H) and, when hs, acts
// and cs are not null, the training residuals hs (L-1,B,T,H), acts
// (L,B,T,4H) = [i, f, g, o] and cs (L,B,T,H). R rows per cluster.
int lstm_stacked_forward_f32(const float* xw0, const float* w_ih_t,
                             const float* b_rest, const float* w_hh_t,
                             const float* h0, const float* c0, float* ys,
                             float* hn, float* cn, float* hs, float* acts,
                             float* cs, int B, int T, int L, int R,
                             void* stream_ptr) {
  return stacked_forward(xw0, w_ih_t, b_rest, w_hh_t, h0, c0, ys, hn, cn, hs,
                         acts, cs, B, T, L, R, stream_ptr);
}

// The same in the bf16 mode: w_ih_t, w_hh_t bf16, the rest FP32.
int lstm_stacked_forward_bf16(const float* xw0, const bf16* w_ih_t,
                              const float* b_rest, const bf16* w_hh_t,
                              const float* h0, const float* c0, float* ys,
                              float* hn, float* cn, float* hs, float* acts,
                              float* cs, int B, int T, int L, int R,
                              void* stream_ptr) {
  return stacked_forward(xw0, w_ih_t, b_rest, w_hh_t, h0, c0, ys, hn, cn, hs,
                         acts, cs, B, T, L, R, stream_ptr);
}

// How many clusters of the forward (backward) kernel of one mode at R
// rows the card holds at once; a batch of more than R times as many rows
// runs in waves. -1 if there is no such kernel or on an error.
int lstm_stacked_resident_clusters(int L, int backward, int R, int bf) {
  const size_t smem = (size_t)lstm_stacked_smem_bytes(L, backward, R, bf);
  return bf ? resident_stacked<bf16>(L, backward, R, smem)
            : resident_stacked<float>(L, backward, R, smem);
}

// floats of backward scratch: the split-K partials
long long lstm_stacked_backward_workspace_floats() {
  return (long long)(PART_FLOATS + CPART_FLOATS);
}

// From the forward's residuals and the cotangents dys (B,T,H), dhn, dcn
// (L,B,H): dgates (L,B,T,4H) (layer 0's are dxw0), dw_ih_t (L-1,H,4H),
// db (L-1,4H), dw_hh_t (L,H,4H), dh0, dc0 (L,B,H). R rows per cluster.
int lstm_stacked_backward_f32(const float* w_ih_t, const float* w_hh_t,
                              const float* h0, const float* c0,
                              const float* ys, const float* hs,
                              const float* acts, const float* cs,
                              const float* dys, const float* dhn,
                              const float* dcn, float* dgates, float* dwih,
                              float* db, float* dwhh, float* dh0, float* dc0,
                              float* ws, int B, int T, int L, int R,
                              void* stream_ptr) {
  const StackedBwd<float> kernel = stacked_bwd<float>(L, R);
  if (!kernel || B <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const size_t G = 4 * SH, rows = (size_t)B * T;
  int err = launch_cluster(kernel, stacked_bwd_smem_bytes(L, R), B, R, stream,
                           acts, cs, c0, dys, w_ih_t, w_hh_t, dhn, dcn,
                           dgates, dh0, dc0, B, T);
  if (err) return err;
  float* part = ws;
  float* cpart = ws + PART_FLOATS;
  for (int l = 0; l < L; ++l) {
    const float* dg_l = dgates + l * rows * G;
    const float* h_l = l == L - 1 ? ys : hs + l * rows * SH;
    // dW_hh_l = h_l(t-1)^T dgates_l, with h_l(-1) = h0_l
    if ((err = reduce_rows_tn_tc(h_l, h0 + (size_t)l * B * SH, T, dg_l,
                                 dwhh + l * SH * G, part, (int)rows, SH,
                                 (int)G, stream)))
      return err;
    if (l == 0) continue;
    // layer l's input is h_{l-1}(t): dW_ih_l = h_{l-1}^T dgates_l
    if ((err = reduce_rows_tn_tc(hs + (l - 1) * rows * SH, nullptr, 0, dg_l,
                                 dwih + (l - 1) * SH * G, part, (int)rows, SH,
                                 (int)G, stream)))
      return err;
    if ((err = colsum(dg_l, db + (l - 1) * G, cpart, (int)rows, (int)G,
                      stream)))
      return err;
  }
  return 0;
}

// The bf16 mode: w_ih_t, w_hh_t bf16; dw_ih_t and dw_hh_t bf16 (each
// FP32 sum rounded once); dgates, db, dh0, dc0 and the rest FP32.
int lstm_stacked_backward_bf16(const bf16* w_ih_t, const bf16* w_hh_t,
                               const float* h0, const float* c0,
                               const float* ys, const float* hs,
                               const float* acts, const float* cs,
                               const float* dys, const float* dhn,
                               const float* dcn, float* dgates, bf16* dwih,
                               float* db, bf16* dwhh, float* dh0, float* dc0,
                               float* ws, int B, int T, int L, int R,
                               void* stream_ptr) {
  const StackedBwd<bf16> kernel = stacked_bwd<bf16>(L, R);
  if (!kernel || B <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const size_t G = 4 * SH, rows = (size_t)B * T;
  int err = launch_cluster(kernel, stacked_bwd_smem_bytes(L, R, 2), B, R,
                           stream, acts, cs, c0, dys, w_ih_t, w_hh_t, dhn,
                           dcn, dgates, dh0, dc0, B, T);
  if (err) return err;
  float* part = ws;
  float* cpart = ws + PART_FLOATS;
  for (int l = 0; l < L; ++l) {
    const float* dg_l = dgates + l * rows * G;
    const float* h_l = l == L - 1 ? ys : hs + l * rows * SH;
    if ((err = reduce_rows_tn_bf16(h_l, h0 + (size_t)l * B * SH, T, dg_l,
                                   dwhh + l * SH * G, part, (int)rows, SH,
                                   (int)G, stream)))
      return err;
    if (l == 0) continue;
    if ((err = reduce_rows_tn_bf16(hs + (l - 1) * rows * SH,
                                   (const float*)nullptr, 0, dg_l,
                                   dwih + (l - 1) * SH * G, part, (int)rows,
                                   SH, (int)G, stream)))
      return err;
    if ((err = colsum(dg_l, db + (l - 1) * G, cpart, (int)rows, (int)G,
                      stream)))
      return err;
  }
  return 0;
}

}  // extern "C"
