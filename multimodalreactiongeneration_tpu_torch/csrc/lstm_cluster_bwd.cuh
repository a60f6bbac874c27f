// Backward building blocks of the recurrent kernels: the reverse cluster
// LSTM recurrence (over a whole sequence or over a window of steps),
// split-K reductions over rows (A^T B products and column sums), and the
// row-parallel LayerNorm backward.
//
// Used by csrc/mixer_stack.cu (the encoder-stack backward),
// csrc/lstm_layer.cu (whose weight gradients take the tensor-core
// reductions of tc_gemm.cuh instead of these), csrc/gru.cu (the column
// sum; its dW_hh takes tc_gemm.cuh's) and csrc/lstm_recurrence.cu (its
// tensor-core reverse chain takes the cell step, StepIn and cell_bwd).
//
// The reverse recurrence. The forward stored the gate activations
// A = [i, f, g, o] and the cell states c of every step, so a reverse step
// needs no transcendental but tanh(c_t):
//   dh  = dy_t + dh_carry,      dc = dh * o * (1 - tanh^2 c_t) + dc_carry
//   dgates = [dc*g*i(1-i), dc*c_{t-1}*f(1-f), dc*i*(1-g^2), dh*tanh(c_t)*o(1-o)]
//   dc_carry = dc * f,          dh_carry = dgates @ W_hh      (W_hh = w_hh_t^T)
// with c_{-1} = c0. The chain is dh_carry: an (R x 4H) @ (4H x H) product
// per step, R the batch rows per cluster. As in the forward, a cluster of 8 CTAs splits W_hh: CTA r
// keeps the 4H/8 gate columns of hidden units [r*H/8, (r+1)*H/8), now
// transposed (column-major over k, so thread k reads without bank
// conflicts), and computes those columns' dgates. Its product with its
// W_hh slice is a PARTIAL dh_carry over all H units; each CTA needs only
// its own units' sum, so every CTA writes its partial for CTA q's units
// into q's shared memory (slot r of 8) and after one cluster barrier sums
// the 8 slots. The slots are double-buffered by step parity, so the
// barrier of step t also orders step t-1's writes after step t's reads.
// A step's dy, gate activations and cell states come from device memory
// a step ahead (StepIn), so their latency is off the chain.
// One kernel runs a window of n steps from t0. K7 runs the whole
// sequence (t0 = 0, n = T) and write the dgates trajectory (B, T, 4H);
// the weight gradients and dx are then parallel products over all rows
// (below). The encoder stack's chunks (mixer_stack.cu) run windows of the
// (B, T) residual planes, read dy and write dgates in (B, n) chunk
// buffers, and hand dh_carry to the next window as its 8 unsummed slots
// (CL, B, H): the next window sums dy + slot 0 + ... + slot 7 in the
// order a step inside one window does, so every window length gives the
// same bits.
// The bf16 operand mode (TW = __nv_bfloat16, K7's bf16 instantiation)
// keeps W_hh's slice as bf16 and rounds each step's dgates to bf16 where
// they enter the dh_carry product (the dgates written out stay FP32),
// with FP32 sums, as the JAX kernels' bf16 mode (ops/lstm_bf16.py).

#pragma once

#include <algorithm>

#include "lstm_cluster.cuh"

namespace {

// split-K scratch the wrappers allocate (floats)
constexpr size_t PART_FLOATS = (size_t)1 << 22;   // A^T B partial tiles
constexpr size_t CPART_FLOATS = (size_t)1 << 18;  // column-sum partials
constexpr int SPLIT_TARGET_BLOCKS = 1024;

// R batch rows per cluster (16, 24 or 32); wbytes: bytes of a weight
size_t lstm_bwd_smem_bytes(int H, int R, int wbytes = 4) {
  const int nc = H / 2;
  const int u = H / CL;
  return (size_t)wbytes * nc * H +
         sizeof(float) * ((size_t)nc * R + 2 * (size_t)CL * R * u);
}

// What a reverse step of one (row, unit) cell reads besides the chain:
// the cotangent of its h, its gate activations, its cell state and the
// one before (dy 0 without dys). Step t of the (B, T) planes acts and
// cs; dys row b * n + t - t0 (the whole sequence: t0 = 0, n = T). Loaded
// during the step before, off the chain; nothing is loaded for a step
// outside [t0, t0 + n).
struct StepIn {
  float dy, a[4], c, cp;
};

__device__ __forceinline__ void load_step_in(
    StepIn& in, bool ok, const float* __restrict__ dys,
    const float* __restrict__ acts, const float* __restrict__ cs,
    const float* __restrict__ c0, int b, int t, int T, int t0, int n, int H,
    int col) {
  if (!ok || t < t0 || t >= t0 + n) return;
  const size_t row = (size_t)b * T + t;
  const float* a = acts + row * 4 * H + col;
  in.dy = dys ? dys[((size_t)b * n + t - t0) * H + col] : 0.f;
  in.a[0] = a[0];
  in.a[1] = a[H];
  in.a[2] = a[2 * H];
  in.a[3] = a[3 * H];
  in.c = cs[row * H + col];
  in.cp = t > 0 ? cs[(row - 1) * H + col] : c0[(size_t)b * H + col];
}

// One reverse cell step from dh (the carry and dy summed): returns the
// four dgates and updates the cell-state carry dcreg.
__device__ __forceinline__ void cell_bwd(const StepIn& in, float dh,
                                         float& dcreg, float (&d)[4]) {
  const float ai = in.a[0], af = in.a[1], ag = in.a[2], ao = in.a[3];
  const float tc = tanhf(in.c);
  const float dc = dh * ao * (1.f - tc * tc) + dcreg;
  d[0] = dc * ag * ai * (1.f - ai);
  d[1] = dc * in.cp * af * (1.f - af);
  d[2] = dc * ai * (1.f - ag * ag);
  d[3] = dh * tc * ao * (1.f - ao);
  dcreg = dc * af;
}

// R batch rows per cluster; each thread owns up to R/8 (row, unit) cells
// (H <= 256), and threads k < H compute the partial dh_carry of unit k
// for all R rows. Runs steps t0+n-1 down to t0 of the (B, T) planes acts
// and cs (the whole sequence, K7: t0 = 0, n = T). dys (B, n, H)
// and dgates (B, n, 4H) are laid out by the steps run. The state after
// the steps run is dhn, dcn (B, H), or with dhn_parts (CL, B, H) not null
// the dh_carry slots of the window after; the state before them goes to
// dh0, dc0, or its slots to dh0_parts where that is not null. TW: the
// weights' type (bf16: the operand mode above).
template <int R, typename TW = float>
__global__ void __launch_bounds__(NT, 1) lstm_cluster_bwd_kernel(
    const float* __restrict__ acts,    // (B, T, 4H) i, f, g, o
    const float* __restrict__ cs,      // (B, T, H) cell states
    const float* __restrict__ c0,      // (B, H)
    const float* __restrict__ dys,     // (B, n, H) cotangent of h_t
    const TW* __restrict__ w_hh_t,     // (H, 4H)
    const float* __restrict__ dhn,     // (B, H)
    const float* __restrict__ dcn,     // (B, H)
    const float* __restrict__ dhn_parts,  // (CL, B, H) or null
    float* __restrict__ dgates,        // (B, n, 4H)
    float* __restrict__ dh0,           // (B, H)
    float* __restrict__ dc0,           // (B, H)
    float* __restrict__ dh0_parts,     // (CL, B, H) or null
    int B, int T, int H, int t0, int n) {
  constexpr int MC = R / 8;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b0 = (blockIdx.x / CL) * R;
  const int U = H / CL;
  const int NC = 4 * U;
  const int tid = threadIdx.x;
  const size_t G = 4 * (size_t)H;
  const size_t BH = (size_t)B * H;
  const int tl = t0 + n - 1;  // the first step run

  extern __shared__ __align__(16) float smem[];
  // WsT[lc][k] = W_hh^T[k][col(lc)]
  TW* WsT = reinterpret_cast<TW*>(smem);               // [NC][H]
  float* dg = reinterpret_cast<float*>(WsT + NC * H);  // [NC][R] dgates
  // (as the product takes them: operand<TW>)
  float* red = dg + NC * R;       // [2][CL][R][U] partial dh_carry slots
  const int slot = R * U;

  for (int i = tid; i < H * NC; i += NT) {
    const int k = i / NC, lc = i % NC;
    const int g = lc / U, u = lc % U;
    WsT[lc * H + k] = w_hh_t[(size_t)k * G + g * H + rank * U + u];
  }
  float dcreg[MC];
  int own_r[MC], own_u[MC];
  bool own_in[MC], own_ok[MC];
  StepIn cur[MC], nxt[MC];
#pragma unroll
  for (int j = 0; j < MC; ++j) {
    const int p = tid + NT * j;
    own_r[j] = p / U;
    own_u[j] = p % U;
    own_in[j] = p < R * U;
    own_ok[j] = own_in[j] && b0 + own_r[j] < B;
    dcreg[j] = own_ok[j]
        ? dcn[(size_t)(b0 + own_r[j]) * H + rank * U + own_u[j]] : 0.f;
    load_step_in(cur[j], own_ok[j], dys, acts, cs, c0, b0 + own_r[j], tl, T,
                 t0, n, H, rank * U + own_u[j]);
  }
  cluster.sync();  // every CTA of the cluster runs before remote writes

  for (int t = tl; t >= t0; --t) {
    const float* rd = red + ((t + 1) & 1) * CL * slot;
#pragma unroll
    for (int j = 0; j < MC; ++j)
      load_step_in(nxt[j], own_ok[j], dys, acts, cs, c0, b0 + own_r[j],
                   t - 1, T, t0, n, H, rank * U + own_u[j]);
#pragma unroll
    for (int j = 0; j < MC; ++j) {
      if (!own_in[j]) continue;
      const int r = own_r[j], u = own_u[j];
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      if (own_ok[j]) {
        const int b = b0 + r;
        const int col = rank * U + u;
        float dh = cur[j].dy;
        if (t == tl) {
          if (dhn_parts) {
#pragma unroll
            for (int s = 0; s < CL; ++s)
              dh += dhn_parts[s * BH + (size_t)b * H + col];
          } else {
            dh += dhn[(size_t)b * H + col];
          }
        } else {
#pragma unroll
          for (int s = 0; s < CL; ++s) dh += rd[s * slot + r * U + u];
        }
        cell_bwd(cur[j], dh, dcreg[j], d);
        float* o = dgates + ((size_t)b * n + t - t0) * G + col;
        o[0] = d[0];
        o[H] = d[1];
        o[2 * H] = d[2];
        o[3 * H] = d[3];
      }
#pragma unroll
      for (int g = 0; g < 4; ++g) dg[(g * U + u) * R + r] = operand<TW>(d[g]);
    }
    __syncthreads();

    if (tid < H) {  // thread k: partial dh_carry[:, k] over this CTA's columns
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.f;
      for (int lc = 0; lc < NC; ++lc) {
        const float w = to_f(WsT[lc * H + tid]);
        const float4* d4 = reinterpret_cast<const float4*>(dg + lc * R);
#pragma unroll
        for (int q = 0; q < R / 4; ++q) {
          const float4 v = d4[q];
          acc[4 * q] = fmaf(v.x, w, acc[4 * q]);
          acc[4 * q + 1] = fmaf(v.y, w, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(v.z, w, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(v.w, w, acc[4 * q + 3]);
        }
      }
      float* dst = cluster.map_shared_rank(red, tid / U) +
                   ((t & 1) * CL + rank) * slot + tid % U;
#pragma unroll
      for (int r = 0; r < R; ++r) dst[r * U] = acc[r];
    }
    cluster.sync();
#pragma unroll
    for (int j = 0; j < MC; ++j) cur[j] = nxt[j];
  }

  const float* fin = red + (t0 & 1) * CL * slot;  // written at step t0
#pragma unroll
  for (int j = 0; j < MC; ++j) {
    if (!own_ok[j]) continue;
    const int r = own_r[j], u = own_u[j];
    const size_t o = (size_t)(b0 + r) * H + rank * U + u;
    if (dh0_parts) {
#pragma unroll
      for (int s = 0; s < CL; ++s)
        dh0_parts[s * BH + o] = fin[s * slot + r * U + u];
    } else {
      float dh = 0.f;
#pragma unroll
      for (int s = 0; s < CL; ++s) dh += fin[s * slot + r * U + u];
      dh0[o] = dh;
    }
    dc0[o] = dcreg[j];
  }
}

// ---------------------------------------------------------------------
// P[s, M, N] = sum over the rows r of split s of A'[r, :]^T B[r, :].
// A' is A (R, M), or with shift_t > 0 the one-step-shifted trajectory:
// row (b, t) of the (B, T = shift_t, M) array reads A[b, t-1], and h0[b]
// at t = 0 (the h_{t-1} of every step). Tiles of 64 x 64, 16 rows deep.
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(256) gemm_tn_partial_kernel(
    const float* __restrict__ A, const float* __restrict__ h0,
    const float* __restrict__ Bm, float* __restrict__ P, int R, int M,
    int N, int rows_per_split, int shift_t) {
  __shared__ __align__(16) float As[GM_BK][GM_BM];
  __shared__ __align__(16) float Bs[GM_BK][GM_BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * GM_BM, n0 = blockIdx.x * GM_BN;
  const int r_begin = blockIdx.z * rows_per_split;
  const int r_end = min(R, r_begin + rows_per_split);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int r0 = r_begin; r0 < r_end; r0 += GM_BK) {
    for (int i = tid; i < GM_BK * GM_BM; i += 256) {
      const int k = i / GM_BM, c = i % GM_BM;
      const int gr = r0 + k, gm = m0 + c;
      float v = 0.f;
      if (gr < r_end && gm < M) {
        if (shift_t > 0 && gr % shift_t == 0)
          v = h0[(size_t)(gr / shift_t) * M + gm];
        else if (shift_t > 0)
          v = A[(size_t)(gr - 1) * M + gm];
        else
          v = A[(size_t)gr * M + gm];
      }
      As[k][c] = v;
    }
    for (int i = tid; i < GM_BK * GM_BN; i += 256) {
      const int k = i / GM_BN, c = i % GM_BN;
      const int gr = r0 + k, gn = n0 + c;
      Bs[k][c] = (gr < r_end && gn < N) ? Bm[(size_t)gr * N + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GM_BK; ++kk) {
      float a[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = P + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < N) out[(size_t)gm * N + gn] = acc[i][j];
    }
  }
}

// out[i] = sum over s of P[s, i]; with acc, out[i] + that sum
__global__ void __launch_bounds__(256) sum_splits_kernel(
    const float* __restrict__ P, float* __restrict__ out, int splits,
    size_t n, bool acc) {
  const size_t i = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += P[(size_t)k * n + i];
  out[i] = acc ? out[i] + s : s;
}

// Column sums of several (rows, width) arrays in one pass and one sum:
// job k sums the rows of src[k] into dst[k] (with acc, adding to it); the
// jobs' columns lie side by side. Unused jobs have width 0.
constexpr int SUM_JOBS = 6;
struct ColJobs {
  const float* src[SUM_JOBS];
  float* dst[SUM_JOBS];
  int width[SUM_JOBS];
};

// the job of column x, and x's column in it
__device__ __forceinline__ int job_of(const ColJobs& jobs, int& x) {
  int k = 0;
  while (k < SUM_JOBS - 1 && x >= jobs.width[k]) x -= jobs.width[k++];
  return k;
}

// P[s, x] = sum over the rows of split s of column x
__global__ void __launch_bounds__(256) colsums_partial_kernel(
    ColJobs jobs, float* __restrict__ P, int R, int cols,
    int rows_per_split) {
  const int x = blockIdx.x * 256 + threadIdx.x;
  if (x >= cols) return;
  int n = x;
  const int k = job_of(jobs, n);
  const int N = jobs.width[k];
  const float* a = jobs.src[k];
  const int r_begin = blockIdx.y * rows_per_split;
  const int r_end = min(R, r_begin + rows_per_split);
  float s = 0.f;
  for (int r = r_begin; r < r_end; ++r) s += a[(size_t)r * N + n];
  P[(size_t)blockIdx.y * cols + x] = s;
}

// dst of column x = (with acc: dst +) the sum over s of P[s, x]
__global__ void __launch_bounds__(256) colsums_kernel(
    ColJobs jobs, const float* __restrict__ P, int splits, int cols,
    bool acc) {
  const int x = blockIdx.x * 256 + threadIdx.x;
  if (x >= cols) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += P[(size_t)k * cols + x];
  int n = x;
  float* o = jobs.dst[job_of(jobs, n)] + n;
  *o = acc ? *o + s : s;
}

// ---------------------------------------------------------------------
// LayerNorm backward for out = LN(ra + rb) * g + beta, one warp per row:
// dr = rstd * (g*dout - mean(g*dout) - xhat * mean(g*dout*xhat)); the
// statistics are recomputed from ra + rb as the forward computed them.
// Also writes dout * xhat, the terms of the scale gradient, and (dcopy
// not null) a copy of dout. Row r of dout, ra and rb is row md(r), ma(r)
// and mb(r) of its plane; dr, prod and dcopy are dense (rows, H).
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(256) ln_bwd_kernel(
    const float* __restrict__ dout, RowMap md, const float* __restrict__ ra,
    RowMap ma, const float* __restrict__ rb, RowMap mb,
    const float* __restrict__ g, float* __restrict__ dr,
    float* __restrict__ prod, float* __restrict__ dcopy, int rows, int H) {
  constexpr int V = MAX_H / 32;
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* pd = dout + md(row) * H;
  const float* pa = ra + ma(row) * H;
  const float* pb = rb + mb(row) * H;
  float rv[V], dv[V], ov[V];
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int k = lane + 32 * i;
    rv[i] = dv[i] = ov[i] = 0.f;
    if (k < H) {
      rv[i] = pa[k] + pb[k];
      ov[i] = pd[k];
      dv[i] = ov[i] * g[k];
      s += rv[i];
      ss += rv[i] * rv[i];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  }
  const float mu = s / H;
  const float rstd = rsqrtf(ss / H - mu * mu + LN_EPS);
  float m1 = 0.f, m2 = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if (lane + 32 * i < H) {
      rv[i] = (rv[i] - mu) * rstd;
      m1 += dv[i];
      m2 += dv[i] * rv[i];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    m1 += __shfl_xor_sync(0xffffffffu, m1, o);
    m2 += __shfl_xor_sync(0xffffffffu, m2, o);
  }
  m1 /= H;
  m2 /= H;
  const size_t base = (size_t)row * H;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int k = lane + 32 * i;
    if (k < H) {
      dr[base + k] = rstd * (dv[i] - m1 - rv[i] * m2);
      prod[base + k] = ov[i] * rv[i];
      if (dcopy) dcopy[base + k] = ov[i];
    }
  }
}

// ---------------------------------------------------------------------
// host helpers
// ---------------------------------------------------------------------

// out (M, N) = A'^T B over R rows (see gemm_tn_partial_kernel)
int reduce_rows_tn(const float* A, const float* h0, int shift_t,
                   const float* Bm, float* out, float* part, int R, int M,
                   int N, cudaStream_t stream) {
  const size_t mn = (size_t)M * N;
  const int tiles = ((M + GM_BM - 1) / GM_BM) * ((N + GM_BN - 1) / GM_BN);
  int splits = (SPLIT_TARGET_BLOCKS + tiles - 1) / tiles;
  splits = (int)std::min<size_t>(splits, PART_FLOATS / mn);
  splits = std::max(1, std::min(splits, (R + GM_BK - 1) / GM_BK));
  int rps = (R + splits - 1) / splits;
  rps = (rps + GM_BK - 1) / GM_BK * GM_BK;
  splits = (R + rps - 1) / rps;
  const dim3 grid((N + GM_BN - 1) / GM_BN, (M + GM_BM - 1) / GM_BM, splits);
  gemm_tn_partial_kernel<<<grid, 256, 0, stream>>>(A, h0, Bm, part, R, M, N,
                                                   rps, shift_t);
  int err = check_launch();
  if (err) return err;
  sum_splits_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(
      part, out, splits, mn, false);
  return check_launch();
}

// the jobs' column sums over R rows (see ColJobs)
int colsums(const ColJobs& jobs, float* cpart, int R, bool acc,
            cudaStream_t stream) {
  int cols = 0;
  for (int k = 0; k < SUM_JOBS; ++k) cols += jobs.width[k];
  int splits = (int)std::min<size_t>(256, CPART_FLOATS / cols);
  splits = std::max(1, std::min(splits, R));
  const int rps = (R + splits - 1) / splits;
  splits = (R + rps - 1) / rps;
  const unsigned blocks = (unsigned)((cols + 255) / 256);
  colsums_partial_kernel<<<dim3(blocks, splits), 256, 0, stream>>>(
      jobs, cpart, R, cols, rps);
  int err = check_launch();
  if (err) return err;
  colsums_kernel<<<blocks, 256, 0, stream>>>(jobs, cpart, splits, cols, acc);
  return check_launch();
}

// out[n] = sum over R rows of a[r, n]
int colsum(const float* a, float* out, float* cpart, int R, int N,
           cudaStream_t stream) {
  ColJobs jobs{};
  jobs.src[0] = a;
  jobs.dst[0] = out;
  jobs.width[0] = N;
  return colsums(jobs, cpart, R, false, stream);
}

int ln_bwd(const float* dout, RowMap md, const float* ra, RowMap ma,
           const float* rb, RowMap mb, const float* g, float* dr,
           float* prod, float* dcopy, int rows, int H, cudaStream_t stream) {
  const unsigned blocks = (unsigned)(((size_t)rows * 32 + 255) / 256);
  ln_bwd_kernel<<<blocks, 256, 0, stream>>>(dout, md, ra, ma, rb, mb, g, dr,
                                            prod, dcopy, rows, H);
  return check_launch();
}

}  // namespace
