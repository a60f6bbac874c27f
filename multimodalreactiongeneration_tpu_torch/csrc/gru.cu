// GRU recurrence (K10), forward and backward.
//
// Replaces, in multimodalreactiongeneration_tpu/ops/pallas_gru.py
// (gru_recurrence):
//   gru_forward_f32, hh null     _fwd_kernel         (the primal)
//   gru_forward_f32, hh given    _fwd_kernel_savehh  (_vjp_fwd)
//   gru_backward_f32             _bwd_kernel and the dW_hh / db_hh
//                                reductions of _bwd_impl (_vjp_bwd)
//
// Layouts as the JAX kernel's: xw (B, T, 3H) = x @ W_ih^T + b_ih, w_hh_t
// (H, 3H) = W_hh^T, b_hh (3H), h0 (B, H); gate order r, z, n, with b_hn
// inside the reset product:
//   hh = h_{t-1} @ w_hh_t + b_hh,  r = s(xr + hr),  z = s(xz + hz),
//   n = tanh(xn + r * hn),          h_t = (1 - z) * n + z * h_{t-1}.
//
// What bounds it: a chain of T steps, each a (16 x H) @ (H x 3H) product
// that needs the previous step's h. Its FLOPs (2 B T 3H H) take a fraction
// of a millisecond at the card's FP32 rate; the per-step latency (the
// product on the few SMs of one cluster, then one cluster barrier) times
// T is what counts. The design is the LSTM kernels' (lstm_cluster.cuh,
// lstm_cluster_bwd.cuh): a cluster of 8 CTAs holds W_hh in shared memory,
// CTA r the 3H/8 gate columns of hidden units [r H/8, (r+1) H/8) (96 KB of
// FP32 at H 256); 16 batch rows per cluster; one cluster barrier per step.
//
// The GRU step has its own thread layout, for both H the kernels take
// (U = H/8 units per CTA: 16 or 32). Thread (row group, unit u) computes
// the three gate columns r, z, n of ONE unit for U/16 rows, so the cell
// that follows needs nothing from another thread: the product's sums stay
// in registers, hn apart for the reset product. (The LSTM step's layout
// spreads 4U gate columns over 64 threads and needs 4U >= 64, which a GRU
// at H 128, 48 columns, does not meet.) h goes to every CTA's copy of the
// (16 x H) state through distributed shared memory, double-buffered by
// step parity.
//
// The backward is the reverse chain from the forward's saved hh, with no
// recompute of the hidden product. Per step, per (row, unit):
//   dh = dy_t + carry,  dz = dh (h_{t-1} - n),  dn = dh (1 - z),
//   dgn = dn (1 - n^2), dr = dgn hn,  dhn = dgn r,
//   dgr = dr r (1 - r), dgz = dz z (1 - z),
//   dxw = [dgr, dgz, dgn],  dhh = [dgr, dgz, dhn],
//   carry' = dh z + dhh @ W_hh.
// Each CTA computes its units' dxw and dhh; its product with its W_hh
// slice is a PARTIAL carry over all H units, which it writes into the
// owning CTA's slot r of 8 (distributed shared memory, slots double-
// buffered by parity, one barrier per step), as lstm_cluster_bwd_kernel
// does. dW_hh^T = h_shift^T dhh and db_hh = colsum(dhh) then reduce over
// all B*T rows outside the chain, as in the JAX package, with the
// deterministic split-K kernels of lstm_cluster_bwd.cuh.
//
// Numerics: FP32 throughout, no tensor cores.

#include "lstm_cluster_bwd.cuh"

namespace {

// the H the kernels take: U = H/8 units per CTA must be 16 or 32 for the
// step's thread layout (256 threads = (16 rows / (U/16)) x U)
inline bool gru_hidden_ok(int H) { return H == 128 || H == 256; }

template <int U>
constexpr size_t gru_fwd_smem() {
  return sizeof(float) * ((size_t)CL * U * 3 * U + 2 * BT * (CL * U + 4));
}

template <int U>
constexpr size_t gru_bwd_smem() {
  return sizeof(float) *
         ((size_t)3 * U * CL * U + 3 * U * BT + 2 * (size_t)CL * BT * U);
}

// hh (B, T, 3H), null for the primal, is the backward's residual:
// h_{t-1} @ w_hh_t + b_hh of every step
template <int U>
__global__ void __launch_bounds__(NT, 1) gru_fwd_kernel(
    const float* __restrict__ xw,      // (B, T, 3H)
    const float* __restrict__ w_hh_t,  // (H, 3H)
    const float* __restrict__ b_hh,    // (3H)
    const float* __restrict__ h0,      // (B, H)
    float* __restrict__ ys,            // (B, T, H)
    float* __restrict__ hn,            // (B, H)
    float* __restrict__ hh,            // (B, T, 3H) or null
    int B, int T) {
  constexpr int H = CL * U, NC = 3 * U, RPT = U / 16, HS = H + 4;
  static_assert(RPT * (NT / U) == BT, "thread layout covers 16 rows");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b0 = (blockIdx.x / CL) * BT;
  const int tid = threadIdx.x;
  const int u = tid % U, r0 = (tid / U) * RPT;
  const int col = rank * U + u;  // this thread's hidden unit
  const size_t G = 3 * (size_t)H;

  extern __shared__ __align__(16) float smem[];
  float* Ws = smem;            // [H][NC]: Ws[k][g*U + u] = w_hh_t[k][g*H + col]
  float* hbuf = Ws + H * NC;   // [2][BT][HS] (rows padded: no bank conflict)

  for (int i = tid; i < H * NC; i += NT) {
    const int k = i / NC, lc = i % NC;
    Ws[i] = w_hh_t[(size_t)k * G + (lc / U) * H + rank * U + lc % U];
  }
  for (int i = tid; i < BT * H; i += NT) {
    const int r = i / H, k = i % H;
    hbuf[r * HS + k] = b0 + r < B ? h0[(size_t)(b0 + r) * H + k] : 0.f;
  }
  float bias[3];
#pragma unroll
  for (int g = 0; g < 3; ++g) bias[g] = b_hh[g * H + col];
  bool ok[RPT];
  float x[RPT][3];  // this step's xw, loaded a step ahead
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    ok[i] = b0 + r0 + i < B;
#pragma unroll
    for (int g = 0; g < 3; ++g)
      x[i][g] = ok[i] ? xw[(size_t)(b0 + r0 + i) * T * G + g * H + col] : 0.f;
  }
  cluster.sync();

  for (int t = 0; t < T; ++t) {
    const float* hcur = hbuf + (t & 1) * BT * HS;
    const int nxt = ((t + 1) & 1) * BT * HS;

    float acc[RPT][3];
#pragma unroll
    for (int i = 0; i < RPT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = 0.f;
    for (int k = 0; k < H; k += 4) {
      float4 hv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        hv[i] = *reinterpret_cast<const float4*>(&hcur[(r0 + i) * HS + k]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* w = Ws + (k + kk) * NC + u;
        const float w0 = w[0], w1 = w[U], w2 = w[2 * U];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float hk = kk == 0 ? hv[i].x
                         : kk == 1 ? hv[i].y
                         : kk == 2 ? hv[i].z
                                   : hv[i].w;
          acc[i][0] = fmaf(hk, w0, acc[i][0]);
          acc[i][1] = fmaf(hk, w1, acc[i][1]);
          acc[i][2] = fmaf(hk, w2, acc[i][2]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = r0 + i;
      const float hr = acc[i][0] + bias[0];
      const float hz = acc[i][1] + bias[1];
      const float hnn = acc[i][2] + bias[2];
      const float rg = sigmoidf_(x[i][0] + hr);
      const float z = sigmoidf_(x[i][1] + hz);
      const float n = tanhf(x[i][2] + rg * hnn);
      const float h = (1.f - z) * n + z * hcur[r * HS + col];
#pragma unroll
      for (int q = 0; q < CL; ++q)
        cluster.map_shared_rank(hbuf, q)[nxt + r * HS + col] = h;
      if (ok[i]) {
        const size_t row = (size_t)(b0 + r) * T + t;
        ys[row * H + col] = h;
        if (hh) {
          float* o = hh + row * G + col;
          o[0] = hr;
          o[H] = hz;
          o[2 * H] = hnn;
        }
        if (t + 1 < T) {
#pragma unroll
          for (int g = 0; g < 3; ++g) x[i][g] = xw[(row + 1) * G + g * H + col];
        }
      }
    }
    cluster.sync();
  }

  const float* hlast = hbuf + (T & 1) * BT * HS;
#pragma unroll
  for (int i = 0; i < RPT; ++i)
    if (ok[i])
      hn[(size_t)(b0 + r0 + i) * H + col] = hlast[(r0 + i) * HS + col];
}

// dhh (B, T, 3H) is the cotangent of hh, for the weight reductions after
template <int U>
__global__ void __launch_bounds__(NT, 1) gru_bwd_kernel(
    const float* __restrict__ xw,      // (B, T, 3H)
    const float* __restrict__ hh,      // (B, T, 3H) saved by the forward
    const float* __restrict__ w_hh_t,  // (H, 3H)
    const float* __restrict__ h0,      // (B, H)
    const float* __restrict__ ys,      // (B, T, H)
    const float* __restrict__ dys,     // (B, T, H)
    const float* __restrict__ dhn,     // (B, H)
    float* __restrict__ dxw,           // (B, T, 3H)
    float* __restrict__ dhh,           // (B, T, 3H)
    float* __restrict__ dh0,           // (B, H)
    int B, int T) {
  constexpr int H = CL * U, NC = 3 * U, RPT = U / 16, SLOT = BT * U;
  constexpr int RB = BT * H / NT;  // rows per thread in the carry product
  static_assert(RB % 4 == 0 && NT % H == 0, "carry product layout");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b0 = (blockIdx.x / CL) * BT;
  const int tid = threadIdx.x;
  const int u = tid % U, r0 = (tid / U) * RPT;
  const int col = rank * U + u;
  const int kq = tid % H, rq = (tid / H) * RB;  // carry product: column, rows
  const size_t G = 3 * (size_t)H;

  extern __shared__ __align__(16) float smem[];
  float* WsT = smem;          // [NC][H]: WsT[g*U + u][k] = w_hh_t[k][g*H + col]
  float* dg = WsT + NC * H;   // [NC][BT] this step's dhh slice
  float* red = dg + NC * BT;  // [2][CL][BT][U] partial carry slots

  for (int i = tid; i < H * NC; i += NT) {
    const int k = i / NC, lc = i % NC;
    WsT[lc * H + k] = w_hh_t[(size_t)k * G + (lc / U) * H + rank * U + lc % U];
  }
  // per owned (row, unit): the local carry dh z, and the next step's
  // inputs, loaded a step ahead: dy, xw (3), hh (3), h_{t-1}
  float carry[RPT], in[RPT][8];
  bool ok[RPT];
  auto load = [&](int i, int t) {
    const int b = b0 + r0 + i;
    const size_t row = (size_t)b * T + t;
    in[i][0] = dys[row * H + col];
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      in[i][1 + g] = xw[row * G + g * H + col];
      in[i][4 + g] = hh[row * G + g * H + col];
    }
    in[i][7] = t > 0 ? ys[(row - 1) * H + col] : h0[(size_t)b * H + col];
  };
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    carry[i] = 0.f;
    ok[i] = b0 + r0 + i < B;
    if (ok[i]) {
      load(i, T - 1);
      carry[i] = dhn[(size_t)(b0 + r0 + i) * H + col];
    }
  }
  cluster.sync();  // every CTA of the cluster runs before remote writes

  for (int t = T - 1; t >= 0; --t) {
    const float* rd = red + ((t + 1) & 1) * CL * SLOT;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = r0 + i;
      float d[3] = {0.f, 0.f, 0.f};
      if (ok[i]) {
        const size_t row = (size_t)(b0 + r) * T + t;
        float dh = in[i][0] + carry[i];
        if (t < T - 1) {
#pragma unroll
          for (int s = 0; s < CL; ++s) dh += rd[s * SLOT + r * U + u];
        }
        const float hr = in[i][4], hz = in[i][5], hnn = in[i][6];
        const float rg = sigmoidf_(in[i][1] + hr);
        const float z = sigmoidf_(in[i][2] + hz);
        const float n = tanhf(in[i][3] + rg * hnn);
        const float dz = dh * (in[i][7] - n);
        const float dgn = dh * (1.f - z) * (1.f - n * n);
        const float dgr = dgn * hnn * rg * (1.f - rg);
        const float dgz = dz * z * (1.f - z);
        d[0] = dgr;
        d[1] = dgz;
        d[2] = dgn * rg;
        carry[i] = dh * z;
        float* ox = dxw + row * G + col;
        float* oh = dhh + row * G + col;
        ox[0] = oh[0] = dgr;
        ox[H] = oh[H] = dgz;
        ox[2 * H] = dgn;
        oh[2 * H] = d[2];
        if (t > 0) load(i, t - 1);
      }
#pragma unroll
      for (int g = 0; g < 3; ++g) dg[(g * U + u) * BT + r] = d[g];
    }
    __syncthreads();

    {  // thread kq: partial carry[:, kq] over this CTA's columns
      float acc[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) acc[r] = 0.f;
      for (int lc = 0; lc < NC; ++lc) {
        const float w = WsT[lc * H + kq];
        const float4* d4 = reinterpret_cast<const float4*>(dg + lc * BT + rq);
#pragma unroll
        for (int q = 0; q < RB / 4; ++q) {
          const float4 v = d4[q];
          acc[4 * q] = fmaf(v.x, w, acc[4 * q]);
          acc[4 * q + 1] = fmaf(v.y, w, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(v.z, w, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(v.w, w, acc[4 * q + 3]);
        }
      }
      float* dst = cluster.map_shared_rank(red, kq / U) +
                   ((t & 1) * CL + rank) * SLOT + kq % U;
#pragma unroll
      for (int r = 0; r < RB; ++r) dst[(rq + r) * U] = acc[r];
    }
    cluster.sync();
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    if (!ok[i]) continue;
    const int r = r0 + i;
    float dh = carry[i];
#pragma unroll
    for (int s = 0; s < CL; ++s) dh += red[s * SLOT + r * U + u];
    dh0[(size_t)(b0 + r) * H + col] = dh;
  }
}

template <int U>
int gru_forward(const float* xw, const float* w_hh_t, const float* b_hh,
                const float* h0, float* ys, float* hn, float* hh, int B,
                int T, cudaStream_t stream) {
  return launch_cluster(gru_fwd_kernel<U>, gru_fwd_smem<U>(), B, BT, stream,
                        xw, w_hh_t, b_hh, h0, ys, hn, hh, B, T);
}

template <int U>
int gru_backward(const float* xw, const float* hh, const float* w_hh_t,
                 const float* h0, const float* ys, const float* dys,
                 const float* dhn, float* dxw, float* dhh, float* dh0, int B,
                 int T, cudaStream_t stream) {
  return launch_cluster(gru_bwd_kernel<U>, gru_bwd_smem<U>(), B, BT, stream,
                        xw, hh, w_hh_t, h0, ys, dys, dhn, dxw, dhh, dh0, B,
                        T);
}

}  // namespace

extern "C" {

// xw (B,T,3H); w_hh_t (H,3H); b_hh (3H); h0 (B,H). Writes ys (B,T,H), hn
// (B,H) and, when hh is not null, the residual hh (B,T,3H).
int gru_forward_f32(const float* xw, const float* w_hh_t, const float* b_hh,
                    const float* h0, float* ys, float* hn, float* hh, int B,
                    int T, int H, void* stream_ptr) {
  if (!gru_hidden_ok(H) || B <= 0 || T <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream_ptr;
  return H == 256 ? gru_forward<32>(xw, w_hh_t, b_hh, h0, ys, hn, hh, B, T, s)
                  : gru_forward<16>(xw, w_hh_t, b_hh, h0, ys, hn, hh, B, T, s);
}

// floats of backward scratch: dhh (B, T, 3H) and split-K partials
long long gru_backward_workspace_floats(int B, int T, int H) {
  return (long long)B * T * 3 * H + (long long)(PART_FLOATS + CPART_FLOATS);
}

// From the forward's ys and hh and the cotangents dys (B,T,H), dhn (B,H):
// dxw (B,T,3H), dw_hh_t (H,3H), db_hh (3H), dh0 (B,H).
int gru_backward_f32(const float* xw, const float* hh, const float* w_hh_t,
                     const float* h0, const float* ys, const float* dys,
                     const float* dhn, float* dxw, float* dwhh, float* dbhh,
                     float* dh0, float* ws, int B, int T, int H,
                     void* stream_ptr) {
  if (!gru_hidden_ok(H) || B <= 0 || T <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream_ptr;
  float* dhh = ws;
  float* part = dhh + (size_t)B * T * 3 * H;
  int err = H == 256 ? gru_backward<32>(xw, hh, w_hh_t, h0, ys, dys, dhn, dxw,
                                        dhh, dh0, B, T, s)
                     : gru_backward<16>(xw, hh, w_hh_t, h0, ys, dys, dhn, dxw,
                                        dhh, dh0, B, T, s);
  if (err) return err;
  const int rows = B * T;
  if ((err = reduce_rows_tn(ys, h0, T, dhh, dwhh, part, rows, H, 3 * H, s)))
    return err;
  return colsum(dhh, dbhh, part + PART_FLOATS, rows, 3 * H, s);
}

}  // extern "C"
