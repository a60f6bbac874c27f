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
// of a millisecond at the card's rates; the per-step latency (the product
// on the few SMs of one cluster, the cell, the exchange of h and the wait
// for it) times T is what counts. A cluster of CLN CTAs holds W_hh: CTA r
// owns the 3U gate columns r, z, n of hidden units [r U, (r+1) U), U = H /
// CLN; 16 batch rows per cluster, rows past B run on zeros and are never
// stored.
//
// Forward step, per CTA:
//  * the product h_{t-1} (16 x H) @ W slice (H x 3U) on the tensor cores,
//    mma.sync.m16n8k8 in 3xTF32 (tf32x3.cuh): the cluster's 16 rows are
//    one M tile. Warp (ug, ks) owns units [8 ug, 8 ug + 8) of the CTA,
//    i.e. the three n-tiles r, z, n of those units, over K range ks of
//    KS = 8 / (U / 8), so the accumulators of one thread hold all three
//    gates of its (row, unit) cells. W's fragments are split into TF32 hi
//    and lo once, at kernel start, and kept in registers (hi always; lo
//    too when a warp holds at most 24 fragments, else in shared memory in
//    fragment order), so each W element is read once per step per CTA.
//    The K index of a fragment is permuted inside each group of 16 so
//    that a thread reads its four A values of two k-steps as one float4
//    of h (rows padded to H + 16 floats: the float4 reads are free of
//    bank conflicts); h is split into hi and lo as it is read. Even and
//    odd k-steps sum into separate accumulators (six independent chains
//    of MMAs a warp).
//  * the K split is reduced through shared memory in ks order, and the
//    KS warps of a unit group share the cell: warp ks computes the
//    fragment elements [ks 4/KS, (ks+1) 4/KS) of its lanes.
//  * the exchange (cluster_exchange.cuh): the CTA's 16 x U block of h is
//    staged in shared memory and written to every CTA's copy of the state
//    (double-buffered by step parity) with 16-byte st.async stores into
//    distributed shared memory, each of which completes 16 bytes of the
//    receiver's transaction barrier (an mbarrier per buffer, armed for the
//    16 x H x 4 bytes of a step). Then ys and hh go to device memory and
//    the next step's xw is loaded, then each CTA waits on its own barrier:
//    one wait a step, for the data it needs, and no cluster-wide barrier
//    (a cluster barrier, split into arrive and wait, measured slower). A
//    CTA sends step t's h only after its last read of the buffer step t +
//    1 overwrites, so the data order keeps the two buffers free of races
//    at any B and T.
//
// The backward is the reverse chain from the forward's saved hh, with no
// recompute of the hidden product. Per step, per (row, unit):
//   dh = dy_t + carry,  dz = dh (h_{t-1} - n),  dn = dh (1 - z),
//   dgn = dn (1 - n^2), dr = dgn hn,  dhn = dgn r,
//   dgr = dr r (1 - r), dgz = dz z (1 - z),
//   dxw = [dgr, dgz, dgn],  dhh = [dgr, dgz, dhn],
//   carry' = dh z + dhh @ W_hh.
// Each CTA computes its units' dxw and dhh (thread: one unit, U/16 rows);
// dhh goes through shared memory to the carry product dhh (16 x 3U) @
// W_slice^T (3U x H) in 3xTF32 mma.sync, warp w computing the n-tiles of
// units [8 w H/64, 8 (w+1) H/64) over all of K = 3U, from W^T fragments
// split once into hi and lo as in the forward. That product is a PARTIAL
// carry over all H units; each lane pairs with its neighbour (one
// shuffle) to hold four consecutive units of one row and writes them
// with one 16-byte st.async into slot r of the owning CTA (slots double-
// buffered by parity, a transaction barrier per parity, one wait a step;
// a __syncthreads after it, since a warp may send no slot to its own
// CTA and its peers must be done with dhh). dh sums dy, the local carry
// and slots 0..CLN-1 in that order, so the result is the same from run
// to run. dW_hh^T = h_shift^T dhh reduces over all B*T rows outside the
// chain in 3xTF32 (tc_gemm.cuh reduce_rows_tn_tc, deterministic split-K)
// and db_hh = colsum(dhh), as in the JAX package.
//
// Cluster size (the sweep of PERF.md, on an H100): at H 256, 16 CTAs (U
// 16; a non-portable size) halve each CTA's product and W slice against
// 8 and run B32 x T2016 ~18% faster forward and ~25% backward, but the
// card holds only 7 such clusters, so a batch of more than 112 rows runs
// over 8 CTAs (15 resident) rather than in two waves; ops/gru.py
// launch_ctas picks from the occupancy query gru_resident_clusters. At
// H 128, 8 CTAs (4 and 2 were slower). The SIMT product (each thread all
// 16 rows of its columns) was slower than the tensor cores at every size.
//
// Numerics: the products in 3xTF32 (FP32's order of error, tf32x3.cuh);
// cell math, state and sums in FP32.

#include "cluster_exchange.cuh"
#include "tc_gemm.cuh"

namespace {

// Built with -DGRU_STAMPS (a build only a measuring tool asks for),
// thread 0 of each of the first 16 CTAs stamps %globaltimer at the
// marks of a step (the start, the product, the cell, the exchange
// stores, the wait passed) for steps [STAMP_T0, STAMP_T0 +
// STAMP_STEPS) of the forward and of the backward (counted from the
// last step); gru_stamps() reads them back.
constexpr int STAMP_T0 = 64, STAMP_STEPS = 16, STAMP_CTAS = 16;
constexpr int STAMP_MARKS = 5;
#ifdef GRU_STAMPS
__device__ unsigned long long
    g_gru_stamps[2][STAMP_STEPS][STAMP_CTAS][STAMP_MARKS];
#endif

// mark `m` of step `step` of the forward (dir 0) or the backward (dir 1)
__device__ __forceinline__ void stamp(int dir, int step, int m) {
#ifdef GRU_STAMPS
  const int s = step - STAMP_T0;
  if (threadIdx.x == 0 && blockIdx.x < STAMP_CTAS && s >= 0 &&
      s < STAMP_STEPS) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_gru_stamps[dir][s][blockIdx.x][m] = t;
  }
#endif
}

// the hidden sizes and CTAs per cluster the kernels take: H 256 over 16
// or 8, H 128 over 8 (ops/gru.py launch_ctas picks)
inline bool gru_shape_ok(int H, int ctas) {
  return (H == 256 && (ctas == 16 || ctas == 8)) || (H == 128 && ctas == 8);
}

// The shape of a step for hidden size H over a cluster of CLN CTAs.
template <int H, int CLN>
struct Gru {
  static constexpr int U = H / CLN;   // units a CTA owns
  static constexpr int UG = U / 8;    // unit groups (n-tile triples)
  static constexpr int KS = 8 / UG;   // forward: warps splitting K
  static constexpr int EPW = 4 / KS;  // forward: cell elements a lane
  static constexpr int KF = H / KS;   // forward: K range of a warp
  static constexpr int KSF = KF / 8;  // forward: k-steps of a warp
  static constexpr bool LO_F = 3 * KSF > 24;  // lo fragments in smem
  static constexpr int NPW = H / 64;  // backward: n-tiles a warp
  static constexpr int KSB = 3 * U / 8;       // backward: k-steps
  static constexpr bool LO_B = NPW * KSB > 24;
  static constexpr int RPT = U / 16;  // backward: cell rows a thread
  static constexpr int HS = H + 16;   // row stride of the h state
  static constexpr int DS = 3 * U + (48 - (3 * U) % 32) % 32;  // of dhh
  static constexpr int SLOT = BT * U;  // a partial-carry slot
  static_assert(UG * KS == 8 && KS <= 4 && KF % 16 == 0 && KSB % 2 == 0,
                "step layout: 8 warps, k-steps in pairs");
  static_assert(HS % 32 == 16 && DS % 32 == 16, "float4 rows on 32 banks");

  static constexpr size_t fwd_smem() {
    return 16 + sizeof(float) * (2 * (size_t)BT * HS + KS * UG * 3 * 32 * 4 +
                            BT * U) +
           (LO_F ? sizeof(uint2) * 8 * 3 * KSF * 32 : 0);
  }
  static constexpr size_t bwd_smem() {
    return 16 + sizeof(float) * (2 * (size_t)CLN * SLOT + BT * DS) +
           (LO_B ? sizeof(uint2) * 8 * NPW * KSB * 32 : 0);
  }
};

// hh (B, T, 3H), null for the primal, is the backward's residual:
// h_{t-1} @ w_hh_t + b_hh of every step
template <int H, int CLN>
__global__ void __launch_bounds__(NT, 1) gru_fwd_kernel(
    const float* __restrict__ xw,      // (B, T, 3H)
    const float* __restrict__ w_hh_t,  // (H, 3H)
    const float* __restrict__ b_hh,    // (3H)
    const float* __restrict__ h0,      // (B, H)
    float* __restrict__ ys,            // (B, T, H)
    float* __restrict__ hn,            // (B, H)
    float* __restrict__ hh,            // (B, T, 3H) or null
    int B, int T) {
  using C = Gru<H, CLN>;
  constexpr int U = C::U, UG = C::UG, KS = C::KS, EPW = C::EPW;
  constexpr int KSF = C::KSF, HS = C::HS;
  constexpr bool LO = C::LO_F;
  constexpr int CH = BT * U / 4;  // float4 chunks of the CTA's h block
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b0 = (blockIdx.x / CLN) * BT;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const int ug = warp % UG, ks = warp / UG;
  const int kb = ks * C::KF + 4 * q;  // this lane's first k
  const size_t G = 3 * (size_t)H;

  extern __shared__ __align__(16) float smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // [2] per buffer
  float* hbuf = smem + 4;  // [2][BT][HS] the state, double-buffered
  float* red = hbuf + 2 * BT * HS;  // [KS][UG][3 gates][32 lanes][4]
  float* hs = red + KS * UG * 3 * 32 * 4;  // [BT][U] this step's h block
  uint2* wlo = reinterpret_cast<uint2*>(hs + BT * U);  // [8][3][KSF][32]

  // B fragments: k-step s reads k = kb + 16 (s / 2) + 2 (s % 2) (b0) and
  // the k after it (b1), column gate * H + rank U + 8 ug + g
  uint32_t whi[3][KSF][2], wl[3][LO ? 1 : KSF][2];
#pragma unroll
  for (int gt = 0; gt < 3; ++gt)
#pragma unroll
    for (int s = 0; s < KSF; ++s) {
      const int k = kb + 16 * (s / 2) + 2 * (s % 2);
      const float* w = w_hh_t + (size_t)k * G + gt * H + rank * U + 8 * ug + g;
      uint32_t lo[2];
      split_tf32(w[0], whi[gt][s][0], lo[0]);
      split_tf32(w[G], whi[gt][s][1], lo[1]);
      if constexpr (LO)
        wlo[((warp * 3 + gt) * KSF + s) * 32 + lane] = make_uint2(lo[0], lo[1]);
      else
        wl[gt][LO ? 0 : s][0] = lo[0], wl[gt][LO ? 0 : s][1] = lo[1];
    }
  for (int i = tid; i < BT * H; i += NT) {
    const int r = i / H, k = i % H;
    hbuf[r * HS + k] = b0 + r < B ? h0[(size_t)(b0 + r) * H + k] : 0.f;
  }
  // this lane's cells: fragment elements e = ks EPW + i, at row g + 8 (e /
  // 2), unit 8 ug + 2 q + e % 2
  int row[EPW], col[EPW];
  bool ok[EPW];
  float bias[EPW][3], x[EPW][3];  // x: this step's xw, loaded a step ahead
#pragma unroll
  for (int i = 0; i < EPW; ++i) {
    const int e = ks * EPW + i;
    row[i] = g + 8 * (e / 2);
    col[i] = rank * U + 8 * ug + 2 * q + e % 2;
    ok[i] = b0 + row[i] < B;
#pragma unroll
    for (int gt = 0; gt < 3; ++gt) {
      bias[i][gt] = b_hh[gt * H + col[i]];
      x[i][gt] = ok[i] ? xw[(size_t)(b0 + row[i]) * T * G + gt * H + col[i]]
                       : 0.f;
    }
  }
  constexpr uint32_t BYTES = BT * H * sizeof(float);  // a step's state
  uint32_t ph = 0;  // bit b: the parity of buffer b's next phase
  if (tid == 0) {
    mbar_init(&full[0]);
    mbar_init(&full[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect(&full[0], BYTES);
    mbar_expect(&full[1], BYTES);
  }
  cluster.sync();  // every CTA runs, its barriers armed, before any st.async

  for (int t = 0; t < T; ++t) {
    stamp(0, t, 0);
    const float* hc = hbuf + (t & 1) * BT * HS;
    float acc[2][3][4];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int gt = 0; gt < 3; ++gt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[p][gt][c] = 0.f;
#pragma unroll
    for (int p = 0; p < KSF / 2; ++p) {
      const float4 va = *reinterpret_cast<const float4*>(hc + g * HS + kb +
                                                         16 * p);
      const float4 vb = *reinterpret_cast<const float4*>(
          hc + (g + 8) * HS + kb + 16 * p);
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        const int s = 2 * p + o;
        uint32_t ah[4], al[4];
        split_tf32_alu(o ? va.z : va.x, ah[0], al[0]);
        split_tf32_alu(o ? vb.z : vb.x, ah[1], al[1]);
        split_tf32_alu(o ? va.w : va.y, ah[2], al[2]);
        split_tf32_alu(o ? vb.w : vb.y, ah[3], al[3]);
#pragma unroll
        for (int gt = 0; gt < 3; ++gt) {
          uint32_t bl[2];
          if constexpr (LO) {
            const uint2 v = wlo[((warp * 3 + gt) * KSF + s) * 32 + lane];
            bl[0] = v.x, bl[1] = v.y;
          } else {
            bl[0] = wl[gt][LO ? 0 : s][0], bl[1] = wl[gt][LO ? 0 : s][1];
          }
          mma_3xtf32(acc[o][gt], ah, al, whi[gt][s], bl);
        }
      }
    }
#pragma unroll
    for (int gt = 0; gt < 3; ++gt)
      reinterpret_cast<float4*>(red)[((ks * UG + ug) * 3 + gt) * 32 + lane] =
          make_float4(acc[0][gt][0] + acc[1][gt][0],
                      acc[0][gt][1] + acc[1][gt][1],
                      acc[0][gt][2] + acc[1][gt][2],
                      acc[0][gt][3] + acc[1][gt][3]);
    __syncthreads();
    stamp(0, t, 1);

    float hv[EPW][3];
#pragma unroll
    for (int i = 0; i < EPW; ++i) {
      const int e = ks * EPW + i;
#pragma unroll
      for (int gt = 0; gt < 3; ++gt) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < KS; ++k)
          s += red[(((k * UG + ug) * 3 + gt) * 32 + lane) * 4 + e];
        hv[i][gt] = s + bias[i][gt];
      }
      const float rg = sigmoidf_(x[i][0] + hv[i][0]);
      const float z = sigmoidf_(x[i][1] + hv[i][1]);
      const float n = tanhf(x[i][2] + rg * hv[i][2]);
      hs[row[i] * U + col[i] - rank * U] =
          (1.f - z) * n + z * hc[row[i] * HS + col[i]];
    }
    __syncthreads();
    stamp(0, t, 2);

    float* nxt = hbuf + ((t + 1) & 1) * BT * HS;
    for (int i = tid; i < CH * CLN; i += NT) {
      const int peer = i / CH, c = i % CH;
      const int r = c / (U / 4), u = 4 * (c % (U / 4));
      const float4 v = *reinterpret_cast<const float4*>(hs + r * U + u);
      st_async16(nxt + r * HS + rank * U + u, &full[(t + 1) & 1], peer, v);
    }
    stamp(0, t, 3);
    for (int c = tid; c < CH; c += NT) {
      const int r = c / (U / 4), u = 4 * (c % (U / 4));
      if (b0 + r < B)
        *reinterpret_cast<float4*>(ys + ((size_t)(b0 + r) * T + t) * H +
                                   rank * U + u) =
            *reinterpret_cast<const float4*>(hs + r * U + u);
    }
#pragma unroll
    for (int i = 0; i < EPW; ++i) {
      if (!ok[i]) continue;
      const size_t at = ((size_t)(b0 + row[i]) * T + t) * G + col[i];
      if (hh) {
#pragma unroll
        for (int gt = 0; gt < 3; ++gt) hh[at + gt * H] = hv[i][gt];
      }
      if (t + 1 < T) {
#pragma unroll
        for (int gt = 0; gt < 3; ++gt) x[i][gt] = xw[at + G + gt * H];
      }
    }
    {  // this step's state from every CTA; re-armed for step t + 2's
      const int b = (t + 1) & 1;
      mbar_wait(&full[b], (ph >> b) & 1);
      ph ^= 1u << b;
      if (tid == 0 && t + 2 < T) mbar_expect(&full[b], BYTES);
    }
    stamp(0, t, 4);
  }

  const float* hlast = hbuf + (T & 1) * BT * HS;
  for (int i = tid; i < BT * U; i += NT) {
    const int r = i / U, k = rank * U + i % U;
    if (b0 + r < B) hn[(size_t)(b0 + r) * H + k] = hlast[r * HS + k];
  }
}

// dhh (B, T, 3H) is the cotangent of hh, for the weight reductions after
template <int H, int CLN>
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
  using C = Gru<H, CLN>;
  constexpr int U = C::U, RPT = C::RPT, NPW = C::NPW, KSB = C::KSB;
  constexpr int DS = C::DS, SLOT = C::SLOT;
  constexpr bool LO = C::LO_B;
  static_assert(RPT * (NT / U) == BT, "cell layout covers 16 rows");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b0 = (blockIdx.x / CLN) * BT;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const int u = tid % U, r0 = (tid / U) * RPT;  // cell: unit, first row
  const int col = rank * U + u;
  const size_t G = 3 * (size_t)H;

  extern __shared__ __align__(16) float smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // [2] per parity
  float* red = smem + 4;           // [2][CLN][BT][U] partial carry slots
  float* dg = red + 2 * CLN * SLOT;  // [BT][DS] this step's dhh slice
  uint2* wlo = reinterpret_cast<uint2*>(dg + BT * DS);  // [8][NPW][KSB][32]

  // B fragments of W^T: k-step s reads local gate column lc = 16 (s / 2)
  // + 4 q + 2 (s % 2) (b0) and the one after it (b1), of unit n = 8 j + g
  // of n-tile j = warp NPW + jj; local column lc is w_hh_t's column
  // (lc / U) H + rank U + lc % U
  uint32_t whi[NPW][KSB][2], wl[NPW][LO ? 1 : KSB][2];
#pragma unroll
  for (int jj = 0; jj < NPW; ++jj)
#pragma unroll
    for (int s = 0; s < KSB; ++s) {
      const int lc = 16 * (s / 2) + 4 * q + 2 * (s % 2);
      const float* w = w_hh_t + (size_t)(8 * (warp * NPW + jj) + g) * G;
      uint32_t lo[2];
#pragma unroll
      for (int c = 0; c < 2; ++c)
        split_tf32(w[((lc + c) / U) * H + rank * U + (lc + c) % U],
                   whi[jj][s][c], lo[c]);
      if constexpr (LO)
        wlo[((warp * NPW + jj) * KSB + s) * 32 + lane] =
            make_uint2(lo[0], lo[1]);
      else
        wl[jj][LO ? 0 : s][0] = lo[0], wl[jj][LO ? 0 : s][1] = lo[1];
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
    for (int g3 = 0; g3 < 3; ++g3) {
      in[i][1 + g3] = xw[row * G + g3 * H + col];
      in[i][4 + g3] = hh[row * G + g3 * H + col];
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
  constexpr uint32_t BYTES = BT * H * sizeof(float);  // a step's slots
  uint32_t ph = 0;  // bit b: the parity of slot set b's next phase
  if (tid == 0) {
    mbar_init(&full[0]);
    mbar_init(&full[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect(&full[0], BYTES);
    mbar_expect(&full[1], BYTES);
  }
  cluster.sync();  // every CTA runs, its barriers armed, before any st.async

  for (int t = T - 1; t >= 0; --t) {
    stamp(1, T - 1 - t, 0);
    const float* rd = red + ((t + 1) & 1) * CLN * SLOT;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = r0 + i;
      float d[3] = {0.f, 0.f, 0.f};
      if (ok[i]) {
        const size_t row = (size_t)(b0 + r) * T + t;
        float dh = in[i][0] + carry[i];
        if (t < T - 1) {
#pragma unroll
          for (int s = 0; s < CLN; ++s) dh += rd[s * SLOT + r * U + u];
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
      }
#pragma unroll
      for (int g3 = 0; g3 < 3; ++g3) dg[r * DS + g3 * U + u] = d[g3];
    }
    __syncthreads();
    stamp(1, T - 1 - t, 1);

    float acc[2][NPW][4];
#pragma unroll
    for (int o = 0; o < 2; ++o)
#pragma unroll
      for (int jj = 0; jj < NPW; ++jj)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[o][jj][c] = 0.f;
#pragma unroll
    for (int p = 0; p < KSB / 2; ++p) {
      const float4 va =
          *reinterpret_cast<const float4*>(dg + g * DS + 16 * p + 4 * q);
      const float4 vb = *reinterpret_cast<const float4*>(
          dg + (g + 8) * DS + 16 * p + 4 * q);
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        const int s = 2 * p + o;
        uint32_t ah[4], al[4];
        split_tf32_alu(o ? va.z : va.x, ah[0], al[0]);
        split_tf32_alu(o ? vb.z : vb.x, ah[1], al[1]);
        split_tf32_alu(o ? va.w : va.y, ah[2], al[2]);
        split_tf32_alu(o ? vb.w : vb.y, ah[3], al[3]);
#pragma unroll
        for (int jj = 0; jj < NPW; ++jj) {
          uint32_t bl[2];
          if constexpr (LO) {
            const uint2 v = wlo[((warp * NPW + jj) * KSB + s) * 32 + lane];
            bl[0] = v.x, bl[1] = v.y;
          } else {
            bl[0] = wl[jj][LO ? 0 : s][0], bl[1] = wl[jj][LO ? 0 : s][1];
          }
          mma_3xtf32(acc[o][jj], ah, al, whi[jj][s], bl);
        }
      }
    }
    stamp(1, T - 1 - t, 2);

    // lane pairs (q even, q + 1): the even lane sends row g, units 2q ..
    // 2q + 3 of the n-tile, the odd one row g + 8, units 2q - 2 .. 2q + 1
    const bool odd = q & 1;
#pragma unroll
    for (int jj = 0; jj < NPW; ++jj) {
      float c[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) c[e] = acc[0][jj][e] + acc[1][jj][e];
      const float s0 = __shfl_xor_sync(0xffffffffu, odd ? c[0] : c[2], 1);
      const float s1 = __shfl_xor_sync(0xffffffffu, odd ? c[1] : c[3], 1);
      const float4 v = odd ? make_float4(s0, s1, c[2], c[3])
                           : make_float4(c[0], c[1], s0, s1);
      const int n = 8 * (warp * NPW + jj);  // the n-tile's first unit
      const int r = odd ? g + 8 : g, un = n % U + 2 * (odd ? q - 1 : q);
      st_async16(red + ((t & 1) * CLN + rank) * SLOT + r * U + un,
                 &full[t & 1], n / U, v);
    }
    stamp(1, T - 1 - t, 3);
    if (t > 0) {
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        if (ok[i]) load(i, t - 1);
    }
    {  // this step's partial carries from every CTA; re-armed for t - 2's
      const int b = t & 1;
      mbar_wait(&full[b], (ph >> b) & 1);
      ph ^= 1u << b;
      if (tid == 0 && t >= 2) mbar_expect(&full[b], BYTES);
      __syncthreads();  // every warp is done with dg (it may send no slot here)
    }
    stamp(1, T - 1 - t, 4);
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    if (!ok[i]) continue;
    const int r = r0 + i;
    float dh = carry[i];
#pragma unroll
    for (int s = 0; s < CLN; ++s) dh += red[s * SLOT + r * U + u];
    dh0[(size_t)(b0 + r) * H + col] = dh;
  }
}

template <int H, int CLN>
int gru_forward(const float* xw, const float* w_hh_t, const float* b_hh,
                const float* h0, float* ys, float* hn, float* hh, int B,
                int T, cudaStream_t stream) {
  return launch_cluster_n<CLN>(gru_fwd_kernel<H, CLN>,
                               Gru<H, CLN>::fwd_smem(), B, stream, xw,
                               w_hh_t, b_hh, h0, ys, hn, hh, B, T);
}

template <int H, int CLN>
int gru_backward(const float* xw, const float* hh, const float* w_hh_t,
                 const float* h0, const float* ys, const float* dys,
                 const float* dhn, float* dxw, float* dhh, float* dh0, int B,
                 int T, cudaStream_t stream) {
  return launch_cluster_n<CLN>(gru_bwd_kernel<H, CLN>,
                               Gru<H, CLN>::bwd_smem(), B, stream, xw, hh,
                               w_hh_t, h0, ys, dys, dhn, dxw, dhh, dh0, B,
                               T);
}

}  // namespace

extern "C" {

// xw (B,T,3H); w_hh_t (H,3H); b_hh (3H); h0 (B,H). Writes ys (B,T,H), hn
// (B,H) and, when hh is not null, the residual hh (B,T,3H). ctas: CTAs
// per cluster (gru_shape_ok).
int gru_forward_f32(const float* xw, const float* w_hh_t, const float* b_hh,
                    const float* h0, float* ys, float* hn, float* hh, int B,
                    int T, int H, int ctas, void* stream_ptr) {
  if (!gru_shape_ok(H, ctas) || B <= 0 || T <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream_ptr;
  if (H == 128)
    return gru_forward<128, 8>(xw, w_hh_t, b_hh, h0, ys, hn, hh, B, T, s);
  return ctas == 16
             ? gru_forward<256, 16>(xw, w_hh_t, b_hh, h0, ys, hn, hh, B, T, s)
             : gru_forward<256, 8>(xw, w_hh_t, b_hh, h0, ys, hn, hh, B, T, s);
}

// Clusters of 16 batch rows the card runs at once for hidden size H over
// clusters of `ctas` CTAs, the fewer of the forward's and the backward's;
// more run in waves. -1 on an error.
int gru_resident_clusters(int H, int ctas) {
  if (!gru_shape_ok(H, ctas)) return -1;
  int f, b;
  if (H == 128) {
    f = resident_cluster_n<8>(gru_fwd_kernel<128, 8>,
                              Gru<128, 8>::fwd_smem());
    b = resident_cluster_n<8>(gru_bwd_kernel<128, 8>,
                              Gru<128, 8>::bwd_smem());
  } else if (ctas == 16) {
    f = resident_cluster_n<16>(gru_fwd_kernel<256, 16>,
                               Gru<256, 16>::fwd_smem());
    b = resident_cluster_n<16>(gru_bwd_kernel<256, 16>,
                               Gru<256, 16>::bwd_smem());
  } else {
    f = resident_cluster_n<8>(gru_fwd_kernel<256, 8>,
                              Gru<256, 8>::fwd_smem());
    b = resident_cluster_n<8>(gru_bwd_kernel<256, 8>,
                              Gru<256, 8>::bwd_smem());
  }
  return f < b ? f : b;
}

// floats of backward scratch: dhh (B, T, 3H) and split-K partials
long long gru_backward_workspace_floats(int B, int T, int H) {
  return (long long)B * T * 3 * H + (long long)(PART_FLOATS + CPART_FLOATS);
}

// From the forward's ys and hh and the cotangents dys (B,T,H), dhn (B,H):
// dxw (B,T,3H), dw_hh_t (H,3H), db_hh (3H), dh0 (B,H). ys and h0 16-byte
// aligned (the weight reduction reads them 16 bytes at a time); ctas as
// the forward's.
int gru_backward_f32(const float* xw, const float* hh, const float* w_hh_t,
                     const float* h0, const float* ys, const float* dys,
                     const float* dhn, float* dxw, float* dwhh, float* dbhh,
                     float* dh0, float* ws, int B, int T, int H, int ctas,
                     void* stream_ptr) {
  if (!gru_shape_ok(H, ctas) || B <= 0 || T <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream_ptr;
  float* dhh = ws;
  float* part = dhh + (size_t)B * T * 3 * H;
  int err =
      H == 128 ? gru_backward<128, 8>(xw, hh, w_hh_t, h0, ys, dys, dhn, dxw,
                                      dhh, dh0, B, T, s)
      : ctas == 16
          ? gru_backward<256, 16>(xw, hh, w_hh_t, h0, ys, dys, dhn, dxw, dhh,
                                  dh0, B, T, s)
          : gru_backward<256, 8>(xw, hh, w_hh_t, h0, ys, dys, dhn, dxw, dhh,
                                 dh0, B, T, s);
  if (err) return err;
  const int rows = B * T;
  if ((err = reduce_rows_tn_tc(ys, h0, T, dhh, dwhh, part, rows, H, 3 * H,
                               s)))
    return err;
  return colsum(dhh, dbhh, part + PART_FLOATS, rows, 3 * H, s);
}

#ifdef GRU_STAMPS
// Copy the stamps to out ([2][STAMP_STEPS][STAMP_CTAS][STAMP_MARKS] u64,
// host memory) or, with out null, zero them; dims gets {STAMP_T0,
// STAMP_STEPS, STAMP_CTAS, STAMP_MARKS}.
int gru_stamps(unsigned long long* out, int* dims) {
  dims[0] = STAMP_T0;
  dims[1] = STAMP_STEPS;
  dims[2] = STAMP_CTAS;
  dims[3] = STAMP_MARKS;
  if (!out) {
    static unsigned long long zeros[sizeof(g_gru_stamps) / 8];
    return (int)cudaMemcpyToSymbol(g_gru_stamps, zeros, sizeof(zeros));
  }
  int err = (int)cudaDeviceSynchronize();
  if (err) return err;
  return (int)cudaMemcpyFromSymbol(out, g_gru_stamps, sizeof(g_gru_stamps));
}
#endif

}  // extern "C"
