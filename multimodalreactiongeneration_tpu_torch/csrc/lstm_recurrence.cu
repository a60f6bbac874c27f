// LSTM recurrence over precomputed input projections (K8), forward and
// backward.
//
// Replaces, in multimodalreactiongeneration_tpu/ops/pallas_lstm.py
// (lstm_recurrence):
//   lstm_recurrence_forward_f32, acts/cs null   _fwd_kernel  (the primal)
//   lstm_recurrence_forward_f32, acts/cs given  _fwd_kernel_savegates
//                                               (_vjp_fwd)
//   lstm_recurrence_backward_f32                _bwd_kernel and the dW_hh
//                                               einsum of _bwd_impl
//                                               (_vjp_bwd)
//
// Layouts as the JAX kernel's: xw (B, T, 4H) = x @ W_ih^T + b_ih + b_hh,
// w_hh_t (H, 4H) = W_hh^T, h0, c0 (B, H); gate order i, f, g, o. Unlike
// K7 (csrc/lstm_layer.cu) there is no input product: the caller computed
// xw, so any input size works, and the backward's dxw is the dgates
// trajectory itself.
//
// What bounds it: a chain of T steps, each a (16 x H) @ (H x 4H) product
// that needs the previous step's h. Its FLOPs (2 B T 4H H) take a
// fraction of a millisecond at the card's rates; the per-step latency
// (the product on the few SMs of one cluster, the cell, the exchange of h
// and the wait for it) times T is what counts. The design is K10's
// (gru.cu) carried over to the LSTM cell. A cluster of CLN CTAs holds
// W_hh: CTA r owns the 4U gate columns i, f, g, o of hidden units [r U,
// (r+1) U), U = H / CLN; 16 batch rows per cluster, rows past B run on
// zeros and are never stored, and T is not padded, so any B >= 1 and T >=
// 1 give exact h_n and c_n.
//
// Forward step, per CTA:
//  * the product h_{t-1} (16 x H) @ W slice (H x 4U) on the tensor cores,
//    mma.sync.m16n8k8 in 3xTF32 (tf32x3.cuh): the cluster's 16 rows are
//    one M tile. Warp (ug, ks) owns units [8 ug, 8 ug + 8) of the CTA,
//    i.e. the four n-tiles i, f, g, o of those units, over K range ks of
//    KS = 8 / (U / 8), so the accumulators of one thread hold all four
//    gates of its (row, unit) cells and the cell state c stays in its
//    registers for the whole sequence. W's fragments are split into TF32
//    hi and lo once, at kernel start, and kept in registers (hi always; lo
//    too when a warp holds at most REG_FRAGS fragments, else in shared
//    memory in fragment order), so each W element is read once per step
//    per CTA. The K index of a fragment is permuted inside each group of
//    16 so that a thread reads its four A values of two k-steps as one
//    float4 of h (rows padded to H + 16 floats: the float4 reads are free
//    of bank conflicts); h is split into hi and lo as it is read. Even and
//    odd k-steps sum into separate accumulators (eight independent chains
//    of MMAs a warp).
//  * the K split is reduced through shared memory in ks order, and the
//    KS warps of a unit group share the cell: warp ks computes the
//    fragment elements [ks 4/KS, (ks+1) 4/KS) of its lanes.
//  * the exchange (cluster_exchange.cuh): the CTA's 16 x U block of h is
//    staged in shared memory and written to every CTA's copy of the state
//    (double-buffered by step parity) with 16-byte st.async stores, each
//    of which completes 16 bytes of the receiver's transaction barrier (an
//    mbarrier per buffer, armed for the 16 x H x 4 bytes of a step). Then
//    ys (and under grad acts and cs, staged beside h by the cell) go to
//    device memory in 16-byte row chunks and the next step's xw is
//    loaded, then each CTA waits on its own barrier: one wait a step, for
//    the data it needs, and no cluster-wide barrier. A CTA sends
//    step t's h only after its last read of the buffer step t + 1
//    overwrites, so the data order keeps the two buffers free of races at
//    any B and T.
//
// Residuals: the JAX forward under grad saves the gate pre-activations;
// this one saves the activations acts = [i, f, g, o] and the cell states
// cs (the layout K7 saves), so the reverse chain needs no transcendental
// but tanh(c_t). It computes the same function with other residuals.
//
// The backward is the reverse chain from acts and cs. Per step, per
// (row, unit) (thread: one unit, U/16 rows):
//   dh = dy_t + (dh_n at the last step, else the partial carries of CTAs
//   0..CLN-1 in that order), then the cell's backward (lstm_cluster_bwd.cuh
//   cell_bwd) gives dgates = dxw, with dc carried in registers.
// dgates go through shared memory to the carry product dgates (16 x 4U) @
// W_slice^T (4U x H) in 3xTF32 mma.sync, warp w computing the n-tiles of
// units [8 w H/64, 8 (w+1) H/64) over all of K = 4U, from W^T fragments
// split once into hi and lo as in the forward. That product is a PARTIAL
// carry over all H units; each lane pairs with its neighbour (one
// shuffle) to hold four consecutive units of one row and writes them with
// one 16-byte st.async into slot r of the owning CTA (slots double-
// buffered by parity, a transaction barrier per parity, one wait a step;
// a __syncthreads after it, since a warp may send no slot to its own CTA
// and its peers must be done with dgates). The carries are
// summed in CTA order, so the result is the same from run to run.
// dW_hh^T = h_shift^T dgates over all B*T rows, h_shift the h_{t-1} of
// every step (h0 at step 0), reduces outside the chain in 3xTF32
// (tc_gemm.cuh reduce_rows_tn_tc, deterministic split-K; the JAX package
// takes it at HIGHEST precision, as the sum cancels heavily).
//
// Cluster size: ops/lstm_recurrence.py launch_ctas picks CLN per launch
// from the occupancy query lstm_recurrence_resident_clusters: the larger
// size while the batch's clusters fit on the card at once, else the
// smaller, whose clusters run in one wave where the larger's would run
// in two. At H 256, 16 CTAs (U 16; a non-portable size; an H100 holds 7
// such clusters, so up to B112), else 8; at H 128, 8 (15 clusters, up to
// B240), else 4 (U 32: B256, a simple_lstm direction, runs ~1.6x faster
// over 4 than in two waves over 8). The sweep is in PERF.md: W's lo
// fragments in shared memory past 24 fragments a warp, and four
// accumulator sets in the backward, measured no faster; summing each
// k-step from zero before adding it in FP32 ran 5-8% slower with the same
// error against the plain version.
//
// Numerics: the products in 3xTF32 (FP32's order of error, tf32x3.cuh);
// cell math, state and sums in FP32.

#include "cluster_exchange.cuh"
#include "tc_gemm.cuh"

namespace {

// Built with -DLSTM_STAMPS (a build only a measuring tool asks for),
// thread 0 of each of the first 16 CTAs stamps %globaltimer at the
// marks of a step (the start, the product, the cell, the exchange
// stores, the wait passed; the backward: the start, the cell, the
// product, the stores, the wait passed) for steps [STAMP_T0, STAMP_T0 +
// STAMP_STEPS) of the forward and of the backward (counted from the
// last step); lstm_recurrence_stamps() reads them back.
constexpr int STAMP_T0 = 64, STAMP_STEPS = 16, STAMP_CTAS = 16;
constexpr int STAMP_MARKS = 5;
#ifdef LSTM_STAMPS
__device__ unsigned long long
    g_lstm_stamps[2][STAMP_STEPS][STAMP_CTAS][STAMP_MARKS];
#endif

// mark `m` of step `step` of the forward (dir 0) or the backward (dir 1)
__device__ __forceinline__ void stamp(int dir, int step, int m) {
#ifdef LSTM_STAMPS
  const int s = step - STAMP_T0;
  if (threadIdx.x == 0 && blockIdx.x < STAMP_CTAS && s >= 0 &&
      s < STAMP_STEPS) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_lstm_stamps[dir][s][blockIdx.x][m] = t;
  }
#endif
}

// the hidden sizes and CTAs per cluster the kernels take: H 256 over 16
// or 8, H 128 over 8 or 4 (ops/lstm_recurrence.py launch_ctas picks);
// the entry points refuse any other size
inline bool lstm_shape_ok(int H, int ctas) {
  return (H == 256 && (ctas == 16 || ctas == 8)) ||
         (H == 128 && (ctas == 8 || ctas == 4));
}

// most W fragments a warp keeps wholly in registers (hi and lo: 4
// registers each); past it, lo lives in shared memory
constexpr int REG_FRAGS = 32;

// The shape of a step for hidden size H over a cluster of CLN CTAs.
template <int H, int CLN>
struct Lstm {
  static constexpr int U = H / CLN;   // units a CTA owns
  static constexpr int UG = U / 8;    // unit groups (n-tile quads)
  static constexpr int KS = 8 / UG;   // forward: warps splitting K
  static constexpr int EPW = 4 / KS;  // forward: cells a lane
  static constexpr int KF = H / KS;   // forward: K range of a warp
  static constexpr int KSF = KF / 8;  // forward: k-steps of a warp
  static constexpr bool LO_F = 4 * KSF > REG_FRAGS;  // lo in smem
  static constexpr int NPW = H / 64;  // backward: n-tiles a warp
  static constexpr int KSB = 4 * U / 8;  // backward: k-steps (K = 4U)
  static constexpr bool LO_B = NPW * KSB > REG_FRAGS;
  static constexpr int RPT = U / 16;  // backward: cell rows a thread
  static constexpr int HS = H + 16;   // row stride of the h state
  static constexpr int RS = 5 * U + 4;  // of the staged acts and c
  static constexpr int DS = 4 * U + (48 - (4 * U) % 32) % 32;  // of dgates
  static constexpr int SLOT = BT * U;  // a partial-carry slot
  static_assert(UG * KS == 8 && KS <= 4 && KF % 16 == 0 && KSB % 2 == 0,
                "step layout: 8 warps, k-steps in pairs");
  static_assert(HS % 32 == 16 && DS % 32 == 16, "float4 rows on 32 banks");

  // the forward's; with RES, the residuals' staging block too
  static constexpr size_t fwd_smem(bool res) {
    return 16 + sizeof(float) * (2 * (size_t)BT * HS + KS * UG * 4 * 32 * 4 +
                                 BT * U + (res ? BT * RS : 0)) +
           (LO_F ? sizeof(uint2) * 8 * 4 * KSF * 32 : 0);
  }
  static constexpr size_t bwd_smem() {
    return 16 + sizeof(float) * (2 * (size_t)CLN * SLOT + BT * DS) +
           (LO_B ? sizeof(uint2) * 8 * NPW * KSB * 32 : 0);
  }
};

// With RES (_fwd_kernel_savegates), acts (B, T, 4H) = [i, f, g, o] and
// cs (B, T, H) are the backward's residuals; without (the primal), they
// are not touched
template <int H, int CLN, bool RES>
__global__ void __launch_bounds__(NT, 1) lstm_tc_fwd_kernel(
    const float* __restrict__ xw,      // (B, T, 4H)
    const float* __restrict__ w_hh_t,  // (H, 4H)
    const float* __restrict__ h0,      // (B, H)
    const float* __restrict__ c0,      // (B, H)
    float* __restrict__ ys,            // (B, T, H)
    float* __restrict__ hn,            // (B, H)
    float* __restrict__ cn,            // (B, H)
    float* __restrict__ acts,          // (B, T, 4H) with RES
    float* __restrict__ cs,            // (B, T, H) with RES
    int B, int T) {
  using C = Lstm<H, CLN>;
  constexpr int U = C::U, UG = C::UG, KS = C::KS, EPW = C::EPW;
  constexpr int KSF = C::KSF, HS = C::HS, RS = C::RS;
  constexpr bool LO = C::LO_F;
  constexpr int CH = BT * U / 4;  // float4 chunks of the CTA's h block
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b0 = (blockIdx.x / CLN) * BT;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const int ug = warp % UG, ks = warp / UG;
  const int kb = ks * C::KF + 4 * q;  // this lane's first k
  const size_t G = 4 * (size_t)H;

  extern __shared__ __align__(16) float smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // [2] per buffer
  float* hbuf = smem + 4;  // [2][BT][HS] the state, double-buffered
  float* red = hbuf + 2 * BT * HS;  // [KS][UG][4 gates][32 lanes][4]
  float* hs = red + KS * UG * 4 * 32 * 4;  // [BT][U] this step's h block
  float* rs = hs + BT * U;  // [BT][RS] its acts i, f, g, o and c (RES)
  uint2* wlo =  // [8][4][KSF][32]
      reinterpret_cast<uint2*>(rs + (RES ? BT * RS : 0));

  // B fragments: k-step s reads k = kb + 16 (s / 2) + 2 (s % 2) (b0) and
  // the k after it (b1), column gate * H + rank U + 8 ug + g
  uint32_t whi[4][KSF][2], wl[4][LO ? 1 : KSF][2];
#pragma unroll
  for (int gt = 0; gt < 4; ++gt)
#pragma unroll
    for (int s = 0; s < KSF; ++s) {
      const int k = kb + 16 * (s / 2) + 2 * (s % 2);
      const float* w = w_hh_t + (size_t)k * G + gt * H + rank * U + 8 * ug + g;
      uint32_t lo[2];
      split_tf32(w[0], whi[gt][s][0], lo[0]);
      split_tf32(w[G], whi[gt][s][1], lo[1]);
      if constexpr (LO)
        wlo[((warp * 4 + gt) * KSF + s) * 32 + lane] = make_uint2(lo[0], lo[1]);
      else
        wl[gt][LO ? 0 : s][0] = lo[0], wl[gt][LO ? 0 : s][1] = lo[1];
    }
  for (int i = tid; i < BT * H; i += NT) {
    const int r = i / H, k = i % H;
    hbuf[r * HS + k] = b0 + r < B ? h0[(size_t)(b0 + r) * H + k] : 0.f;
  }
  // this lane's cells: fragment elements e = ks EPW + i, at row g + 8 (e /
  // 2), unit 8 ug + 2 q + e % 2; their cell states c and this step's xw
  // (loaded a step ahead)
  int row[EPW], col[EPW];
  bool ok[EPW];
  float c[EPW], x[EPW][4];
#pragma unroll
  for (int i = 0; i < EPW; ++i) {
    const int e = ks * EPW + i;
    row[i] = g + 8 * (e / 2);
    col[i] = rank * U + 8 * ug + 2 * q + e % 2;
    ok[i] = b0 + row[i] < B;
    c[i] = ok[i] ? c0[(size_t)(b0 + row[i]) * H + col[i]] : 0.f;
#pragma unroll
    for (int gt = 0; gt < 4; ++gt)
      x[i][gt] = ok[i] ? xw[(size_t)(b0 + row[i]) * T * G + gt * H + col[i]]
                       : 0.f;
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
    float acc[2][4][4];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int gt = 0; gt < 4; ++gt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[p][gt][e] = 0.f;
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
        for (int gt = 0; gt < 4; ++gt) {
          uint32_t bl[2];
          if constexpr (LO) {
            const uint2 v = wlo[((warp * 4 + gt) * KSF + s) * 32 + lane];
            bl[0] = v.x, bl[1] = v.y;
          } else {
            bl[0] = wl[gt][LO ? 0 : s][0], bl[1] = wl[gt][LO ? 0 : s][1];
          }
          mma_3xtf32(acc[o][gt], ah, al, whi[gt][s], bl);
        }
      }
    }
#pragma unroll
    for (int gt = 0; gt < 4; ++gt)
      reinterpret_cast<float4*>(red)[((ks * UG + ug) * 4 + gt) * 32 + lane] =
          make_float4(acc[0][gt][0] + acc[1][gt][0],
                      acc[0][gt][1] + acc[1][gt][1],
                      acc[0][gt][2] + acc[1][gt][2],
                      acc[0][gt][3] + acc[1][gt][3]);
    __syncthreads();
    stamp(0, t, 1);

    float a[EPW][4];  // the gate activations i, f, g, o
#pragma unroll
    for (int i = 0; i < EPW; ++i) {
      const int e = ks * EPW + i;
      float pre[4];
#pragma unroll
      for (int gt = 0; gt < 4; ++gt) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < KS; ++k)
          s += red[(((k * UG + ug) * 4 + gt) * 32 + lane) * 4 + e];
        pre[gt] = s + x[i][gt];
      }
      a[i][0] = sigmoidf_(pre[0]);
      a[i][1] = sigmoidf_(pre[1]);
      a[i][2] = tanhf(pre[2]);
      a[i][3] = sigmoidf_(pre[3]);
      c[i] = a[i][1] * c[i] + a[i][0] * a[i][2];
      const int u = col[i] - rank * U;
      hs[row[i] * U + u] = a[i][3] * tanhf(c[i]);
      if constexpr (RES) {
#pragma unroll
        for (int gt = 0; gt < 4; ++gt) rs[row[i] * RS + gt * U + u] = a[i][gt];
        rs[row[i] * RS + 4 * U + u] = c[i];
      }
    }
    __syncthreads();
    stamp(0, t, 2);

    float* nxt = hbuf + ((t + 1) & 1) * BT * HS;
    for (int i = tid; i < CH * CLN; i += NT) {
      const int peer = i / CH, ch = i % CH;
      const int r = ch / (U / 4), u = 4 * (ch % (U / 4));
      const float4 v = *reinterpret_cast<const float4*>(hs + r * U + u);
      st_async16(nxt + r * HS + rank * U + u, &full[(t + 1) & 1], peer, v);
    }
    stamp(0, t, 3);
    for (int ch = tid; ch < CH; ch += NT) {
      const int r = ch / (U / 4), u = 4 * (ch % (U / 4));
      if (b0 + r < B)
        *reinterpret_cast<float4*>(ys + ((size_t)(b0 + r) * T + t) * H +
                                   rank * U + u) =
            *reinterpret_cast<const float4*>(hs + r * U + u);
    }
    // the residuals from the staged block, 16 bytes a store: the U / 4
    // chunks of each gate, then of c
    for (int ch = tid; RES && ch < BT * 5 * U / 4; ch += NT) {
      const int r = ch / (5 * U / 4), k = 4 * (ch % (5 * U / 4));
      if (b0 + r >= B) continue;
      const size_t rt = (size_t)(b0 + r) * T + t;
      const float4 v = *reinterpret_cast<const float4*>(rs + r * RS + k);
      float* dst = k < 4 * U ? acts + rt * G + (k / U) * H + rank * U + k % U
                             : cs + rt * H + rank * U + k - 4 * U;
      *reinterpret_cast<float4*>(dst) = v;
    }
    if (t + 1 < T) {
#pragma unroll
      for (int i = 0; i < EPW; ++i) {
        if (!ok[i]) continue;
        const size_t at = ((size_t)(b0 + row[i]) * T + t + 1) * G + col[i];
#pragma unroll
        for (int gt = 0; gt < 4; ++gt) x[i][gt] = xw[at + gt * H];
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
#pragma unroll
  for (int i = 0; i < EPW; ++i) {
    if (!ok[i]) continue;
    const size_t o = (size_t)(b0 + row[i]) * H + col[i];
    hn[o] = hlast[row[i] * HS + col[i]];
    cn[o] = c[i];
  }
}

// dxw (B, T, 4H) is the dgates trajectory, for the dW_hh reduction after
template <int H, int CLN>
__global__ void __launch_bounds__(NT, 1) lstm_tc_bwd_kernel(
    const float* __restrict__ acts,    // (B, T, 4H) i, f, g, o
    const float* __restrict__ cs,      // (B, T, H) cell states
    const float* __restrict__ c0,      // (B, H)
    const float* __restrict__ dys,     // (B, T, H)
    const float* __restrict__ w_hh_t,  // (H, 4H)
    const float* __restrict__ dhn,     // (B, H)
    const float* __restrict__ dcn,     // (B, H)
    float* __restrict__ dxw,           // (B, T, 4H)
    float* __restrict__ dh0,           // (B, H)
    float* __restrict__ dc0,           // (B, H)
    int B, int T) {
  using C = Lstm<H, CLN>;
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
  const size_t G = 4 * (size_t)H;

  extern __shared__ __align__(16) float smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // [2] per parity
  float* red = smem + 4;             // [2][CLN][BT][U] partial carry slots
  float* dg = red + 2 * CLN * SLOT;  // [BT][DS] this step's dgates slice
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
      for (int e = 0; e < 2; ++e)
        split_tf32(w[((lc + e) / U) * H + rank * U + (lc + e) % U],
                   whi[jj][s][e], lo[e]);
      if constexpr (LO)
        wlo[((warp * NPW + jj) * KSB + s) * 32 + lane] =
            make_uint2(lo[0], lo[1]);
      else
        wl[jj][LO ? 0 : s][0] = lo[0], wl[jj][LO ? 0 : s][1] = lo[1];
    }
  // per owned (row, unit): the cell-state carry dc and the step's inputs
  // (dy, the activations, c_t, c_{t-1}), loaded a step ahead
  float dcreg[RPT];
  StepIn in[RPT];
  bool ok[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int b = b0 + r0 + i;
    ok[i] = b < B;
    dcreg[i] = ok[i] ? dcn[(size_t)b * H + col] : 0.f;
    load_step_in(in[i], ok[i], dys, acts, cs, c0, b, T - 1, T, 0, T, H, col);
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
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      if (ok[i]) {
        const size_t b = b0 + r;
        float dh = in[i].dy;
        if (t == T - 1) {
          dh += dhn[b * H + col];
        } else {
#pragma unroll
          for (int s = 0; s < CLN; ++s) dh += rd[s * SLOT + r * U + u];
        }
        cell_bwd(in[i], dh, dcreg[i], d);
        float* o = dxw + (b * T + t) * G + col;
        o[0] = d[0];
        o[H] = d[1];
        o[2 * H] = d[2];
        o[3 * H] = d[3];
      }
#pragma unroll
      for (int gt = 0; gt < 4; ++gt) dg[r * DS + gt * U + u] = d[gt];
    }
    __syncthreads();
    stamp(1, T - 1 - t, 1);

    float acc[2][NPW][4];
#pragma unroll
    for (int o = 0; o < 2; ++o)
#pragma unroll
      for (int jj = 0; jj < NPW; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[o][jj][e] = 0.f;
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
      float cv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) cv[e] = acc[0][jj][e] + acc[1][jj][e];
      const float s0 = __shfl_xor_sync(0xffffffffu, odd ? cv[0] : cv[2], 1);
      const float s1 = __shfl_xor_sync(0xffffffffu, odd ? cv[1] : cv[3], 1);
      const float4 v = odd ? make_float4(s0, s1, cv[2], cv[3])
                           : make_float4(cv[0], cv[1], s0, s1);
      const int n = 8 * (warp * NPW + jj);  // the n-tile's first unit
      const int r = odd ? g + 8 : g, un = n % U + 2 * (odd ? q - 1 : q);
      st_async16(red + ((t & 1) * CLN + rank) * SLOT + r * U + un,
                 &full[t & 1], n / U, v);
    }
    stamp(1, T - 1 - t, 3);
    if (t > 0) {
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        load_step_in(in[i], ok[i], dys, acts, cs, c0, b0 + r0 + i, t - 1, T,
                     0, T, H, col);
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
    const size_t o = (size_t)(b0 + r) * H + col;
    float dh = 0.f;
#pragma unroll
    for (int s = 0; s < CLN; ++s) dh += red[s * SLOT + r * U + u];
    dh0[o] = dh;
    dc0[o] = dcreg[i];
  }
}

template <int H, int CLN>
int lstm_forward(const float* xw, const float* w_hh_t, const float* h0,
                 const float* c0, float* ys, float* hn, float* cn,
                 float* acts, float* cs, int B, int T, cudaStream_t stream) {
  if (acts)
    return launch_cluster_n<CLN>(lstm_tc_fwd_kernel<H, CLN, true>,
                                 Lstm<H, CLN>::fwd_smem(true), B, stream, xw,
                                 w_hh_t, h0, c0, ys, hn, cn, acts, cs, B, T);
  return launch_cluster_n<CLN>(lstm_tc_fwd_kernel<H, CLN, false>,
                               Lstm<H, CLN>::fwd_smem(false), B, stream, xw,
                               w_hh_t, h0, c0, ys, hn, cn, acts, cs, B, T);
}

template <int H, int CLN>
int lstm_backward(const float* acts, const float* cs, const float* c0,
                  const float* dys, const float* w_hh_t, const float* dhn,
                  const float* dcn, float* dxw, float* dh0, float* dc0,
                  int B, int T, cudaStream_t stream) {
  return launch_cluster_n<CLN>(lstm_tc_bwd_kernel<H, CLN>,
                               Lstm<H, CLN>::bwd_smem(), B, stream, acts, cs,
                               c0, dys, w_hh_t, dhn, dcn, dxw, dh0, dc0, B,
                               T);
}

// the smaller of the training forward's and the backward's resident
// clusters (the primal takes less shared memory, the same registers)
template <int H, int CLN>
int lstm_resident() {
  const int f = resident_cluster_n<CLN>(lstm_tc_fwd_kernel<H, CLN, true>,
                                        Lstm<H, CLN>::fwd_smem(true));
  const int b = resident_cluster_n<CLN>(lstm_tc_bwd_kernel<H, CLN>,
                                        Lstm<H, CLN>::bwd_smem());
  return f < b ? f : b;
}

}  // namespace

extern "C" {

// xw (B,T,4H); w_hh_t (H,4H); h0, c0 (B,H). Writes ys (B,T,H), hn, cn
// (B,H) and, when acts/cs are not null, the training residuals acts
// (B,T,4H) = [i, f, g, o] and cs (B,T,H). ys, acts and cs 16-byte
// aligned (written 16 bytes at a time); ctas: CTAs per cluster
// (lstm_shape_ok).
int lstm_recurrence_forward_f32(const float* xw, const float* w_hh_t,
                                const float* h0, const float* c0, float* ys,
                                float* hn, float* cn, float* acts, float* cs,
                                int B, int T, int H, int ctas,
                                void* stream_ptr) {
  if (!lstm_shape_ok(H, ctas) || B <= 0 || T <= 0 ||
      !aligned16(ys, acts, cs))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream_ptr;
  if (H == 128)
    return ctas == 8 ? lstm_forward<128, 8>(xw, w_hh_t, h0, c0, ys, hn, cn,
                                            acts, cs, B, T, s)
                     : lstm_forward<128, 4>(xw, w_hh_t, h0, c0, ys, hn, cn,
                                            acts, cs, B, T, s);
  return ctas == 16 ? lstm_forward<256, 16>(xw, w_hh_t, h0, c0, ys, hn, cn,
                                            acts, cs, B, T, s)
                    : lstm_forward<256, 8>(xw, w_hh_t, h0, c0, ys, hn, cn,
                                           acts, cs, B, T, s);
}

// Clusters of 16 batch rows the card runs at once for hidden size H over
// clusters of `ctas` CTAs, the fewer of the forward's and the backward's;
// more run in waves. -1 on an error.
int lstm_recurrence_resident_clusters(int H, int ctas) {
  if (!lstm_shape_ok(H, ctas)) return -1;
  if (H == 128)
    return ctas == 8 ? lstm_resident<128, 8>() : lstm_resident<128, 4>();
  return ctas == 16 ? lstm_resident<256, 16>() : lstm_resident<256, 8>();
}

// floats of backward scratch: the split-K partials of dW_hh
long long lstm_recurrence_backward_workspace_floats(int B, int T, int H) {
  return (long long)PART_FLOATS;
}

// From the forward's ys, acts, cs and the cotangents dys (B,T,H), dhn,
// dcn (B,H): dxw (B,T,4H) = the dgates trajectory, dw_hh_t (H,4H), dh0,
// dc0 (B,H). ys, h0 and dxw 16-byte aligned (the weight reduction reads
// them 16 bytes at a time); ctas as the forward's.
int lstm_recurrence_backward_f32(const float* w_hh_t, const float* h0,
                                 const float* c0, const float* ys,
                                 const float* acts, const float* cs,
                                 const float* dys, const float* dhn,
                                 const float* dcn, float* dxw, float* dwhh,
                                 float* dh0, float* dc0, float* ws, int B,
                                 int T, int H, int ctas, void* stream_ptr) {
  if (!lstm_shape_ok(H, ctas) || B <= 0 || T <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream_ptr;
  int err =
      H == 128
          ? (ctas == 8 ? lstm_backward<128, 8>(acts, cs, c0, dys, w_hh_t, dhn,
                                               dcn, dxw, dh0, dc0, B, T, s)
                       : lstm_backward<128, 4>(acts, cs, c0, dys, w_hh_t, dhn,
                                               dcn, dxw, dh0, dc0, B, T, s))
      : ctas == 16
          ? lstm_backward<256, 16>(acts, cs, c0, dys, w_hh_t, dhn, dcn, dxw,
                                   dh0, dc0, B, T, s)
          : lstm_backward<256, 8>(acts, cs, c0, dys, w_hh_t, dhn, dcn, dxw,
                                  dh0, dc0, B, T, s);
  if (err) return err;
  return reduce_rows_tn_tc(ys, h0, T, dxw, dwhh, ws, B * T, H, 4 * H, s);
}

#ifdef LSTM_STAMPS
// Copy the stamps to out ([2][STAMP_STEPS][STAMP_CTAS][STAMP_MARKS] u64,
// host memory) or, with out null, zero them; dims gets {STAMP_T0,
// STAMP_STEPS, STAMP_CTAS, STAMP_MARKS}.
int lstm_recurrence_stamps(unsigned long long* out, int* dims) {
  dims[0] = STAMP_T0;
  dims[1] = STAMP_STEPS;
  dims[2] = STAMP_CTAS;
  dims[3] = STAMP_MARKS;
  if (!out) {
    static unsigned long long zeros[sizeof(g_lstm_stamps) / 8];
    return (int)cudaMemcpyToSymbol(g_lstm_stamps, zeros, sizeof(zeros));
  }
  int err = (int)cudaDeviceSynchronize();
  if (err) return err;
  return (int)cudaMemcpyFromSymbol(out, g_lstm_stamps, sizeof(g_lstm_stamps));
}
#endif

}  // extern "C"
