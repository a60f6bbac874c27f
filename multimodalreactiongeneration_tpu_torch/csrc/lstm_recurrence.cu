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
// and the same in JAX's bf16 operand mode (w_hh_t bf16):
//   lstm_recurrence_forward_bf16, lstm_recurrence_backward_bf16
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
// over 4 than in two waves over 8). H 192 takes 12 or 6 CTAs and H 64 4
// or 2, the same 16 or 32 units a CTA; a cluster of 12 or 6 is no power
// of two, and nothing here needs one (every index is rank * U or n / U).
// ops/lstm_recurrence.py runs any other H up to 256 on the next of these
// four sizes, zero-padded (ops/hidden_pad.py). The sweep is in PERF.md: W's lo
// fragments in shared memory past 24 fragments a warp, and four
// accumulator sets in the backward, measured no faster; summing each
// k-step from zero before adding it in FP32 ran 5-8% slower with the same
// error against the plain version.
//
// Numerics: the products in 3xTF32 (FP32's order of error, tf32x3.cuh);
// cell math, state and sums in FP32.
//
// The bf16 operand mode (TW = bf16; JAX's kernel with bf16 w_hh_t,
// pallas_lstm.py _fwd_kernel and _bwd_kernel: h.astype(bf16) @ W_hh and
// dgates.astype(bf16) @ W_hh^T with f32 accumulation) is gru.cu's: each
// k16 step of a product one mma.sync.m16n8k16 (bf16 in, FP32 accumulate),
// h and the dgates rounded to bf16 (to nearest, ties to even) as the A
// fragments are built from the same float4 reads, W's fragments stored
// bf16 in registers. State, cell math, the residuals and dxw stay FP32.
// dW_hh^T = bf16(h_shift)^T bf16(dgates) sums in FP32 on
// bf16_reduce_kernel (FP32 tiles rounded at the fragments,
// bf16_gemm.cuh reduce_rows_tn_bf16_tc) and is rounded to bf16 once: the
// einsum of _bwd_impl (pallas_lstm.py:331), which the JAX package runs
// outside its kernel and the port inside its own reduction. The cluster
// size comes from the bf16 instantiation's own occupancy
// (lstm_recurrence_resident_clusters_bf16).
//
// K9's layer route (lstm_stacked_layers_forward_* / _backward_*): the
// stacks that lstm_stacked.cu's one-cluster wavefront cannot hold (its
// recurrent weights take (2L - 1) x 4 H^2 floats in one 8-CTA cluster's
// shared memory: H 256 at any L >= 2 is 3 MB at L 2, and H 128 past L 3)
// run here as a layer-lagged window schedule of this file's chains.
// Replaces, in multimodalreactiongeneration_tpu/ops/pallas_lstm_stacked.py
// (lstm_stacked_recurrence) at those shapes:
//   lstm_stacked_layers_forward_*, hs/acts/cs given  _fwd_kernel_acts
//   lstm_stacked_layers_forward_*, hs/acts/cs null   _fwd_kernel
//   lstm_stacked_layers_backward_*                   _bwd_kernel_fused
//                                                    (and _bwd_kernel)
// The sequence is cut into windows of C steps (ops/lstm_stacked.py
// layers_chunk). Each layer has a stream of its own, and layer l runs
// window c after layer l - 1 has finished it (an event), so while layer
// l runs window c, layer l - 1 runs window c + 1: the chain is T + (L-1)
// C dependent steps, not L T. A window of layer l is its input product
// xw_l = h_{l-1} W_ih_l + b_l over the window's rows (l >= 1; the
// hand-written tensor-core GEMMs: tc_gemm.cuh gemm_tc_rows in 3xTF32, so
// f32 stays FP32-exact; in the bf16 mode bf16_gemm.cuh gemm_rows_bf16, h
// rounded to bf16 as it is staged, FP32 sums), then the chain over the
// window's steps (the kernels above over [t0, t0 + n) of the (B, T, *)
// arrays), carrying h and c from the window before through two slots a
// layer. Under grad the forward keeps the wavefront's residual layout
// (hs (L-1, B, T, H), acts (L, B, T, 4H), cs (L, B, T, H)). The backward
// is the reverse schedule (mixer_stack.cu's for K4): the last window
// first, layer l's window c after layer l + 1's; per window the reverse
// chain from the layer's dy (dys at the top), giving its dgates and the
// carries into the window before, then the next layer's dy = dgates_l
// W_ih_l^T over the window's rows (gemm_tc_rows, gemm_rows_bf16); after
// a layer's first window its dW_hh (the reduction above), dW_ih_l =
// h_{l-1}^T dgates_l (3xTF32, or bf16 operands with FP32 sums rounded
// once) and db_l = colsum(dgates_l) over all its rows on its stream,
// while the layers below run on. Each window's steps are the whole
// sequence's steps and every sum runs in a fixed order, so every C gives
// the bits of C = T (the layers one after the other), run to run.

#include <mutex>
#include <vector>

#include "bf16_gemm.cuh"
#include "cluster_exchange.cuh"

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

// the hidden sizes and CTAs per cluster the kernels take: U = H / ctas
// units a CTA, 16 or 32 (H 256 over 16 or 8, H 192 over 12 or 6, H 128
// over 8 or 4, H 64 over 4 or 2; ops/lstm_recurrence.py launch_ctas
// picks, and pads any other H up to 256 to the next of them); the entry
// points refuse any other size. A cluster of 12 or 6 CTAs is no power
// of two: every rank and slot index below is rank * U or n / U, never a
// shift or a mask
#define LSTM_SHAPES(X) \
  X(256, 16) X(256, 8) X(192, 12) X(192, 6) X(128, 8) X(128, 4) X(64, 4) \
  X(64, 2)
inline bool lstm_shape_ok(int H, int ctas) {
#define LSTM_OK(h, c) if (H == h && ctas == c) return true;
  LSTM_SHAPES(LSTM_OK)
#undef LSTM_OK
  return false;
}

// most W fragments a warp keeps wholly in registers (hi and lo: 4
// registers each); past it, lo lives in shared memory
constexpr int REG_FRAGS = 32;

// The shape of a step for hidden size H over a cluster of CLN CTAs, in
// the FP32 or (BF) the bf16 operand mode.
template <int H, int CLN, bool BF>
struct Lstm {
  static constexpr int U = H / CLN;   // units a CTA owns
  static constexpr int UG = U / 8;    // unit groups (n-tile quads)
  static constexpr int KS = 8 / UG;   // forward: warps splitting K
  static constexpr int EPW = 4 / KS;  // forward: cells a lane
  static constexpr int KF = H / KS;   // forward: K range of a warp
  static constexpr int KSF = KF / 8;  // forward: k-steps of a warp
  static constexpr bool LO_F = !BF && 4 * KSF > REG_FRAGS;  // lo in smem
  static constexpr int NF = BF ? KSF / 2 : KSF;  // forward: W fragments a gate
  static constexpr int NPW = H / 64;  // backward: n-tiles a warp
  static constexpr int KSB = 4 * U / 8;  // backward: k-steps (K = 4U)
  static constexpr bool LO_B = !BF && NPW * KSB > REG_FRAGS;
  static constexpr int NB = BF ? KSB / 2 : KSB;  // backward: W fragments
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
template <int H, int CLN, bool RES, typename TW>
__global__ void __launch_bounds__(NT, 1) lstm_tc_fwd_kernel(
    const float* __restrict__ xw,      // (B, T, 4H)
    const TW* __restrict__ w_hh_t,     // (H, 4H)
    const float* __restrict__ h0,      // (B, H)
    const float* __restrict__ c0,      // (B, H)
    float* __restrict__ ys,            // (B, T, H)
    float* __restrict__ hn,            // (B, H)
    float* __restrict__ cn,            // (B, H)
    float* __restrict__ acts,          // (B, T, 4H) with RES
    float* __restrict__ cs,            // (B, T, H) with RES
    int B, int T, int t0, int n) {
  constexpr bool BF = std::is_same_v<TW, bf16>;
  using C = Lstm<H, CLN, BF>;
  constexpr int U = C::U, UG = C::UG, KS = C::KS, EPW = C::EPW;
  constexpr int KSF = C::KSF, HS = C::HS, RS = C::RS, NF = C::NF;
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
  // the k after it (b1), column gate * H + rank U + 8 ug + g; in the bf16
  // mode k16-step s reads k = kb + 16 s and the k after it (b0), then k +
  // 2 and k + 3 (b1)
  uint32_t whi[4][NF][2], wl[4][LO || BF ? 1 : KSF][2];
#pragma unroll
  for (int gt = 0; gt < 4; ++gt)
#pragma unroll
    for (int s = 0; s < NF; ++s) {
      if constexpr (BF) {
        const TW* w = w_hh_t + (size_t)(kb + 16 * s) * G + gt * H +
                      rank * U + 8 * ug + g;
        whi[gt][s][0] = pack_bf16_raw(w[0], w[G]);
        whi[gt][s][1] = pack_bf16_raw(w[2 * G], w[3 * G]);
      } else {
        const int k = kb + 16 * (s / 2) + 2 * (s % 2);
        const TW* w =
            w_hh_t + (size_t)k * G + gt * H + rank * U + 8 * ug + g;
        uint32_t lo[2];
        split_tf32(w[0], whi[gt][s][0], lo[0]);
        split_tf32(w[G], whi[gt][s][1], lo[1]);
        if constexpr (LO)
          wlo[((warp * 4 + gt) * KSF + s) * 32 + lane] =
              make_uint2(lo[0], lo[1]);
        else
          wl[gt][LO ? 0 : s][0] = lo[0], wl[gt][LO ? 0 : s][1] = lo[1];
      }
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
      x[i][gt] = ok[i] ? xw[((size_t)(b0 + row[i]) * T + t0) * G + gt * H +
                            col[i]]
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

  for (int t = 0; t < n; ++t) {  // step t0 + t of the sequence
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
      if constexpr (BF) {  // one k16 step, even and odd p apart
        const uint32_t a[4] = {pack_bf16(va.x, va.y), pack_bf16(vb.x, vb.y),
                               pack_bf16(va.z, va.w), pack_bf16(vb.z, vb.w)};
#pragma unroll
        for (int gt = 0; gt < 4; ++gt) mma_bf16(acc[p & 1][gt], a, whi[gt][p]);
      } else {
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
        *reinterpret_cast<float4*>(ys + ((size_t)(b0 + r) * T + t0 + t) * H +
                                   rank * U + u) =
            *reinterpret_cast<const float4*>(hs + r * U + u);
    }
    // the residuals from the staged block, 16 bytes a store: the U / 4
    // chunks of each gate, then of c
    for (int ch = tid; RES && ch < BT * 5 * U / 4; ch += NT) {
      const int r = ch / (5 * U / 4), k = 4 * (ch % (5 * U / 4));
      if (b0 + r >= B) continue;
      const size_t rt = (size_t)(b0 + r) * T + t0 + t;
      const float4 v = *reinterpret_cast<const float4*>(rs + r * RS + k);
      float* dst = k < 4 * U ? acts + rt * G + (k / U) * H + rank * U + k % U
                             : cs + rt * H + rank * U + k - 4 * U;
      *reinterpret_cast<float4*>(dst) = v;
    }
    if (t + 1 < n) {
#pragma unroll
      for (int i = 0; i < EPW; ++i) {
        if (!ok[i]) continue;
        const size_t at =
            ((size_t)(b0 + row[i]) * T + t0 + t + 1) * G + col[i];
#pragma unroll
        for (int gt = 0; gt < 4; ++gt) x[i][gt] = xw[at + gt * H];
      }
    }
    {  // this step's state from every CTA; re-armed for step t + 2's
      const int b = (t + 1) & 1;
      mbar_wait(&full[b], (ph >> b) & 1);
      ph ^= 1u << b;
      if (tid == 0 && t + 2 < n) mbar_expect(&full[b], BYTES);
    }
    stamp(0, t, 4);
  }

  const float* hlast = hbuf + (n & 1) * BT * HS;
#pragma unroll
  for (int i = 0; i < EPW; ++i) {
    if (!ok[i]) continue;
    const size_t o = (size_t)(b0 + row[i]) * H + col[i];
    hn[o] = hlast[row[i] * HS + col[i]];
    cn[o] = c[i];
  }
}

// dxw (B, T, 4H) is the dgates trajectory, for the dW_hh reduction after
template <int H, int CLN, typename TW>
__global__ void __launch_bounds__(NT, 1) lstm_tc_bwd_kernel(
    const float* __restrict__ acts,    // (B, T, 4H) i, f, g, o
    const float* __restrict__ cs,      // (B, T, H) cell states
    const float* __restrict__ c0,      // (B, H)
    const float* __restrict__ dys,     // (B, T, H)
    const TW* __restrict__ w_hh_t,     // (H, 4H)
    const float* __restrict__ dhn,     // (B, H)
    const float* __restrict__ dcn,     // (B, H)
    float* __restrict__ dxw,           // (B, T, 4H)
    float* __restrict__ dh0,           // (B, H)
    float* __restrict__ dc0,           // (B, H)
    int B, int T, int t0, int n,
    const float* __restrict__ dhn_parts,  // (CLN, B, H) or null
    float* __restrict__ dh0_parts) {      // (CLN, B, H) or null
  constexpr bool BF = std::is_same_v<TW, bf16>;
  using C = Lstm<H, CLN, BF>;
  constexpr int U = C::U, RPT = C::RPT, NPW = C::NPW, KSB = C::KSB;
  constexpr int DS = C::DS, SLOT = C::SLOT, NB = C::NB;
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
  // (lc / U) H + rank U + lc % U. In the bf16 mode k16-step s reads lc =
  // 16 s + 4 q and the one after it (b0), then lc + 2 and lc + 3 (b1)
  uint32_t whi[NPW][NB][2], wl[NPW][LO || BF ? 1 : KSB][2];
#pragma unroll
  for (int jj = 0; jj < NPW; ++jj)
#pragma unroll
    for (int s = 0; s < NB; ++s) {
      const TW* w = w_hh_t + (size_t)(8 * (warp * NPW + jj) + g) * G;
      if constexpr (BF) {
        const int lc = 16 * s + 4 * q;  // four columns of one gate
        const TW* wc = w + (lc / U) * H + rank * U + lc % U;
        whi[jj][s][0] = pack_bf16_raw(wc[0], wc[1]);
        whi[jj][s][1] = pack_bf16_raw(wc[2], wc[3]);
      } else {
        const int lc = 16 * (s / 2) + 4 * q + 2 * (s % 2);
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
    }
  // per owned (row, unit): the cell-state carry dc and the step's inputs
  // (dy, the activations, c_t, c_{t-1}), loaded a step ahead; the steps
  // run from tl, the window's last, down to t0
  const int tl = t0 + n - 1;
  float dcreg[RPT];
  StepIn in[RPT];
  bool ok[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int b = b0 + r0 + i;
    ok[i] = b < B;
    dcreg[i] = ok[i] ? dcn[(size_t)b * H + col] : 0.f;
    load_step_in(in[i], ok[i], dys, acts, cs, c0, b, tl, T, 0, T, H, col);
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

  for (int t = tl; t >= t0; --t) {
    stamp(1, tl - t, 0);
    const float* rd = red + ((t + 1) & 1) * CLN * SLOT;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = r0 + i;
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      if (ok[i]) {
        const size_t b = b0 + r;
        float dh = in[i].dy;
        if (t == tl && dhn_parts) {  // a later window's partial carries
#pragma unroll
          for (int s = 0; s < CLN; ++s)
            dh += dhn_parts[(size_t)s * B * H + b * H + col];
        } else if (t == tl) {
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
    stamp(1, tl - t, 1);

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
      if constexpr (BF) {  // one k16 step, even and odd p apart
        const uint32_t a[4] = {pack_bf16(va.x, va.y), pack_bf16(vb.x, vb.y),
                               pack_bf16(va.z, va.w), pack_bf16(vb.z, vb.w)};
#pragma unroll
        for (int jj = 0; jj < NPW; ++jj)
          mma_bf16(acc[p & 1][jj], a, whi[jj][p]);
      } else {
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
    }
    stamp(1, tl - t, 2);

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
    stamp(1, tl - t, 3);
    if (t > t0) {
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        load_step_in(in[i], ok[i], dys, acts, cs, c0, b0 + r0 + i, t - 1, T,
                     0, T, H, col);
    }
    {  // this step's partial carries from every CTA; re-armed for t - 2's
      const int b = t & 1;
      mbar_wait(&full[b], (ph >> b) & 1);
      ph ^= 1u << b;
      if (tid == 0 && t >= t0 + 2) mbar_expect(&full[b], BYTES);
      __syncthreads();  // every warp is done with dg (it may send no slot here)
    }
    stamp(1, tl - t, 4);
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    if (!ok[i]) continue;
    const int r = r0 + i;
    const size_t o = (size_t)(b0 + r) * H + col;
    float dh = 0.f;  // step t0's partial carries, in its slot set
#pragma unroll
    for (int s = 0; s < CLN; ++s) {
      const float v = red[((t0 & 1) * CLN + s) * SLOT + r * U + u];
      if (dh0_parts) dh0_parts[(size_t)s * B * H + o] = v;
      dh += v;
    }
    if (dh0) dh0[o] = dh;
    dc0[o] = dcreg[i];
  }
}

// The chain over steps [t0, t0 + n) of (B, T, *) arrays: from the state
// h0, c0 before step t0 to hn, cn after its last (K9's layer route runs
// a sequence window by window; a whole sequence is t0 0, n T).
template <int H, int CLN, typename TW>
int lstm_forward(const float* xw, const TW* w_hh_t, const float* h0,
                 const float* c0, float* ys, float* hn, float* cn,
                 float* acts, float* cs, int B, int T, int t0, int n,
                 cudaStream_t stream) {
  using C = Lstm<H, CLN, std::is_same_v<TW, bf16>>;
  if (acts)
    return launch_cluster_n<CLN>(lstm_tc_fwd_kernel<H, CLN, true, TW>,
                                 C::fwd_smem(true), B, stream, xw, w_hh_t, h0,
                                 c0, ys, hn, cn, acts, cs, B, T, t0, n);
  return launch_cluster_n<CLN>(lstm_tc_fwd_kernel<H, CLN, false, TW>,
                               C::fwd_smem(false), B, stream, xw, w_hh_t, h0,
                               c0, ys, hn, cn, acts, cs, B, T, t0, n);
}

// The reverse chain over steps [t0, t0 + n): dhn, dcn the carries into
// its last step, dh0, dc0 those out of its first. A window of a longer
// sequence hands dh on as the CLN CTAs' partial carries (dh0_parts to the
// window before, dhn_parts from the window after, each (CLN, B, H), null
// at the sequence's ends): the window before adds them in CTA order to
// its last step's dy, as one chain adds them from its slots, so any
// window gives the whole chain's bits.
template <int H, int CLN, typename TW>
int lstm_backward(const float* acts, const float* cs, const float* c0,
                  const float* dys, const TW* w_hh_t, const float* dhn,
                  const float* dcn, float* dxw, float* dh0, float* dc0,
                  int B, int T, int t0, int n, const float* dhn_parts,
                  float* dh0_parts, cudaStream_t stream) {
  return launch_cluster_n<CLN>(
      lstm_tc_bwd_kernel<H, CLN, TW>,
      Lstm<H, CLN, std::is_same_v<TW, bf16>>::bwd_smem(), B, stream, acts,
      cs, c0, dys, w_hh_t, dhn, dcn, dxw, dh0, dc0, B, T, t0, n, dhn_parts,
      dh0_parts);
}

// the smaller of the training forward's and the backward's resident
// clusters (the primal takes less shared memory, the same registers)
template <int H, int CLN, typename TW>
int lstm_resident() {
  using C = Lstm<H, CLN, std::is_same_v<TW, bf16>>;
  const int f = resident_cluster_n<CLN>(lstm_tc_fwd_kernel<H, CLN, true, TW>,
                                        C::fwd_smem(true));
  const int b = resident_cluster_n<CLN>(lstm_tc_bwd_kernel<H, CLN, TW>,
                                        C::bwd_smem());
  return f < b ? f : b;
}

// the forward chain of a window at the hidden size and cluster size
// given (the shape checked by the caller)
template <typename TW>
int chain_forward(const float* xw, const TW* w_hh_t, const float* h0,
                  const float* c0, float* ys, float* hn, float* cn,
                  float* acts, float* cs, int B, int T, int t0, int n, int H,
                  int ctas, cudaStream_t s) {
#define LSTM_FWD(h, c)                                                      \
  if (H == h && ctas == c)                                                  \
    return lstm_forward<h, c>(xw, w_hh_t, h0, c0, ys, hn, cn, acts, cs, B, \
                              T, t0, n, s);
  LSTM_SHAPES(LSTM_FWD)
#undef LSTM_FWD
  return (int)cudaErrorInvalidValue;
}

// the reverse chain of a window, as chain_forward (the partial carries
// as lstm_backward's)
template <typename TW>
int chain_backward(const float* acts, const float* cs, const float* c0,
                   const float* dys, const TW* w_hh_t, const float* dhn,
                   const float* dcn, float* dxw, float* dh0, float* dc0,
                   int B, int T, int t0, int n, const float* dhn_parts,
                   float* dh0_parts, int H, int ctas, cudaStream_t s) {
#define LSTM_BWD(h, c)                                                     \
  if (H == h && ctas == c)                                                 \
    return lstm_backward<h, c>(acts, cs, c0, dys, w_hh_t, dhn, dcn, dxw,  \
                               dh0, dc0, B, T, t0, n, dhn_parts, dh0_parts, \
                               s);
  LSTM_SHAPES(LSTM_BWD)
#undef LSTM_BWD
  return (int)cudaErrorInvalidValue;
}

// the resident clusters of the mode of TW at a shape lstm_shape_ok takes
template <typename TW>
int resident_any(int H, int ctas) {
#define LSTM_RES(h, c) \
  if (H == h && ctas == c) return lstm_resident<h, c, TW>();
  LSTM_SHAPES(LSTM_RES)
#undef LSTM_RES
  return -1;
}

template <typename TW>
int forward_any(const float* xw, const TW* w_hh_t, const float* h0,
                const float* c0, float* ys, float* hn, float* cn, float* acts,
                float* cs, int B, int T, int H, int ctas, void* stream_ptr) {
  if (!lstm_shape_ok(H, ctas) || B <= 0 || T <= 0 ||
      !aligned16(ys, acts, cs))
    return (int)cudaErrorInvalidValue;
  return chain_forward(xw, w_hh_t, h0, c0, ys, hn, cn, acts, cs, B, T, 0, T,
                       H, ctas, (cudaStream_t)stream_ptr);
}

// dW_hh^T over all B*T rows: 3xTF32 (FP32 mode), or bf16 operands with
// FP32 sums rounded to bf16 once (bf16 mode)
int reduce_dw(const float* ys, const float* h0, int T, const float* dxw,
              float* dwhh, float* ws, int rows, int H, cudaStream_t s) {
  return reduce_rows_tn_tc(ys, h0, T, dxw, dwhh, ws, rows, H, 4 * H, s);
}
int reduce_dw(const float* ys, const float* h0, int T, const float* dxw,
              bf16* dwhh, float* ws, int rows, int H, cudaStream_t s) {
  return reduce_rows_tn_bf16_tc(ys, h0, T, dxw, dwhh, ws, rows, H, 4 * H, s);
}

template <typename TW>
int backward_any(const TW* w_hh_t, const float* h0, const float* c0,
                 const float* ys, const float* acts, const float* cs,
                 const float* dys, const float* dhn, const float* dcn,
                 float* dxw, TW* dwhh, float* dh0, float* dc0, float* ws,
                 int B, int T, int H, int ctas, void* stream_ptr) {
  if (!lstm_shape_ok(H, ctas) || B <= 0 || T <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream_ptr;
  int err = chain_backward(acts, cs, c0, dys, w_hh_t, dhn, dcn, dxw, dh0, dc0,
                           B, T, 0, T, nullptr, nullptr, H, ctas, s);
  if (err) return err;
  return reduce_dw(ys, h0, T, dxw, dwhh, ws, B * T, H, s);
}

// xw = y W_ih + b over the rows of a window (row m of y and xw is row
// win(m) of its plane; W_ih stored (H, 4H)): 3xTF32, or y rounded to bf16
// at the fragments against bf16 W_ih, FP32 sums
int layer_input(const float* y, const float* w_ih_t, const float* b,
                float* xw, RowMap win, int rows, int H, cudaStream_t s) {
  return gemm_tc_rows(y, win, w_ih_t, b, nullptr, xw, win, rows, 4 * H, H,
                      false, s);
}
int layer_input(const float* y, const bf16* w_ih_t, const float* b,
                float* xw, RowMap win, int rows, int H, cudaStream_t s) {
  return gemm_rows_bf16(y, win, w_ih_t, b, nullptr, xw, win, rows, 4 * H, H,
                        false, s);
}

// dy = dgates W_ih^T over the rows of a window, in the same two modes
int layer_input_grad(const float* dg, const float* w_ih_t, float* dy,
                     RowMap win, int rows, int H, cudaStream_t s) {
  return gemm_tc_rows(dg, win, w_ih_t, nullptr, nullptr, dy, win, rows, H,
                      4 * H, true, s);
}
int layer_input_grad(const float* dg, const bf16* w_ih_t, float* dy,
                     RowMap win, int rows, int H, cudaStream_t s) {
  return gemm_rows_bf16(dg, win, w_ih_t, nullptr, nullptr, dy, win, rows, H,
                        4 * H, true, s);
}

inline bool layers_ok(int B, int T, int H, int L, int ctas, int C) {
  return lstm_shape_ok(H, ctas) && B > 0 && T > 0 && L >= 2 && C >= 1;
}

// The layer route's streams, one a layer, and an event a layer, of one
// device; made once and kept, one call enqueues at a time (the events are
// reused call after call).
struct Lanes {
  std::vector<cudaStream_t> streams;
  std::vector<cudaEvent_t> events;
  cudaEvent_t fork = nullptr;
};

std::mutex lanes_mutex;
std::vector<Lanes> lanes_by_device;

int lanes_for(int L, Lanes** out) {
  int dev, err;
  if ((err = (int)cudaGetDevice(&dev))) return err;
  if ((int)lanes_by_device.size() <= dev) lanes_by_device.resize(dev + 1);
  Lanes& ln = lanes_by_device[dev];
  if (!ln.fork &&
      (err = (int)cudaEventCreateWithFlags(&ln.fork, cudaEventDisableTiming)))
    return err;
  while ((int)ln.streams.size() < L) {
    cudaStream_t s;
    cudaEvent_t e;
    if ((err = (int)cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking)) ||
        (err = (int)cudaEventCreateWithFlags(&e, cudaEventDisableTiming)))
      return err;
    ln.streams.push_back(s);
    ln.events.push_back(e);
  }
  *out = &ln;
  return 0;
}

// Fork L layer streams from the caller's stream, enqueue(lanes), and
// join: the caller's stream waits on every layer's, also after an error.
template <typename Enqueue>
int on_lanes(int L, cudaStream_t stream, Enqueue enqueue) {
  std::lock_guard<std::mutex> lock(lanes_mutex);
  Lanes* ln;
  int err;
  if ((err = lanes_for(L, &ln))) return err;
  if ((err = (int)cudaEventRecord(ln->fork, stream))) return err;
  for (int l = 0; l < L; ++l)
    if ((err = (int)cudaStreamWaitEvent(ln->streams[l], ln->fork, 0)))
      return err;
  err = enqueue(*ln);
  for (int l = 0; l < L; ++l) {
    int e = (int)cudaEventRecord(ln->events[l], ln->streams[l]);
    if (!e) e = (int)cudaStreamWaitEvent(stream, ln->events[l], 0);
    if (!err) err = e;
  }
  return err;
}

// The most CTAs a chain's cluster has: a backward carry slot holds that
// many partial dh carries and dc.
constexpr int MAX_CTAS = 16;

// floats of the layer route's scratch `ws`: two carry slots a layer (a
// window's state out is the next window's in: forward h and c, backward
// the partial dh carries and dc, lstm_backward) and, backward, a layer's
// split-K and column-sum partials (each layer reduces its weight
// gradients on its own stream after its last window)
size_t carry_floats(int B, int H, bool backward) {
  return 2 * (backward ? MAX_CTAS + 1 : 2) * (size_t)B * H;
}
size_t layers_ws_floats(int B, int H, int L, bool backward) {
  return (size_t)L * (carry_floats(B, H, backward) +
                      (backward ? PART_FLOATS + CPART_FLOATS : 0));
}

// K9's layer route, forward: window c of layer l on layer l's stream
// after window c of layer l - 1 (an event), so layer l runs window c
// while layer l - 1 runs window c + 1. Layer l's input product over the
// window's rows into the xw plane (B, T, 4H) the layers above 0 share (a
// window's rows are written by layer l's product only after layer l - 1
// read them), then its chain over the window from the state the window
// before left in the carry slots. Without residuals (hs null) the lower
// layers' h pass through ys: window c of layer l + 1 reads them and then
// writes its own over them, after layer l is done with the window.
template <typename TW>
int layers_forward(const float* xw0, const TW* w_ih_t, const float* b_rest,
                   const TW* w_hh_t, const float* h0, const float* c0,
                   float* ys, float* hn, float* cn, float* hs, float* acts,
                   float* cs, float* xw, float* ws, int B, int T, int H,
                   int L, int ctas, int C, void* stream_ptr) {
  if (!layers_ok(B, T, H, L, ctas, C) || !aligned16(ys, hs, acts, cs, xw))
    return (int)cudaErrorInvalidValue;
  const size_t rows = (size_t)B * T, G = 4 * (size_t)H, bh = (size_t)B * H;
  const int chunks = (T + C - 1) / C;
  return on_lanes(L, (cudaStream_t)stream_ptr, [&](Lanes& ln) {
    for (int c = 0; c < chunks; ++c) {
      const int t0 = c * C, n = T - t0 < C ? T - t0 : C;
      const bool last = c == chunks - 1;
      const RowMap win{T, t0, n};
      for (int l = 0; l < L; ++l) {
        const cudaStream_t s = ln.streams[l];
        int err;
        if (l > 0 && (err = (int)cudaStreamWaitEvent(s, ln.events[l - 1], 0)))
          return err;
        const float* x = xw0;
        if (l > 0) {
          const float* y_in = hs ? hs + (l - 1) * rows * H : ys;
          if ((err = layer_input(y_in, w_ih_t + (l - 1) * H * G,
                                 b_rest + (l - 1) * G, xw, win, B * n, H, s)))
            return err;
          x = xw;
        }
        float* carry = ws + l * carry_floats(B, H, false);
        const float* h_in = c == 0 ? h0 + l * bh : carry + ((c - 1) & 1) * 2 * bh;
        const float* c_in = c == 0 ? c0 + l * bh : h_in + bh;
        float* h_out = last ? hn + l * bh : carry + (c & 1) * 2 * bh;
        float* c_out = last ? cn + l * bh : h_out + bh;
        if ((err = chain_forward(
                 x, w_hh_t + l * H * G, h_in, c_in,
                 l == L - 1 || !hs ? ys : hs + l * rows * H, h_out, c_out,
                 acts ? acts + l * rows * G : nullptr,
                 cs ? cs + l * rows * H : nullptr, B, T, t0, n, H, ctas, s)) ||
            (err = (int)cudaEventRecord(ln.events[l], s)))
          return err;
      }
    }
    return 0;
  });
}

// K9's layer route, backward: the reverse schedule, the last window
// first, window c of layer l after window c of layer l + 1, whose
// product gave its dy. Per window: the reverse chain (dgates into the
// layer's (B, T, 4H) plane; the dh, dc carries through the carry slots),
// then dy of layer l - 1 over the window's rows into the dy plane (B, T,
// H) the layers share (layer l - 1 reads a window's rows before its own
// product writes layer l - 2's over them). After its first window a
// layer reduces dW_hh, dW_ih and db over all its rows on its stream,
// while the layers below run on: every sum in a fixed order.
template <typename TW>
int layers_backward(const TW* w_ih_t, const TW* w_hh_t, const float* h0,
                    const float* c0, const float* ys, const float* hs,
                    const float* acts, const float* cs, const float* dys,
                    const float* dhn, const float* dcn, float* dgates,
                    TW* dwih, float* db, TW* dwhh, float* dh0, float* dc0,
                    float* dy, float* ws, int B, int T, int H, int L,
                    int ctas, int C, void* stream_ptr) {
  if (!layers_ok(B, T, H, L, ctas, C) ||
      !aligned16(ys, hs, h0, dgates, dy))
    return (int)cudaErrorInvalidValue;
  const size_t rows = (size_t)B * T, G = 4 * (size_t)H, bh = (size_t)B * H;
  const int chunks = (T + C - 1) / C;
  const size_t slot = (MAX_CTAS + 1) * bh;  // partial dh carries, then dc
  float* parts = ws + L * carry_floats(B, H, true);
  return on_lanes(L, (cudaStream_t)stream_ptr, [&](Lanes& ln) {
    for (int c = chunks - 1; c >= 0; --c) {
      const int t0 = c * C, n = T - t0 < C ? T - t0 : C;
      const bool first = c == chunks - 1;
      const RowMap win{T, t0, n};
      for (int l = L - 1; l >= 0; --l) {
        const cudaStream_t s = ln.streams[l];
        int err;
        if (l < L - 1 &&
            (err = (int)cudaStreamWaitEvent(s, ln.events[l + 1], 0)))
          return err;
        float* carry = ws + l * carry_floats(B, H, true);
        float* dg_l = dgates + l * rows * G;
        float* in_slot = carry + ((c + 1) & 1) * slot;
        float* out_slot = carry + (c & 1) * slot;
        if ((err = chain_backward(
                 acts + l * rows * G, cs + l * rows * H, c0 + l * bh,
                 l == L - 1 ? dys : dy, w_hh_t + l * H * G, dhn + l * bh,
                 first ? dcn + l * bh : in_slot + MAX_CTAS * bh, dg_l,
                 c == 0 ? dh0 + l * bh : nullptr,
                 c == 0 ? dc0 + l * bh : out_slot + MAX_CTAS * bh, B, T, t0,
                 n, first ? nullptr : in_slot, c == 0 ? nullptr : out_slot, H,
                 ctas, s)))
          return err;
        if (l > 0 && (err = layer_input_grad(dg_l, w_ih_t + (l - 1) * H * G,
                                             dy, win, B * n, H, s)))
          return err;
        if ((err = (int)cudaEventRecord(ln.events[l], s))) return err;
        if (c > 0) continue;
        // the layer's weight gradients over all B*T rows: dW_hh_l =
        // h_l(t-1)^T dgates_l; layer l's input is h_{l-1}(t): dW_ih_l =
        // h_{l-1}^T dgates_l, db_l = colsum(dgates_l)
        float* part = parts + (size_t)l * (PART_FLOATS + CPART_FLOATS);
        if ((err = reduce_dw(l == L - 1 ? ys : hs + l * rows * H,
                             h0 + l * bh, T, dg_l, dwhh + l * H * G, part,
                             (int)rows, H, s)))
          return err;
        if (l > 0 &&
            ((err = reduce_dw(hs + (l - 1) * rows * H, nullptr, 0, dg_l,
                              dwih + (l - 1) * H * G, part, (int)rows, H,
                              s)) ||
             (err = colsum(dg_l, db + (l - 1) * G, part + PART_FLOATS,
                           (int)rows, (int)G, s))))
          return err;
      }
    }
    return 0;
  });
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
  return forward_any(xw, w_hh_t, h0, c0, ys, hn, cn, acts, cs, B, T, H, ctas,
                     stream_ptr);
}

// The same in the bf16 operand mode: w_hh_t bf16, the rest FP32.
int lstm_recurrence_forward_bf16(const float* xw, const bf16* w_hh_t,
                                 const float* h0, const float* c0, float* ys,
                                 float* hn, float* cn, float* acts, float* cs,
                                 int B, int T, int H, int ctas,
                                 void* stream_ptr) {
  return forward_any(xw, w_hh_t, h0, c0, ys, hn, cn, acts, cs, B, T, H, ctas,
                     stream_ptr);
}

// Clusters of 16 batch rows the card runs at once for hidden size H over
// clusters of `ctas` CTAs, the fewer of the forward's and the backward's;
// more run in waves. -1 on an error.
int lstm_recurrence_resident_clusters(int H, int ctas) {
  return resident_any<float>(H, ctas);
}

// The same for the bf16 mode's instantiations.
int lstm_recurrence_resident_clusters_bf16(int H, int ctas) {
  return resident_any<bf16>(H, ctas);
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
  return backward_any(w_hh_t, h0, c0, ys, acts, cs, dys, dhn, dcn, dxw, dwhh,
                      dh0, dc0, ws, B, T, H, ctas, stream_ptr);
}

// The same in the bf16 operand mode: w_hh_t and dw_hh_t bf16, the rest
// FP32.
int lstm_recurrence_backward_bf16(const bf16* w_hh_t, const float* h0,
                                  const float* c0, const float* ys,
                                  const float* acts, const float* cs,
                                  const float* dys, const float* dhn,
                                  const float* dcn, float* dxw, bf16* dwhh,
                                  float* dh0, float* dc0, float* ws, int B,
                                  int T, int H, int ctas, void* stream_ptr) {
  return backward_any(w_hh_t, h0, c0, ys, acts, cs, dys, dhn, dcn, dxw, dwhh,
                      dh0, dc0, ws, B, T, H, ctas, stream_ptr);
}

// K9's layer route (the header): xw0 (B,T,4H), w_ih_t (L-1,H,4H), b_rest
// (L-1,4H), w_hh_t (L,H,4H), h0, c0 (L,B,H). Writes ys (B,T,H), hn, cn
// (L,B,H) and, when hs/acts/cs are not null, the backward's residuals hs
// (L-1,B,T,H), acts (L,B,T,4H), cs (L,B,T,H). xw: scratch (B,T,4H); ws:
// lstm_stacked_layers_workspace_floats(B, H, L, 0); ctas: CTAs per
// cluster of the chains (lstm_shape_ok); C: steps a window (C = T: the
// layers one after the other); L >= 2.
int lstm_stacked_layers_forward_f32(
    const float* xw0, const float* w_ih_t, const float* b_rest,
    const float* w_hh_t, const float* h0, const float* c0, float* ys,
    float* hn, float* cn, float* hs, float* acts, float* cs, float* xw,
    float* ws, int B, int T, int H, int L, int ctas, int C,
    void* stream_ptr) {
  return layers_forward(xw0, w_ih_t, b_rest, w_hh_t, h0, c0, ys, hn, cn, hs,
                        acts, cs, xw, ws, B, T, H, L, ctas, C, stream_ptr);
}

// The same in the bf16 operand mode: w_ih_t and w_hh_t bf16, the rest
// FP32.
int lstm_stacked_layers_forward_bf16(
    const float* xw0, const bf16* w_ih_t, const float* b_rest,
    const bf16* w_hh_t, const float* h0, const float* c0, float* ys,
    float* hn, float* cn, float* hs, float* acts, float* cs, float* xw,
    float* ws, int B, int T, int H, int L, int ctas, int C,
    void* stream_ptr) {
  return layers_forward(xw0, w_ih_t, b_rest, w_hh_t, h0, c0, ys, hn, cn, hs,
                        acts, cs, xw, ws, B, T, H, L, ctas, C, stream_ptr);
}

// floats of the layer route's scratch `ws`, forward (backward 0) or
// backward (1)
long long lstm_stacked_layers_workspace_floats(int B, int H, int L,
                                               int backward) {
  return (long long)layers_ws_floats(B, H, L, backward != 0);
}

// From the forward's residuals and the cotangents dys (B,T,H), dhn, dcn
// (L,B,H): dgates (L,B,T,4H) (layer 0's are dxw0), dw_ih_t (L-1,H,4H), db
// (L-1,4H), dw_hh_t (L,H,4H), dh0, dc0 (L,B,H). dy: scratch (B,T,H); ws:
// lstm_stacked_layers_workspace_floats(B, H, L, 1); ctas and C as the
// forward's. Every (B,T,*) array and h0 16-byte aligned.
int lstm_stacked_layers_backward_f32(
    const float* w_ih_t, const float* w_hh_t, const float* h0,
    const float* c0, const float* ys, const float* hs, const float* acts,
    const float* cs, const float* dys, const float* dhn, const float* dcn,
    float* dgates, float* dwih, float* db, float* dwhh, float* dh0,
    float* dc0, float* dy, float* ws, int B, int T, int H, int L, int ctas,
    int C, void* stream_ptr) {
  return layers_backward(w_ih_t, w_hh_t, h0, c0, ys, hs, acts, cs, dys, dhn,
                         dcn, dgates, dwih, db, dwhh, dh0, dc0, dy, ws, B, T,
                         H, L, ctas, C, stream_ptr);
}

// The bf16 mode: w_ih_t, w_hh_t, dw_ih_t and dw_hh_t bf16 (each FP32 sum
// rounded once); the rest FP32.
int lstm_stacked_layers_backward_bf16(
    const bf16* w_ih_t, const bf16* w_hh_t, const float* h0,
    const float* c0, const float* ys, const float* hs, const float* acts,
    const float* cs, const float* dys, const float* dhn, const float* dcn,
    float* dgates, bf16* dwih, float* db, bf16* dwhh, float* dh0,
    float* dc0, float* dy, float* ws, int B, int T, int H, int L, int ctas,
    int C, void* stream_ptr) {
  return layers_backward(w_ih_t, w_hh_t, h0, c0, ys, hs, acts, cs, dys, dhn,
                         dcn, dgates, dwih, db, dwhh, dh0, dc0, dy, ws, B, T,
                         H, L, ctas, C, stream_ptr);
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
