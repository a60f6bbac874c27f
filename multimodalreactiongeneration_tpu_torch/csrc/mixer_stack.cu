// Recurrent-mixer block stack: inference forward, training forward and
// backward.
//
// Replaces, in multimodalreactiongeneration_tpu/ops/pallas_mixer_stack.py
// (mixer_stack_recurrence):
//   mixer_stack_forward_f32         _fwd_kernel_light  (the primal)
//   mixer_stack_train_forward_f32   _fwd_kernel        (_vjp_fwd)
//   mixer_stack_backward_f32        _bwd_kernel        (_vjp_bwd)
// and the three in JAX's bf16 operand mode (bf16 W_ih, W_hh and W_ff; the
// rest FP32):
//   mixer_stack_forward_bf16        _fwd_kernel_light
//   mixer_stack_train_forward_bf16  _fwd_kernel
//   mixer_stack_backward_bf16       _bwd_kernel
// Each of the L blocks computes  LSTM -> +x -> LN -> Dense(H->H) -> +res
// -> LN  over (B, T, H); the stack returns the top block's output and
// every block's final (h, c).
//
// What bounds it on the H100: the LSTM recurrence. Its T cell steps are
// a dependent chain, and each step is a small (B x H) @ (H x 4H) product
// plus the gate math; at B16, H256 that is 4.2 MFLOP, far too little to
// fill the card, so the time is the per-step latency times the chain's
// steps, and one recurrence holds 8 SMs per 16 batch rows. The
// input projection and the block tail are parallel over all B*T rows
// and are bounded by FP32 FMA throughput (about 110 GFLOP at the audio
// encoder shape B16 x T2096 x L5); the backward adds three such
// products per block (dW_ih, dW_hh, dx) and the Dense's two, which it
// runs on the tensor cores in 3xTF32: its weight-gradient reductions,
// beside the chains, are what bound it at B32 (PERF.md §5-6).
//
// Forward design (building blocks in lstm_cluster.cuh): a layer-lagged
// chunk schedule on per-layer streams. Layer l runs the steps of chunk c
// (C steps from t0 = c*C; the last chunk may be shorter) once layer l-1
// has finished chunk c, so the L layers' recurrences run at the same
// time and the chain is (ceil(T/C) + L - 1) * C cell steps instead of
// L * T. Chunk (l, c) on layer l's stream, after an event wait on (l-1,
// c):
//   1. gemm_kernel: the chunk's rows of x_l @ W_ih + (b_ih + b_hh) into
//      layer l's xw chunk buffer (B, C, 4H); a shared-memory tiled FP32
//      GEMM (64x64 tiles, 4x4 per thread) reading the rows of the (B, C)
//      window of the (B, T) plane (RowMap);
//   2. lstm_window_kernel: the chunk's cells, from the (h, c) carried
//      from chunk c-1 (ping-pong buffers per layer; h0, c0 at chunk 0,
//      hn, cn written after the last). W_hh (H x 4H f32 = 1 MB at H256)
//      does not fit one SM, so a cluster of 8 CTAs splits it: CTA r
//      keeps the four gate columns of hidden units [r*H/8, (r+1)*H/8) in
//      shared memory (128 KB), loaded once a chunk. Each step every CTA
//      forms its gate slice from the full h, updates its units' cells,
//      and writes its slice of the new h into every CTA's double-
//      buffered h through distributed shared memory; one cluster barrier
//      per step orders the exchange. A cluster serves STACK_ROWS = 16
//      batch rows; larger batches add clusters (32 rows ran slower at
//      B64: PERF.md);
//   3. add_ln_kernel + gemm_kernel + add_ln_kernel: the block tail,
//      LN(h + x) -> Dense -> LN(z + y), on the window's rows.
// Stream order gives (l, c-1) -> (l, c), so one xw chunk buffer a layer
// is safe. An event on the caller's stream forks the layer streams at
// entry; at exit the caller's stream waits on each of them. Every output
// element is summed in the same order as in one whole-sequence chunk
// (C = T, the layer-major schedule), so any C gives the same bits.
// The training forward writes per block the residuals the backward
// reads (RES_PLANES below) into (B, T) planes, at the chunk's rows; the
// TPU kernel's A/M residuals become A = [i, f, g, o] and the cell
// states. The inference forward keeps the LSTM output, y and z in chunk
// buffers and each block's output but the top one in a (B, T, H) plane
// (the layers are not throttled against each other). The TPU kernel
// lags a block by 8 steps inside one kernel; on the H100 a chunk is a
// few launches, so C is longer (ops/mixer_stack.py chunk_steps).
//
// Backward design (lstm_cluster_bwd.cuh): the same schedule in reverse on
// the same layer streams. Chunks run from the last to the first; block
// L-1 leads, and block l runs chunk c once block l+1 has finished it.
// Chunk (l, c) on layer l's stream, after an event wait on (l+1, c):
//   1. the tail backward on the window's rows: the cotangent of the
//      block's output (dout for the top block, else the rows block l+1
//      wrote), LN2 backward (ln_bwd_kernel), dy = dz @ W_ff^T + dz, LN1
//      backward: the cotangent of h and of x, in chunk buffers (B, C, H);
//   2. lstm_cluster_bwd_kernel: the reverse recurrence over the
//      window from the (dh, dc) carried from chunk c+1 (dhn, dcn at the
//      last chunk; dh0, dc0 written at chunk 0), ping-pong buffers per
//      layer; dh is carried as its 8 unsummed cluster slots, so a chunk
//      boundary sums it as a step inside a chunk does. It writes the
//      chunk's dgates (B, C, 4H) into a chunk buffer;
//   3. dx = dgates @ W_ih + (the x cotangent) into the window's rows of
//      dx0. dx0 is the hand-off between blocks: chunk (l-1, c) reads those
//      rows as its output's cotangent in its step 1 and overwrites them
//      in its step 3, so no (B, T, H) plane per block boundary is needed
//      and the residuals stay as the forward wrote them;
//   4. on a side stream the layers share, after an event on step 3: the
//      window's share of the nine parameter gradients, dW_ih = x^T
//      dgates, dW_hh = h_{t-1}^T dgates (h0 before step 0) and dW_ff =
//      y^T dz as split-K reductions in 3xTF32 (tc_gemm.cuh), db and the
//      LN scale and bias sums as one column-sum pass, added to the
//      gradients in chunk order (the first chunk run writes them): a
//      fixed order without atomics, so the gradients are the same bits
//      run after run at one C. The layer's next chunk goes on meanwhile:
//      its chunk buffers are two slots (one when T is one chunk), and
//      chunk c waits for the side stream to finish chunk c+2, the slot's
//      last user.
// The products dy = dz @ W_ff^T + dz and dx run in 3xTF32 too, with no
// split over K.
// dx0, dh0 and dc0 are the same bits at every C: no per-row sum is split
// over chunks (the row products have no split over K, LayerNorm is one
// warp a row, the carries are f32 in the chain's own order). The
// parameter gradients change their summation order with C. Scratch is
// per layer (the layers run at once): the chunk buffers and the carries,
// B*C rows and no (B, T) plane; and the side stream's partials. The
// chain is (ceil(T/C) + L - 1) * C reverse steps instead of L * T.
//
// The bf16 operand mode (TW = bf16; JAX's _fwd_kernel and _bwd_kernel
// with bf16 weights): every product rounds its activation operand to bf16
// and takes the bf16 weights, with FP32 sums; the states, the cell math,
// the LayerNorms, the residual planes, dx0, db and the LayerNorm
// gradients stay FP32. The forward's chunk input product and Dense, and
// the backward's dy, dx and three weight-gradient reductions, run as one
// bf16 mma.sync.m16n8k16 pass each (bf16_gemm.cuh) where the FP32 mode
// takes SIMT FP32 and 3xTF32; the chains are the window kernels
// instantiated on bf16 W_hh (h and the dgates rounded at the product).
// The weight gradients add their chunks' sums in FP32 (in scratch) and
// round to bf16 once, after the layer's last chunk, as JAX casts its f32
// sums. The bf16 chains' CTAs reserve the FP32 mode's shared memory, so
// they land one an SM as the FP32 ones do (at H256 two bf16 CTAs would
// share an SM: PERF.md, PR 18).

// Hidden sizes. The chains take every H that is a multiple of their
// cluster size, 8 CTAs up to 256 and 16 (the non-portable size) from 257
// to 512, so a CTA owns at most 32 units; ops/mixer_stack.py pads any
// other H up to 512 with zero units, and the LayerNorms take the real
// width Hr (statistics over it, 0 past it), which keeps every padded unit
// 0 through every block (ops/mixer_stack.py says why). Past H 400 an
// FP32 CTA's W_hh slice no longer fits beside its h buffers: it keeps
// the rows (forward) or gate columns (backward) that fit and reads the
// others from device memory each step, where W_hh stays resident in L2
// (chain_layout; the backward reads them from a transposed copy in its
// workspace, so consecutive units are consecutive addresses). At 16 CTAs
// a cluster the card holds 7 or 8 clusters at once, so at B32 x L5 the
// layers' chains wait on each other's SMs: that costs the schedule its
// overlap, not its order (chunks are launches ordered by events).

#include <mutex>
#include <vector>

#include "bf16_gemm.cuh"
#include "tc_gemm.cuh"

namespace {

// batch rows per cluster of the forward recurrence (ops/mixer_stack.py
// ROWS)
constexpr int STACK_ROWS = 16;

// Residuals of the training forward, per block l, each a (B, T, H)
// plane except the 4-plane gate activations: h trajectory, A = [i, f, g,
// o], cell states, y = LN(h + x), z = y @ W_ff + b_ff, and the block's
// output (the next block's input). The top block has no output plane
// (its output is the stack's), so the buffer holds RES_PLANES * L - 1.
constexpr int RES_PLANES = 9;

struct BlockRes {
  float *rnn, *acts, *cs, *y, *z, *out;
};

BlockRes block_res(float* res, size_t bth, int l) {
  float* p = res + (size_t)l * RES_PLANES * bth;
  return {p, p + bth, p + 5 * bth, p + 6 * bth, p + 7 * bth, p + 8 * bth};
}

bool shape_ok(int B, int T, int H, int Hr, int L) {
  return hidden_ok(H) && Hr >= 1 && Hr <= H && B > 0 && T > 0 && L > 0;
}

// the chains on clusters of cl CTAs (cluster_for(H))
template <typename TW>
using WindowKernel = decltype(&lstm_window_kernel<STACK_ROWS, CL, TW>);
template <typename TW>
using ReverseKernel = decltype(&lstm_cluster_bwd_kernel<STACK_ROWS, CL, TW>);

// (each chain reading what lay does not keep of W_hh from device memory
// where there is some: only FP32 spills, only on 16-CTA clusters)
template <typename TW>
WindowKernel<TW> window_kernel(const ChainLayout& lay, int H) {
  if constexpr (std::is_same<TW, float>::value)
    if (lay.kept < H)
      return &lstm_window_kernel<STACK_ROWS, CL_WIDE, TW, true>;
  if (lay.cl > CL) return &lstm_window_kernel<STACK_ROWS, CL_WIDE, TW>;
  return &lstm_window_kernel<STACK_ROWS, CL, TW>;
}
template <typename TW>
ReverseKernel<TW> reverse_kernel(const ChainLayout& lay, int H) {
  if constexpr (std::is_same<TW, float>::value)
    if (lay.kept < 4 * (H / lay.cl))
      return &lstm_cluster_bwd_kernel<STACK_ROWS, CL_WIDE, TW, true>;
  if (lay.cl > CL) return &lstm_cluster_bwd_kernel<STACK_ROWS, CL_WIDE, TW>;
  return &lstm_cluster_bwd_kernel<STACK_ROWS, CL, TW>;
}

// The layout of a chain CTA (lstm_layout at STACK_ROWS, W_hh's slice
// spilling to device memory where it does not fit), and the shared memory
// it reserves: its own need, at least the FP32 mode's (so bf16 CTAs land
// one an SM as FP32 ones do)
template <typename TW>
ChainLayout chain_layout(int H, bool backward) {
  ChainLayout own = lstm_layout(H, STACK_ROWS, sizeof(TW), backward, true);
  const ChainLayout f32 =
      lstm_layout(H, STACK_ROWS, sizeof(float), backward, true);
  own.smem = std::max(own.smem, f32.smem);
  return own;
}

// Scratch of the forward per layer: the xw chunk buffer (4H per row of a
// chunk), the inference forward's LSTM output, y and z chunk buffers (H
// each), and two (h, c) carries (B, H) each
size_t layer_floats(int B, int C, int H, bool train) {
  return (size_t)B * C * H * (train ? 4 : 7) + 4 * (size_t)B * H;
}

// The streams and events of one device, made once and kept; one stack
// call enqueues at a time (the events are reused call after call). A
// layer's chain runs on its stream in `chains`, at the card's greatest
// stream priority; the backward's weight-gradient reductions run on one
// stream, `side`, at the least, so that when an SM frees up its block
// scheduler serves the chains first. L + 1 streams stay within the card's
// 8 hardware work queues at L5 with the caller's stream (streams that
// share a queue wait on each other's work in the order it was issued: 2L
// streams ran K4 1.4x slower). The forward uses an event per layer, the
// backward three.
struct Lanes {
  std::vector<cudaStream_t> chains;
  cudaStream_t side = nullptr;
  std::vector<cudaEvent_t> events;
  cudaEvent_t fork = nullptr;
};

std::mutex lanes_mutex;
std::vector<Lanes> lanes_by_device;

int lanes_for(int L, int n_events, Lanes** out) {
  int dev, err, least, greatest;
  if ((err = (int)cudaGetDevice(&dev)) ||
      (err = (int)cudaDeviceGetStreamPriorityRange(&least, &greatest)))
    return err;
  if ((int)lanes_by_device.size() <= dev) lanes_by_device.resize(dev + 1);
  Lanes& ln = lanes_by_device[dev];
  if (!ln.fork &&
      (err = (int)cudaEventCreateWithFlags(&ln.fork, cudaEventDisableTiming)))
    return err;
  if (!ln.side &&
      (err = (int)cudaStreamCreateWithPriority(&ln.side, cudaStreamNonBlocking,
                                               least)))
    return err;
  while ((int)ln.chains.size() < L) {
    cudaStream_t s;
    if ((err = (int)cudaStreamCreateWithPriority(&s, cudaStreamNonBlocking,
                                                 greatest)))
      return err;
    ln.chains.push_back(s);
  }
  while ((int)ln.events.size() < n_events) {
    cudaEvent_t e;
    if ((err = (int)cudaEventCreateWithFlags(&e, cudaEventDisableTiming)))
      return err;
    ln.events.push_back(e);
  }
  *out = &ln;
  return 0;
}

template <typename TW>
struct StackArgs {
  const float* x0;
  const TW* w_ih_t;
  const float* b_g;
  const TW *w_hh_t, *w_ff;
  const float *b_ff, *g1, *b1, *g2, *b2, *h0, *c0;
  float *out, *hn, *cn, *res, *ws;
  int B, T, H, Hr, L, C;  // Hr: the real width of a zero-padded stack
};

// The forward's row products C[mc(m)] = A[ma(m)] @ W + bias: SIMT FP32,
// or the bf16 operand mode on the tensor cores
int row_product(const float* A, RowMap ma, const float* W, const float* bias,
                float* C, RowMap mc, int M, int N, int K, cudaStream_t s) {
  return gemm_rows(A, ma, W, bias, C, mc, M, N, K, s);
}
int row_product(const float* A, RowMap ma, const bf16* W, const float* bias,
                float* C, RowMap mc, int M, int N, int K, cudaStream_t s) {
  return gemm_rows_bf16(A, ma, W, bias, nullptr, C, mc, M, N, K, false, s);
}

// The backward's row products C[mo(m)] = A @ W^T + D (A, D dense; W
// stored (N, K)): 3xTF32, or the bf16 operand mode
int product_nt(const float* A, const float* W, const float* D, float* C,
               RowMap mo, int M, int N, int K, cudaStream_t s) {
  return gemm_tc(A, W, nullptr, D, C, mo, M, N, K, true, s);
}
int product_nt(const float* A, const bf16* W, const float* D, float* C,
               RowMap mo, int M, int N, int K, cudaStream_t s) {
  return gemm_rows_bf16(A, RowMap{M, 0, M}, W, nullptr, D, C, mo, M, N, K,
                        true, s);
}

// out = (with acc: out +) A'^T B over a window's rows (reduce_window_tn_tc
// of tc_gemm.cuh, or its bf16 operand mode)
template <typename TW>
int reduce_window(const float* A, RowMap ma, const float* h0, const float* Bm,
                  float* out, bool acc, float* part, int R, int M, int N,
                  cudaStream_t s) {
  if constexpr (std::is_same_v<TW, bf16>)
    return reduce_window_tn_bf16(A, ma, h0, Bm, out, acc, part, R, M, N, s);
  else
    return reduce_window_tn_tc(A, ma, h0, Bm, out, acc, part, R, M, N, s);
}

// Enqueue chunk c of every layer, each on its stream after (l-1, c): the
// chains launched by cfg (stream set here), keeping ks rows of W_hh^T in
// shared memory.
template <typename TW, typename Kernel>
int enqueue_chunk(const StackArgs<TW>& a, Lanes& ln, cudaLaunchConfig_t cfg,
                  Kernel kernel, int ks, int c) {
  const int B = a.B, T = a.T, H = a.H, C = a.C;
  const bool train = a.res != nullptr;
  const size_t bth = (size_t)B * T * H, bh = (size_t)B * H;
  const int t0 = c * C, n = T - t0 < C ? T - t0 : C, rows = B * n;
  const bool last = t0 + n == T;
  const RowMap win{T, t0, n}, dense{n, 0, n};
  float* planes = a.ws + a.L * layer_floats(B, C, H, train);
  int err;
  for (int l = 0; l < a.L; ++l) {
    cudaStream_t s = ln.chains[l];
    if (l > 0 && (err = (int)cudaStreamWaitEvent(s, ln.events[l - 1], 0)))
      return err;
    const size_t wo = (size_t)l * H * 4 * H, so = (size_t)l * bh,
                 vo = (size_t)l * H;
    float* xw = a.ws + l * layer_floats(B, C, H, train);
    float* carry = xw + (size_t)B * C * H * (train ? 4 : 7);
    // the block's input and output planes (B, T, H)
    const float* xin = l == 0 ? a.x0
                     : train  ? block_res(a.res, bth, l - 1).out
                              : planes + (l - 1) * bth;
    float* xout = l == a.L - 1 ? a.out
                : train        ? block_res(a.res, bth, l).out
                               : planes + l * bth;
    // LSTM output, y, z: residual planes (training) or chunk buffers
    BlockRes r;
    RowMap m;
    if (train) {
      r = block_res(a.res, bth, l);
      m = win;
    } else {
      float* cb = xw + (size_t)B * C * 4 * H;
      const size_t cf = (size_t)B * C * H;
      r = BlockRes{cb, nullptr, nullptr, cb + cf, cb + 2 * cf, nullptr};
      m = dense;
    }
    const float* h_in = c == 0 ? a.h0 + so : carry + ((c - 1) & 1) * 2 * bh;
    const float* c_in = c == 0 ? a.c0 + so : h_in + bh;
    float* h_out = last ? a.hn + so : carry + (c & 1) * 2 * bh;
    float* c_out = last ? a.cn + so : h_out + bh;
    if ((err = row_product(xin, win, a.w_ih_t + wo, a.b_g + 4 * vo, xw,
                           dense, rows, 4 * H, H, s)))
      return err;
    cfg.stream = s;
    if ((err = (int)cudaLaunchKernelEx(
             &cfg, kernel, (const float*)xw, a.w_hh_t + wo, h_in, c_in, r.rnn,
             h_out, c_out, r.acts, r.cs, B, m.T, H, m.t0, n, ks)))
      return err;
    if ((err = check_launch())) return err;
    if ((err = add_ln(r.rnn, m, xin, win, a.g1 + vo, a.b1 + vo, r.y, m, rows,
                      H, a.Hr, s)))
      return err;
    if ((err = row_product(r.y, m, a.w_ff + (size_t)l * H * H, a.b_ff + vo,
                           r.z, m, rows, H, H, s)))
      return err;
    if ((err = add_ln(r.z, m, r.y, m, a.g2 + vo, a.b2 + vo, xout, win, rows,
                      H, a.Hr, s)))
      return err;
    if ((err = (int)cudaEventRecord(ln.events[l], s))) return err;
  }
  return 0;
}

// Fork the L chain streams (and with side, the side stream) from the
// caller's stream, enqueue(lanes), and join: the caller's stream waits on
// every lane, also after an error. n_events >= L + 1.
template <typename Enqueue>
int on_lanes(int L, bool side, int n_events, cudaStream_t stream,
             Enqueue enqueue) {
  std::lock_guard<std::mutex> lock(lanes_mutex);
  Lanes* ln;
  int err;
  if ((err = lanes_for(L, n_events, &ln))) return err;
  std::vector<cudaStream_t> lanes(ln->chains.begin(), ln->chains.begin() + L);
  if (side) lanes.push_back(ln->side);
  if ((err = (int)cudaEventRecord(ln->fork, stream))) return err;
  for (cudaStream_t s : lanes)
    if ((err = (int)cudaStreamWaitEvent(s, ln->fork, 0))) return err;
  err = enqueue(*ln);
  for (size_t i = 0; i < lanes.size(); ++i) {
    int e = (int)cudaEventRecord(ln->events[i], lanes[i]);
    if (!e) e = (int)cudaStreamWaitEvent(stream, ln->events[i], 0);
    if (!err) err = e;
  }
  return err;
}

template <typename TW>
int stack_forward(const StackArgs<TW>& a, cudaStream_t stream) {
  if (!shape_ok(a.B, a.T, a.H, a.Hr, a.L) || a.C < 1 || a.C > a.T)
    return (int)cudaErrorInvalidValue;
  const ChainLayout lay = chain_layout<TW>(a.H, false);
  const auto kernel = window_kernel<TW>(lay, a.H);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  int err = cluster_config(
      kernel, lay.cl, (unsigned)((a.B + STACK_ROWS - 1) / STACK_ROWS),
      lay.smem, cfg, attr);
  if (err) return err;
  return on_lanes(a.L, false, a.L + 1, stream, [&](Lanes& ln) {
    const int chunks = (a.T + a.C - 1) / a.C;
    int e = 0;
    for (int c = 0; c < chunks && !e; ++c)
      e = enqueue_chunk(a, ln, cfg, kernel, lay.kept, c);
    return e;
  });
}

// dwih, dwhh and dwff hold the weight gradients in FP32: the outputs of
// the FP32 mode; in the bf16 mode scratch, rounded into dw16 (dW_ih,
// dW_hh, dW_ff) after each layer's last chunk
template <typename TW>
struct BwdArgs {
  const float* x0;
  const TW *w_ih_t, *w_hh_t, *w_ff;
  const float *g1, *g2, *h0, *c0, *res, *dout, *dhn, *dcn;
  float *dx0, *dh0, *dc0, *dwih, *dbg, *dwhh, *dwff, *dbff, *dg1, *db1, *dg2,
      *db2, *ws;
  int B, T, H, Hr, L, C;
  bf16* dw16[3];
};

__global__ void __launch_bounds__(256) round_bf16_kernel(
    const float* __restrict__ src, bf16* __restrict__ dst, size_t n) {
  const size_t i = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (i < n) dst[i] = __float2bfloat16(src[i]);
}

int round_bf16(const float* src, bf16* dst, size_t n, cudaStream_t s) {
  round_bf16_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(src, dst, n);
  return check_launch();
}

// Chunk buffers of the backward, H floats per row of a chunk each: the
// dgates (4), dz, the h and x cotangent dhx, dcur (the output cotangent)
// and dy, and the LayerNorm scale-gradient terms dcur * xhat2 and dy *
// xhat1 (BWD_ROW * H a row in all)
constexpr int BWD_ROW = 10;

// Chunk-buffer slots of the backward per layer: two, so that the layer's
// next chunk runs while the side stream reads the last one; one when T
// is one chunk
int bwd_slots(int T, int C) { return T > C ? 2 : 1; }

// Scratch of the backward per layer: the slots of chunk buffers and two
// carries (each the cluster_for(H) dh_carry slots and dc, (B, H) each);
// after the layers', the side stream's split-K partials and, past H 256,
// each layer's W_hh (4H, H) for the gate columns its reverse chain keeps
// in device memory (chain_layout)
size_t bwd_layer_floats(int B, int T, int C, int H) {
  return (size_t)bwd_slots(T, C) * B * C * BWD_ROW * H +
         2 * (size_t)(cluster_for(H) + 1) * B * H;
}

size_t bwd_w_floats(int H, int L) {
  return H > CL * MAX_U ? (size_t)L * 4 * H * H : 0;
}

// Enqueue chunk (l, c): its chain on the layer's stream after (l+1, c),
// its gradient reductions on the side stream after that. Chunk c uses
// slot c & 1 of the layer's chunk buffers, after the side stream has
// read them for chunk c + 2. The first chunk run (c = chunks - 1) writes
// the gradients, the others add to them. The reverse chains launch by cfg
// (stream set here) on clusters of lay.cl CTAs, keeping lay.kept gate
// columns in shared memory and the others in w_t (4H, H) a layer.
template <typename TW, typename Kernel>
int enqueue_bwd_chunk(const BwdArgs<TW>& a, Lanes& ln, cudaLaunchConfig_t cfg,
                      Kernel kernel, const ChainLayout& lay, const TW* w_t,
                      int l, int c, int chunks) {
  const int B = a.B, T = a.T, H = a.H, C = a.C, L = a.L, cl = lay.cl;
  const size_t bth = (size_t)B * T * H, bh = (size_t)B * H;
  const size_t cf = (size_t)B * C * H;
  const int t0 = c * C, n = T - t0 < C ? T - t0 : C, rows = B * n;
  const RowMap win{T, t0, n}, dense{n, 0, n};
  const bool first = c == chunks - 1, acc = !first;
  const int slot = c & 1;
  int err;
  cudaStream_t s = ln.chains[l], side = ln.side;
  cudaEvent_t done = ln.events[l], freed = ln.events[L + 2 * l + slot];
  if (c + 2 < chunks && (err = (int)cudaStreamWaitEvent(s, freed, 0)))
    return err;
  if (l < L - 1 && (err = (int)cudaStreamWaitEvent(s, ln.events[l + 1], 0)))
    return err;
  const size_t wo = (size_t)l * H * 4 * H, fo = (size_t)l * H * H,
               so = (size_t)l * bh, vo = (size_t)l * H;
  float* base = a.ws + l * bwd_layer_floats(B, T, C, H);
  float* dgates = base + slot * BWD_ROW * cf;
  float* dz = dgates + 4 * cf;
  float* dhx = dz + cf;
  float* dcur = dhx + cf;
  float* dy = dcur + cf;
  float* p2 = dy + cf;
  float* p1 = p2 + cf;
  float* carry = base + bwd_slots(T, C) * BWD_ROW * cf;  // [2][cl + 1][B][H]
  float* part = a.ws + L * bwd_layer_floats(B, T, C, H);
  float* cpart = part + PART_FLOATS;
  float* res = const_cast<float*>(a.res);
  const BlockRes r = block_res(res, bth, l);
  const float* xin = l == 0 ? a.x0 : block_res(res, bth, l - 1).out;
  // 1. the tail: out = LN2(z + y) from the rows of dout, or of dx0 that
  // block l+1 wrote; then dy = dz @ W_ff^T + dz (z = y @ W_ff + b_ff,
  // and y also feeds the residual), y = LN1(h + x)
  if ((err = ln_bwd(l == L - 1 ? a.dout : a.dx0, win, r.z, win, r.y, win,
                    a.g2 + vo, dz, p2, dcur, rows, H, a.Hr, s)) ||
      (err = product_nt(dz, a.w_ff + fo, dz, dy, dense, rows, H, H, s)) ||
      (err = ln_bwd(dy, dense, r.rnn, win, xin, win, a.g1 + vo, dhx, p1,
                    nullptr, rows, H, a.Hr, s)))
    return err;
  // 2. the reverse recurrence over the window
  float* cin = carry + ((c + 1) & 1) * (cl + 1) * bh;
  float* cout = carry + (c & 1) * (cl + 1) * bh;
  cfg.stream = s;
  if ((err = (int)cudaLaunchKernelEx(
           &cfg, kernel, (const float*)r.acts, (const float*)r.cs, a.c0 + so,
           (const float*)dhx, a.w_hh_t + wo, a.dhn + so,
           first ? a.dcn + so : (const float*)cin + cl * bh,
           first ? nullptr : (const float*)cin, dgates, a.dh0 + so,
           c == 0 ? a.dc0 + so : cout + cl * bh, c == 0 ? nullptr : cout, B,
           T, H, t0, n, w_t ? w_t + wo : nullptr, lay.kept)) ||
      (err = check_launch()))
    return err;
  // 3. dx into the window's rows of dx0: block l-1's output cotangent
  if ((err = product_nt(dgates, a.w_ih_t + wo, dhx, a.dx0, win, rows, H,
                        4 * H, s)) ||
      (err = (int)cudaEventRecord(done, s)))
    return err;
  // 4. on the side stream, the window's share of the nine parameter
  // gradients, added in chunk order
  const ColJobs jobs{{p2, dcur, dz, p1, dy, dgates},
                     {a.dg2 + vo, a.db2 + vo, a.dbff + vo, a.dg1 + vo,
                      a.db1 + vo, a.dbg + 4 * vo},
                     {H, H, H, H, H, 4 * H}};
  if ((err = (int)cudaStreamWaitEvent(side, done, 0)) ||
      (err = colsums(jobs, cpart, rows, acc, side)) ||
      (err = reduce_window<TW>(r.y, win, nullptr, dz, a.dwff + fo, acc,
                               part, rows, H, H, side)) ||
      (err = reduce_window<TW>(xin, win, nullptr, dgates, a.dwih + wo, acc,
                               part, rows, H, 4 * H, side)) ||
      (err = reduce_window<TW>(r.rnn, win, a.h0 + so, dgates, a.dwhh + wo,
                               acc, part, rows, H, 4 * H, side)))
    return err;
  if (c == 0 && a.dw16[0] &&  // the layer's last chunk: round its dW once
      ((err = round_bf16(a.dwih + wo, a.dw16[0] + wo, (size_t)4 * H * H,
                         side)) ||
       (err = round_bf16(a.dwhh + wo, a.dw16[1] + wo, (size_t)4 * H * H,
                         side)) ||
       (err = round_bf16(a.dwff + fo, a.dw16[2] + fo, (size_t)H * H, side))))
    return err;
  return (int)cudaEventRecord(freed, side);
}

template <typename TW>
int stack_backward(const BwdArgs<TW>& a, cudaStream_t stream) {
  if (!shape_ok(a.B, a.T, a.H, a.Hr, a.L) || a.C < 1 || a.C > a.T)
    return (int)cudaErrorInvalidValue;
  const int H = a.H;
  const ChainLayout lay = chain_layout<TW>(H, true);
  const auto kernel = reverse_kernel<TW>(lay, H);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  int err = cluster_config(
      kernel, lay.cl, (unsigned)((a.B + STACK_ROWS - 1) / STACK_ROWS),
      lay.smem, cfg, attr);
  if (err) return err;
  // W_hh (4H, H) of each layer, where a chain keeps gate columns in device
  // memory, written on the caller's stream before the lanes fork
  TW* w_t = nullptr;
  if (lay.kept < 4 * (H / lay.cl)) {
    const size_t wh = (size_t)4 * H * H;
    if (bwd_w_floats(H, a.L) * sizeof(float) < a.L * wh * sizeof(TW))
      return (int)cudaErrorInvalidValue;
    w_t = reinterpret_cast<TW*>(a.ws + a.L * bwd_layer_floats(a.B, a.T, a.C,
                                                              H) +
                                PART_FLOATS + CPART_FLOATS);
    for (int l = 0; l < a.L && !err; ++l)
      err = transpose(a.w_hh_t + l * wh, w_t + l * wh, H, 4 * H, stream);
    if (err) return err;
  }
  // Enqueued a stage at a time, a stage being the chunks the layers run
  // together ((L-1, c) with (L-2, c+1), ...), bottom layer first: the side
  // stream then takes the chunks in the order they finish, and (l, c)'s
  // wait on (l+1, c), enqueued a stage before, comes before (l+1, c-1)
  // records the layer's event again.
  return on_lanes(a.L, true, 3 * a.L, stream, [&](Lanes& ln) {
    const int chunks = (a.T + a.C - 1) / a.C;
    int e = 0;
    for (int stage = 0; stage < chunks + a.L - 1 && !e; ++stage)
      for (int l = 0; l < a.L && !e; ++l) {
        const int c = chunks - 1 - stage + (a.L - 1 - l);
        if (c >= 0 && c < chunks)
          e = enqueue_bwd_chunk(a, ln, cfg, kernel, lay, w_t, l, c, chunks);
      }
    return e;
  });
}

}  // namespace

extern "C" {

// floats of scratch mixer_stack_forward_f32 needs at chunk C: per layer
// the chunk buffers and carries, and the block outputs but the top one
long long mixer_stack_workspace_floats(int B, int T, int H, int L, int C) {
  return (long long)(L * layer_floats(B, C, H, false) +
                     (size_t)(L - 1) * B * T * H);
}

// How many clusters of the forward recurrence (FP32) the card holds at
// once; -1 if it takes no such launch.
int mixer_stack_resident_clusters(int H) {
  if (!hidden_ok(H)) return -1;
  const ChainLayout lay = chain_layout<float>(H, false);
  return resident_clusters(window_kernel<float>(lay, H), lay.smem, lay.cl);
}

// CTAs per cluster of the chains at a width H the kernels take
// (cluster_for), else -1.
int mixer_stack_cluster_ctas(int H) {
  return hidden_ok(H) ? cluster_for(H) : -1;
}

// The rows of W_hh^T (forward, FP32 or bf16 != 0) or gate columns
// (backward) a chain CTA keeps in shared memory (chain_layout); -1 if no
// kernel takes H.
int mixer_stack_kept(int H, int backward, int bf) {
  if (!hidden_ok(H)) return -1;
  return bf ? chain_layout<bf16>(H, backward).kept
            : chain_layout<float>(H, backward).kept;
}

// x0 (B,T,H); w_ih_t, w_hh_t (L,H,4H); b_g (L,4H); w_ff (L,H,H);
// b_ff, g1, b1, g2, b2 (L,H); h0, c0 (L,B,H). Writes out (B,T,H),
// hn, cn (L,B,H). H: a width hidden_ok takes; Hr <= H the real width of
// a stack zero-padded to H (its LayerNorms' statistics), else H. Chunks
// of C steps. Returns 0 or the first CUDA error code.
int mixer_stack_forward_f32(
    const float* x0, const float* w_ih_t, const float* b_g,
    const float* w_hh_t, const float* w_ff, const float* b_ff,
    const float* g1, const float* b1, const float* g2, const float* b2,
    const float* h0, const float* c0, float* out, float* hn, float* cn,
    float* ws, int B, int T, int H, int Hr, int L, int C,
    void* stream_ptr) {
  return stack_forward(StackArgs<float>{x0, w_ih_t, b_g, w_hh_t, w_ff, b_ff,
                                        g1, b1, g2, b2, h0, c0, out, hn, cn,
                                        nullptr, ws, B, T, H, Hr, L, C},
                       (cudaStream_t)stream_ptr);
}

// The inference forward in the bf16 operand mode: w_ih_t, w_hh_t and w_ff
// bf16, the rest and the scratch (mixer_stack_workspace_floats: the chunk
// buffers hold FP32 whatever the weights) as mixer_stack_forward_f32.
int mixer_stack_forward_bf16(
    const float* x0, const bf16* w_ih_t, const float* b_g,
    const bf16* w_hh_t, const bf16* w_ff, const float* b_ff,
    const float* g1, const float* b1, const float* g2, const float* b2,
    const float* h0, const float* c0, float* out, float* hn, float* cn,
    float* ws, int B, int T, int H, int Hr, int L, int C,
    void* stream_ptr) {
  return stack_forward(StackArgs<bf16>{x0, w_ih_t, b_g, w_hh_t, w_ff, b_ff,
                                       g1, b1, g2, b2, h0, c0, out, hn, cn,
                                       nullptr, ws, B, T, H, Hr, L, C},
                       (cudaStream_t)stream_ptr);
}

// floats of the training forward's residuals: RES_PLANES planes a block,
// the top block's output plane left out
long long mixer_stack_residual_floats(int B, int T, int H, int L) {
  return (long long)(RES_PLANES * L - 1) * B * T * H;
}

// floats of the training forward's scratch at chunk C: per layer the xw
// chunk buffer and the carries
long long mixer_stack_train_workspace_floats(int B, int T, int H, int L,
                                             int C) {
  return (long long)(L * layer_floats(B, C, H, true));
}

// As mixer_stack_forward_f32, and writes the residuals into res.
int mixer_stack_train_forward_f32(
    const float* x0, const float* w_ih_t, const float* b_g,
    const float* w_hh_t, const float* w_ff, const float* b_ff,
    const float* g1, const float* b1, const float* g2, const float* b2,
    const float* h0, const float* c0, float* out, float* hn, float* cn,
    float* res, float* ws, int B, int T, int H, int Hr, int L, int C,
    void* stream_ptr) {
  return stack_forward(StackArgs<float>{x0, w_ih_t, b_g, w_hh_t, w_ff, b_ff,
                                        g1, b1, g2, b2, h0, c0, out, hn, cn,
                                        res, ws, B, T, H, Hr, L, C},
                       (cudaStream_t)stream_ptr);
}

// The training forward in the bf16 operand mode: w_ih_t, w_hh_t and w_ff
// bf16, the rest as mixer_stack_train_forward_f32.
int mixer_stack_train_forward_bf16(
    const float* x0, const bf16* w_ih_t, const float* b_g,
    const bf16* w_hh_t, const bf16* w_ff, const float* b_ff,
    const float* g1, const float* b1, const float* g2, const float* b2,
    const float* h0, const float* c0, float* out, float* hn, float* cn,
    float* res, float* ws, int B, int T, int H, int Hr, int L, int C,
    void* stream_ptr) {
  return stack_forward(StackArgs<bf16>{x0, w_ih_t, b_g, w_hh_t, w_ff, b_ff,
                                       g1, b1, g2, b2, h0, c0, out, hn, cn,
                                       res, ws, B, T, H, Hr, L, C},
                       (cudaStream_t)stream_ptr);
}

// floats of scratch mixer_stack_backward_f32 needs at chunk C: per layer
// the chunk buffers (one or two slots of B * C rows) and the carries; the
// split-K partials
long long mixer_stack_backward_workspace_floats(int B, int T, int H, int L,
                                                int C) {
  return (long long)(L * bwd_layer_floats(B, T, C, H) + PART_FLOATS +
                     CPART_FLOATS + bwd_w_floats(H, L));
}

// Cotangents dout (B,T,H), dhn, dcn (L,B,H) -> dx0 (B,T,H), dh0, dc0
// (L,B,H) and the nine parameter gradients in the parameters' layouts.
// Chunks of C steps. dx0 must not overlap dout.
int mixer_stack_backward_f32(
    const float* x0, const float* w_ih_t, const float* w_hh_t,
    const float* w_ff, const float* g1, const float* g2, const float* h0,
    const float* c0, const float* res, const float* dout, const float* dhn,
    const float* dcn, float* dx0, float* dh0, float* dc0, float* dwih,
    float* dbg, float* dwhh, float* dwff, float* dbff, float* dg1,
    float* db1, float* dg2, float* db2, float* ws, int B, int T, int H,
    int Hr, int L, int C, void* stream_ptr) {
  return stack_backward(
      BwdArgs<float>{x0, w_ih_t, w_hh_t, w_ff, g1, g2, h0, c0, res, dout, dhn,
                     dcn, dx0, dh0, dc0, dwih, dbg, dwhh, dwff, dbff, dg1,
                     db1, dg2, db2, ws, B, T, H, Hr, L, C, {}},
      (cudaStream_t)stream_ptr);
}

// floats of the bf16 mode's FP32 weight-gradient sums (dW_ih, dW_hh,
// dW_ff of every layer), beside mixer_stack_backward_workspace_floats
long long mixer_stack_backward_bf16_sum_floats(int H, int L) {
  return (long long)L * 9 * H * H;
}

// The backward in the bf16 operand mode: w_ih_t, w_hh_t, w_ff bf16, and
// so dwih, dwhh, dwff (rounded once from their FP32 sums, kept in dw32,
// mixer_stack_backward_bf16_sum_floats); the rest as
// mixer_stack_backward_f32.
int mixer_stack_backward_bf16(
    const float* x0, const bf16* w_ih_t, const bf16* w_hh_t,
    const bf16* w_ff, const float* g1, const float* g2, const float* h0,
    const float* c0, const float* res, const float* dout, const float* dhn,
    const float* dcn, float* dx0, float* dh0, float* dc0, bf16* dwih,
    float* dbg, bf16* dwhh, bf16* dwff, float* dbff, float* dg1, float* db1,
    float* dg2, float* db2, float* ws, float* dw32, int B, int T, int H,
    int Hr, int L, int C, void* stream_ptr) {
  const size_t w4 = (size_t)L * 4 * H * H;
  return stack_backward(
      BwdArgs<bf16>{x0, w_ih_t, w_hh_t, w_ff, g1, g2, h0, c0, res, dout, dhn,
                    dcn, dx0, dh0, dc0, dw32, dbg, dw32 + w4, dw32 + 2 * w4,
                    dbff, dg1, db1, dg2, db2, ws, B, T, H, Hr, L, C,
                    {dwih, dwhh, dwff}},
      (cudaStream_t)stream_ptr);
}

}  // extern "C"
