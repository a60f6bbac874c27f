// Recurrent-mixer block stack: inference forward, training forward and
// backward.
//
// Replaces, in multimodalreactiongeneration_tpu/ops/pallas_mixer_stack.py
// (mixer_stack_recurrence):
//   mixer_stack_forward_f32         _fwd_kernel_light  (the primal)
//   mixer_stack_train_forward_f32   _fwd_kernel        (_vjp_fwd)
//   mixer_stack_backward_f32        _bwd_kernel        (_vjp_bwd)
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
// products per block (dW_ih, dW_hh, dx) and the Dense's two.
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
// Backward design (layer-major, lstm_cluster_bwd.cuh): the blocks top to
// bottom: the tail backward (row-parallel LN backward, dW_ff = y^T dz
// and the LN scale/bias sums as split-K reductions over all rows, dy =
// dz @ W_ff^T + dz), then the reverse cluster recurrence (the partial dh
// products reduced across the 8 CTAs through distributed shared memory),
// then dW_ih, dW_hh, db and dx by split-K reductions and a GEMM. Unlike
// the TPU kernel, dgates go through device memory. Its chain is L*T cell
// steps; the chunk schedule for it is later work.

#include <mutex>
#include <vector>

#include "lstm_cluster_bwd.cuh"

namespace {

// batch rows per cluster of the forward recurrence (ops/mixer_stack.py
// ROWS)
constexpr int STACK_ROWS = 16;

// Residuals of the training forward, per block l, each a (B, T, H)
// plane except the 4-plane gate activations: h trajectory, A = [i, f, g,
// o], cell states, y = LN(h + x), z = y @ W_ff + b_ff, and the block's
// output (the next block's input; unused for the top block).
constexpr int RES_PLANES = 9;

struct BlockRes {
  float *rnn, *acts, *cs, *y, *z, *out;
};

BlockRes block_res(float* res, size_t bth, int l) {
  float* p = res + (size_t)l * RES_PLANES * bth;
  return {p, p + bth, p + 5 * bth, p + 6 * bth, p + 7 * bth, p + 8 * bth};
}

bool shape_ok(int B, int T, int H, int L) {
  return hidden_ok(H) && B > 0 && T > 0 && L > 0;
}

const auto window_kernel = lstm_window_kernel<STACK_ROWS>;

// Scratch of the forward per layer: the xw chunk buffer (4H per row of a
// chunk), the inference forward's LSTM output, y and z chunk buffers (H
// each), and two (h, c) carries (B, H) each
size_t layer_floats(int B, int C, int H, bool train) {
  return (size_t)B * C * H * (train ? 4 : 7) + 4 * (size_t)B * H;
}

// The layer streams of one device, made once and kept; one stack
// forward enqueues at a time (the events are reused call after call).
struct Lanes {
  std::vector<cudaStream_t> streams;
  std::vector<cudaEvent_t> done;  // the last chunk enqueued on each
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
    if ((err = (int)cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking)))
      return err;
    if ((err = (int)cudaEventCreateWithFlags(&e, cudaEventDisableTiming))) {
      cudaStreamDestroy(s);
      return err;
    }
    ln.streams.push_back(s);
    ln.done.push_back(e);
  }
  *out = &ln;
  return 0;
}

struct StackArgs {
  const float *x0, *w_ih_t, *b_g, *w_hh_t, *w_ff, *b_ff, *g1, *b1, *g2, *b2,
      *h0, *c0;
  float *out, *hn, *cn, *res, *ws;
  int B, T, H, L, C;
};

// Enqueue chunk c of every layer, each on its stream after (l-1, c).
int enqueue_chunk(const StackArgs& a, Lanes& ln, size_t smem, int c) {
  const int B = a.B, T = a.T, H = a.H, C = a.C;
  const bool train = a.res != nullptr;
  const size_t bth = (size_t)B * T * H, bh = (size_t)B * H;
  const int t0 = c * C, n = T - t0 < C ? T - t0 : C, rows = B * n;
  const bool last = t0 + n == T;
  const RowMap win{T, t0, n}, dense{n, 0, n};
  float* planes = a.ws + a.L * layer_floats(B, C, H, train);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      cluster_config((unsigned)((B + STACK_ROWS - 1) / STACK_ROWS), smem,
                     attr);
  int err;
  for (int l = 0; l < a.L; ++l) {
    cudaStream_t s = ln.streams[l];
    if (l > 0 && (err = (int)cudaStreamWaitEvent(s, ln.done[l - 1], 0)))
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
    if ((err = gemm_rows(xin, win, a.w_ih_t + wo, a.b_g + 4 * vo, xw, dense,
                         rows, 4 * H, H, s)))
      return err;
    cfg.stream = s;
    if ((err = (int)cudaLaunchKernelEx(
             &cfg, window_kernel, (const float*)xw, a.w_hh_t + wo, h_in, c_in,
             r.rnn, h_out, c_out, r.acts, r.cs, B, m.T, H, m.t0, n)))
      return err;
    if ((err = check_launch())) return err;
    if ((err = add_ln(r.rnn, m, xin, win, a.g1 + vo, a.b1 + vo, r.y, m, rows,
                      H, s)))
      return err;
    if ((err = gemm_rows(r.y, m, a.w_ff + (size_t)l * H * H, a.b_ff + vo, r.z,
                         m, rows, H, H, s)))
      return err;
    if ((err = add_ln(r.z, m, r.y, m, a.g2 + vo, a.b2 + vo, xout, win, rows,
                      H, s)))
      return err;
    if ((err = (int)cudaEventRecord(ln.done[l], s))) return err;
  }
  return 0;
}

int stack_forward(const StackArgs& a, cudaStream_t stream) {
  if (!shape_ok(a.B, a.T, a.H, a.L) || a.C < 1 || a.C > a.T)
    return (int)cudaErrorInvalidValue;
  const size_t smem = lstm_smem_bytes(a.H, STACK_ROWS);
  int err = (int)cudaFuncSetAttribute(
      window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  std::lock_guard<std::mutex> lock(lanes_mutex);
  Lanes* ln;
  if ((err = lanes_for(a.L, &ln))) return err;
  if ((err = (int)cudaEventRecord(ln->fork, stream))) return err;
  for (int l = 0; l < a.L; ++l)
    if ((err = (int)cudaStreamWaitEvent(ln->streams[l], ln->fork, 0)))
      return err;
  const int chunks = (a.T + a.C - 1) / a.C;
  for (int c = 0; c < chunks && !err; ++c)
    err = enqueue_chunk(a, *ln, smem, c);
  // join, also after an error: the caller's stream waits on every layer
  for (int l = 0; l < a.L; ++l) {
    int e = (int)cudaEventRecord(ln->done[l], ln->streams[l]);
    if (!e) e = (int)cudaStreamWaitEvent(stream, ln->done[l], 0);
    if (!err) err = e;
  }
  return err;
}

}  // namespace

extern "C" {

// floats of scratch mixer_stack_forward_f32 needs at chunk C: per layer
// the chunk buffers and carries, and the block outputs but the top one
long long mixer_stack_workspace_floats(int B, int T, int H, int L, int C) {
  return (long long)(L * layer_floats(B, C, H, false) +
                     (size_t)(L - 1) * B * T * H);
}

// How many clusters of the forward recurrence the card holds at once;
// -1 if it takes no such launch.
int mixer_stack_resident_clusters(int H) {
  if (!hidden_ok(H)) return -1;
  return resident_clusters(window_kernel, lstm_smem_bytes(H, STACK_ROWS));
}

// x0 (B,T,H); w_ih_t, w_hh_t (L,H,4H); b_g (L,4H); w_ff (L,H,H);
// b_ff, g1, b1, g2, b2 (L,H); h0, c0 (L,B,H). Writes out (B,T,H),
// hn, cn (L,B,H). Chunks of C steps. Returns 0 or the first CUDA error
// code.
int mixer_stack_forward_f32(
    const float* x0, const float* w_ih_t, const float* b_g,
    const float* w_hh_t, const float* w_ff, const float* b_ff,
    const float* g1, const float* b1, const float* g2, const float* b2,
    const float* h0, const float* c0, float* out, float* hn, float* cn,
    float* ws, int B, int T, int H, int L, int C, void* stream_ptr) {
  return stack_forward({x0, w_ih_t, b_g, w_hh_t, w_ff, b_ff, g1, b1, g2, b2,
                        h0, c0, out, hn, cn, nullptr, ws, B, T, H, L, C},
                       (cudaStream_t)stream_ptr);
}

// floats of the training forward's residuals
long long mixer_stack_residual_floats(int B, int T, int H, int L) {
  return (long long)L * RES_PLANES * B * T * H;
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
    float* res, float* ws, int B, int T, int H, int L, int C,
    void* stream_ptr) {
  return stack_forward({x0, w_ih_t, b_g, w_hh_t, w_ff, b_ff, g1, b1, g2, b2,
                        h0, c0, out, hn, cn, res, ws, B, T, H, L, C},
                       (cudaStream_t)stream_ptr);
}

// dgates (4H), the LN backward's dr and xhat, the tail's dy and the
// cotangent handed to the block below (H each) per row, plus the
// split-K partials
long long mixer_stack_backward_workspace_floats(int B, int T, int H) {
  return (long long)B * T * 8 * H + (long long)(PART_FLOATS + CPART_FLOATS);
}

// Cotangents dout (B,T,H), dhn, dcn (L,B,H) -> dx0 (B,T,H), dh0, dc0
// (L,B,H) and the nine parameter gradients in the parameters' layouts.
int mixer_stack_backward_f32(
    const float* x0, const float* w_ih_t, const float* w_hh_t,
    const float* w_ff, const float* g1, const float* g2, const float* h0,
    const float* c0, const float* res, const float* dout, const float* dhn,
    const float* dcn, float* dx0, float* dh0, float* dc0, float* dwih,
    float* dbg, float* dwhh, float* dwff, float* dbff, float* dg1,
    float* db1, float* dg2, float* db2, float* ws, int B, int T, int H,
    int L, void* stream_ptr) {
  if (!shape_ok(B, T, H, L)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const size_t rows = (size_t)B * T;
  const size_t bth = rows * H;
  const int R = (int)rows;
  float* dgates = ws;
  float* dr = dgates + 4 * bth;
  float* xhat = dr + bth;
  float* dy = xhat + bth;
  float* dnext = dy + bth;
  float* part = dnext + bth;
  float* cpart = part + PART_FLOATS;
  int err;
  for (int l = L - 1; l >= 0; --l) {
    const size_t wo = (size_t)l * H * 4 * H;
    const size_t so = (size_t)l * B * H;
    const size_t vo = (size_t)l * H;
    const BlockRes r = block_res(const_cast<float*>(res), bth, l);
    const float* xin = l == 0 ? x0 : block_res(const_cast<float*>(res), bth,
                                               l - 1).out;
    const float* dcur = l == L - 1 ? dout : dnext;
    // out = LN2(z + y): dz (= dr), the LN2 scale and bias sums
    if ((err = ln_bwd(dcur, r.z, r.y, g2 + vo, dr, xhat, rows, H, stream)))
      return err;
    if ((err = colsum(dcur, xhat, dg2 + vo, cpart, R, H, stream))) return err;
    if ((err = colsum(dcur, nullptr, db2 + vo, cpart, R, H, stream)))
      return err;
    if ((err = colsum(dr, nullptr, dbff + vo, cpart, R, H, stream)))
      return err;
    // z = y @ W_ff + b_ff, and y also feeds the residual
    if ((err = reduce_rows_tn(r.y, nullptr, 0, dr, dwff + (size_t)l * H * H,
                              part, R, H, H, stream)))
      return err;
    if ((err = gemm(dr, w_ff + (size_t)l * H * H, nullptr, dr, dy, R, H, H,
                    true, stream)))
      return err;
    // y = LN1(h + x): dr becomes the cotangent of h and of x
    if ((err = ln_bwd(dy, r.rnn, xin, g1 + vo, dr, xhat, rows, H, stream)))
      return err;
    if ((err = colsum(dy, xhat, dg1 + vo, cpart, R, H, stream))) return err;
    if ((err = colsum(dy, nullptr, db1 + vo, cpart, R, H, stream)))
      return err;
    if ((err = lstm_backward(xin, H, w_ih_t + wo, w_hh_t + wo, h0 + so,
                             c0 + so, r.rnn, r.acts, r.cs, dr, dhn + so,
                             dcn + so, dr, l == 0 ? dx0 : dnext, dwih + wo,
                             dbg + 4 * vo, dwhh + wo, dh0 + so, dc0 + so,
                             dgates, part, cpart, B, T, H, stream)))
      return err;
  }
  return 0;
}

}  // extern "C"
