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
// fill the card, so the time is the per-step latency times L*T. The
// input projection and the block tail are parallel over all B*T rows
// and are bounded by FP32 FMA throughput (about 110 GFLOP at the audio
// encoder shape B16 x T2096 x L5); the backward adds three such
// products per block (dW_ih, dW_hh, dx) and the Dense's two.
//
// Design (layer-major, simple first; building blocks in lstm_cluster.cuh
// and lstm_cluster_bwd.cuh):
//   1. gemm_kernel: x_l @ W_ih + (b_ih + b_hh) for all B*T rows, a
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
//   3. add_ln_kernel + gemm_kernel + add_ln_kernel: the block tail,
//      LN(h + x) -> Dense -> LN(z + y), parallel over rows.
// The training forward is the same launch sequence, writing per block
// the residuals the backward reads (RES_PLANES below); the TPU kernel's
// A/M residuals become A = [i, f, g, o] and the cell states. The
// backward runs the blocks top to bottom: the tail backward (row-
// parallel LN backward, dW_ff = y^T dz and the LN scale/bias sums as
// split-K reductions over all rows, dy = dz @ W_ff^T + dz), then the
// reverse cluster recurrence (the partial dh products reduced across
// the 8 CTAs through distributed shared memory), then dW_ih, dW_hh, db
// and dx by split-K reductions and a GEMM. Unlike the TPU kernel,
// dgates go through device memory.
// The sequential chain is L*T cell steps each way. The TPU kernel's
// chunk-lag wavefront (T + (L-1)*8 steps) is later work.

#include "lstm_cluster_bwd.cuh"

namespace {

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

// res null: the inference forward, everything per block in ws
int stack_forward(const float* x0, const float* w_ih_t, const float* b_g,
                  const float* w_hh_t, const float* w_ff, const float* b_ff,
                  const float* g1, const float* b1, const float* g2,
                  const float* b2, const float* h0, const float* c0,
                  float* out, float* hn, float* cn, float* res, float* ws,
                  int B, int T, int H, int L, cudaStream_t stream) {
  if (!shape_ok(B, T, H, L)) return (int)cudaErrorInvalidValue;
  const size_t rows = (size_t)B * T;
  const size_t bth = rows * H;
  float* xw = ws;
  float* scratch = xw + 4 * bth;  // rnn, y, z and two block outputs
  int err;
  const float* xin = x0;
  for (int l = 0; l < L; ++l) {
    const size_t wo = (size_t)l * H * 4 * H;
    const size_t so = (size_t)l * B * H;
    const size_t vo = (size_t)l * H;
    BlockRes r = res ? block_res(res, bth, l)
                     : BlockRes{scratch, nullptr, nullptr, scratch + bth,
                                scratch + 2 * bth,
                                scratch + (3 + l % 2) * bth};
    if ((err = lstm_forward(xin, H, w_ih_t + wo, b_g + 4 * vo, w_hh_t + wo,
                            h0 + so, c0 + so, xw, r.rnn, hn + so, cn + so,
                            r.acts, r.cs, B, T, H, stream)))
      return err;
    if ((err = add_ln(r.rnn, xin, g1 + vo, b1 + vo, r.y, rows, H, stream)))
      return err;
    if ((err = gemm(r.y, w_ff + (size_t)l * H * H, b_ff + vo, nullptr, r.z,
                    (int)rows, H, H, false, stream)))
      return err;
    float* xout = (l == L - 1) ? out : r.out;
    if ((err = add_ln(r.z, r.y, g2 + vo, b2 + vo, xout, rows, H, stream)))
      return err;
    xin = xout;
  }
  return 0;
}

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
  return stack_forward(x0, w_ih_t, b_g, w_hh_t, w_ff, b_ff, g1, b1, g2, b2,
                       h0, c0, out, hn, cn, nullptr, ws, B, T, H, L,
                       (cudaStream_t)stream_ptr);
}

// floats of the training forward's residuals and scratch (xw)
long long mixer_stack_residual_floats(int B, int T, int H, int L) {
  return (long long)L * RES_PLANES * B * T * H;
}

long long mixer_stack_train_workspace_floats(int B, int T, int H) {
  return (long long)B * T * 4 * H;
}

// As mixer_stack_forward_f32, and writes the residuals into res.
int mixer_stack_train_forward_f32(
    const float* x0, const float* w_ih_t, const float* b_g,
    const float* w_hh_t, const float* w_ff, const float* b_ff,
    const float* g1, const float* b1, const float* g2, const float* b2,
    const float* h0, const float* c0, float* out, float* hn, float* cn,
    float* res, float* ws, int B, int T, int H, int L, void* stream_ptr) {
  return stack_forward(x0, w_ih_t, b_g, w_hh_t, w_ff, b_ff, g1, b1, g2, b2,
                       h0, c0, out, hn, cn, res, ws, B, T, H, L,
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
