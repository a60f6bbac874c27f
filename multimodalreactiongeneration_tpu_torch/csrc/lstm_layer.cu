// One LSTM layer (input projection + recurrence), forward and backward.
//
// Replaces, in multimodalreactiongeneration_tpu/ops/pallas_lstm.py
// (lstm_layer):
//   lstm_layer_forward_f32, residuals on    _fwd_kernel_acts   (_layer_vjp_fwd)
//   lstm_layer_forward_f32, residuals off   _fwd_kernel        (the primal)
//   lstm_layer_backward_f32                 _bwd_kernel_layer  (_layer_vjp_bwd)
//
// It is one block of the encoder stack (csrc/mixer_stack.cu) without the
// LayerNorm/Dense tail, and runs the same building blocks: the tiled
// FP32 GEMM for x @ W_ih^T + b over all B*T rows, the 8-CTA cluster
// recurrence with W_hh in shared memory (forward: h broadcast through
// distributed shared memory; backward: partial dh products reduced
// through it), and split-K reductions for dW_ih, dW_hh and db. What
// bounds it is the same: the per-step latency of the recurrence times T.
// See lstm_cluster.cuh and lstm_cluster_bwd.cuh.

#include "lstm_cluster_bwd.cuh"

extern "C" {

// floats of forward scratch: xw (B, T, 4H)
long long lstm_layer_workspace_floats(int B, int T, int H) {
  return (long long)B * T * 4 * H;
}

// x (B,T,Din); w_ih_t (Din,4H); b (4H); w_hh_t (H,4H); h0, c0 (B,H).
// Writes ys (B,T,H), hn, cn (B,H) and, when acts/cs are not null, the
// training residuals acts (B,T,4H) = [i, f, g, o] and cs (B,T,H).
int lstm_layer_forward_f32(const float* x, const float* w_ih_t,
                           const float* b, const float* w_hh_t,
                           const float* h0, const float* c0, float* ys,
                           float* hn, float* cn, float* acts, float* cs,
                           float* ws, int B, int T, int Din, int H,
                           void* stream_ptr) {
  if (!hidden_ok(H) || B <= 0 || T <= 0 || Din <= 0)
    return (int)cudaErrorInvalidValue;
  return lstm_forward(x, Din, w_ih_t, b, w_hh_t, h0, c0, ws, ys, hn, cn,
                      acts, cs, B, T, H, (cudaStream_t)stream_ptr);
}

// floats of backward scratch: dgates (B, T, 4H) and split-K partials
long long lstm_layer_backward_workspace_floats(int B, int T, int H) {
  return (long long)B * T * 4 * H + (long long)(PART_FLOATS + CPART_FLOATS);
}

// Cotangents dys (B,T,H), dhn, dcn (B,H) -> dx (B,T,Din), dw_ih_t
// (Din,4H), db (4H), dw_hh_t (H,4H), dh0, dc0 (B,H).
int lstm_layer_backward_f32(const float* x, const float* w_ih_t,
                            const float* w_hh_t, const float* h0,
                            const float* c0, const float* ys,
                            const float* acts, const float* cs,
                            const float* dys, const float* dhn,
                            const float* dcn, float* dx, float* dwih,
                            float* db, float* dwhh, float* dh0, float* dc0,
                            float* ws, int B, int T, int Din, int H,
                            void* stream_ptr) {
  if (!hidden_ok(H) || B <= 0 || T <= 0 || Din <= 0)
    return (int)cudaErrorInvalidValue;
  float* dgates = ws;
  float* part = dgates + (size_t)B * T * 4 * H;
  return lstm_backward(x, Din, w_ih_t, w_hh_t, h0, c0, ys, acts, cs, dys,
                       dhn, dcn, nullptr, dx, dwih, db, dwhh, dh0, dc0,
                       dgates, part, part + PART_FLOATS, B, T, H,
                       (cudaStream_t)stream_ptr);
}

}  // extern "C"
