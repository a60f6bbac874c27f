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
// fraction of a millisecond at the card's FP32 rate; the per-step latency
// times T is what counts. The design is the one recurrence core of the
// port's LSTM kernels (lstm_cluster.cuh, lstm_cluster_bwd.cuh): a
// persistent cluster of 8 CTAs per 16 batch rows holds W_hh in shared
// memory (CTA r the 4H/8 gate columns of hidden units [r H/8, (r+1) H/8)),
// h goes to every CTA through distributed shared memory, one cluster
// barrier per step. Rows past B in the last cluster run on zeros and are
// never stored, and T is not padded, so any B >= 1 and T >= 1 give exact
// h_n and c_n.
//
// Residuals: the JAX forward under grad saves the gate pre-activations;
// this one saves the activations [i, f, g, o] and the cell states (the
// layout K7 saves), so the reverse chain needs no transcendental but
// tanh(c_t). It computes the same function with other residuals.
//
// dW_hh^T = sum over (b, t) of h_{t-1}^T dgates_t, with h_{-1} = h0, is the
// deterministic split-K reduction of lstm_cluster_bwd.cuh over all B*T
// rows in FP32 (no tensor cores: the JAX package needs HIGHEST precision
// there, as the sum cancels heavily).

#include "lstm_cluster_bwd.cuh"

extern "C" {

// xw (B,T,4H); w_hh_t (H,4H); h0, c0 (B,H). Writes ys (B,T,H), hn, cn
// (B,H) and, when acts/cs are not null, the training residuals acts
// (B,T,4H) = [i, f, g, o] and cs (B,T,H).
int lstm_recurrence_forward_f32(const float* xw, const float* w_hh_t,
                                const float* h0, const float* c0, float* ys,
                                float* hn, float* cn, float* acts, float* cs,
                                int B, int T, int H, void* stream_ptr) {
  if (!hidden_ok(H) || B <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  return launch_cluster(lstm_cluster_kernel<BT>, lstm_smem_bytes(H, BT), B,
                        BT, (cudaStream_t)stream_ptr, xw, w_hh_t, h0, c0, ys,
                        hn, cn, acts, cs, B, T, H);
}

// floats of backward scratch: the split-K partials of dW_hh
long long lstm_recurrence_backward_workspace_floats(int B, int T, int H) {
  return (long long)PART_FLOATS;
}

// From the forward's ys, acts, cs and the cotangents dys (B,T,H), dhn,
// dcn (B,H): dxw (B,T,4H) = the dgates trajectory, dw_hh_t (H,4H), dh0,
// dc0 (B,H).
int lstm_recurrence_backward_f32(const float* w_hh_t, const float* h0,
                                 const float* c0, const float* ys,
                                 const float* acts, const float* cs,
                                 const float* dys, const float* dhn,
                                 const float* dcn, float* dxw, float* dwhh,
                                 float* dh0, float* dc0, float* ws, int B,
                                 int T, int H, void* stream_ptr) {
  if (!hidden_ok(H) || B <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int err = launch_cluster(lstm_cluster_bwd_kernel<BT>,
                           lstm_bwd_smem_bytes(H, BT), B, BT, stream, acts,
                           cs, c0, dys, w_hh_t, dhn, dcn,
                           (const float*)nullptr, dxw, dh0, dc0,
                           (float*)nullptr, B, T, H, 0, T);
  if (err) return err;
  return reduce_rows_tn(ys, h0, T, dxw, dwhh, ws, B * T, H, 4 * H, stream);
}

}  // extern "C"
