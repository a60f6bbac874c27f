// One LSTM layer (input projection + recurrence), forward and backward.
//
// Replaces, in multimodalreactiongeneration_tpu/ops/pallas_lstm.py
// (lstm_layer):
//   lstm_layer_forward_f32, residuals on    _fwd_kernel_acts   (_layer_vjp_fwd)
//   lstm_layer_forward_f32, residuals off   _fwd_kernel        (the primal)
//   lstm_layer_backward_f32                 _bwd_kernel_layer  (_layer_vjp_bwd)
// and the same three in JAX's bf16 operand mode (bf16 x, W_ih and W_hh):
//   lstm_layer_forward_bf16, lstm_layer_backward_bf16
//
// Forward. As in JAX, whose Pallas call takes xw = x W_ih^T + b from
// XLA, the wrapper (ops/lstm_layer.py) computes xw with one FP32
// torch.addmm and this file runs the recurrence on it: the 8-CTA cluster
// of lstm_cluster.cuh, W_hh split over the cluster's shared memory, h
// broadcast through distributed shared memory, one cluster barrier per
// step. (tc_gemm.cuh's 3xTF32 GEMM took this product in 0.41 ms at B256
// x T140, 256 -> 1024, against 0.43-0.46 ms for torch.addmm, in turns on
// an NVIDIA H100 80GB HBM3 at 700 W; but its error, carried through the
// flagship Metaformer's training step, moved a gradient by 1.3e-3 of its
// largest magnitude against the MRGEN_FUSED_DW=0 path's FP32 product,
// where torch.addmm moves it by 6e-6.)
//
// Backward. The reverse cluster recurrence (lstm_cluster_bwd.cuh) writes
// the dgates trajectory, loading each step's dy, gate activations and
// cell states during the step before; dW_ih^T = x^T dgates and
// dW_hh^T = h_prev^T dgates are split-K reductions on the tensor cores in
// 3xTF32 (tc_gemm.cuh), dx = dgates W_ih the same product as one tiled
// GEMM, db an FP32 column sum.
//
// Rows per cluster. Both chains take R batch rows per cluster, R in
// {16, 24, 32}, chosen by the wrapper: the smallest R whose ceil(B / R)
// clusters the card holds at once (lstm_layer_resident_clusters). At H256
// a CTA needs 168 / 188 / 208 KB (R 16 / 24 / 32) forward and the same
// backward, one CTA per SM, and an H100 holds 15 such clusters: B256 at
// R 16 (16 clusters) ran its last cluster's whole chain in a second wave;
// at R 24 it is 11 clusters, one wave. H128 (53 KB at R 16) keeps R 16.
//
// What bounds it: the chain, T dependent steps of a cluster barrier and
// an (R x H) x (H x H/2) FP32 product per CTA; the FLOP bound of the
// whole layer at 67 TFLOP/s is far below it. The per-step products on the
// tensor cores are later work.
//
// The bf16 operand mode. The wrapper computes xw in FP32 from x and W_ih
// converted exactly (JAX's f32 einsum of bf16 operands). The chains are
// the same kernels instantiated on bf16 weights (lstm_cluster.cuh,
// lstm_cluster_bwd.cuh): W_hh's slice held as bf16 (the CTA needs 64 KB
// less at H256), h and the backward's dgates rounded to bf16 at the
// product, FP32 state and sums. dx, dW_ih and dW_hh take bf16 operands
// in one mma.sync.m16n8k16 pass each (bf16_gemm.cuh) where the FP32 mode
// takes three TF32 passes; dW and dx come back bf16, db FP32 from the
// unrounded dgates.

#include "bf16_gemm.cuh"
#include "tc_gemm.cuh"

namespace {

template <typename TW>
using LayerFwd = decltype(&lstm_cluster_kernel<BT, TW>);
template <typename TW>
using LayerBwd = decltype(&lstm_cluster_bwd_kernel<BT, TW>);

template <typename TW>
LayerFwd<TW> layer_fwd(int R) {
  switch (R) {
    case 16: return lstm_cluster_kernel<16, TW>;
    case 24: return lstm_cluster_kernel<24, TW>;
    case 32: return lstm_cluster_kernel<32, TW>;
  }
  return nullptr;
}

template <typename TW>
LayerBwd<TW> layer_bwd(int R) {
  switch (R) {
    case 16: return lstm_cluster_bwd_kernel<16, TW>;
    case 24: return lstm_cluster_bwd_kernel<24, TW>;
    case 32: return lstm_cluster_bwd_kernel<32, TW>;
  }
  return nullptr;
}

template <typename TW>
int resident(int H, int backward, int R, size_t smem) {
  return backward ? resident_clusters(layer_bwd<TW>(R), smem)
                  : resident_clusters(layer_fwd<TW>(R), smem);
}

template <typename TW>
int layer_forward(const float* xw, const TW* w_hh_t, const float* h0,
                  const float* c0, float* ys, float* hn, float* cn,
                  float* acts, float* cs, int B, int T, int H, int R,
                  void* stream_ptr) {
  const LayerFwd<TW> kernel = layer_fwd<TW>(R);
  if (!kernel || !hidden_ok(H) || B <= 0 || T <= 0)
    return (int)cudaErrorInvalidValue;
  return launch_cluster(kernel, lstm_smem_bytes(H, R, (int)sizeof(TW)), B, R,
                        (cudaStream_t)stream_ptr, xw, w_hh_t, h0, c0, ys, hn,
                        cn, acts, cs, B, T, H);
}

}  // namespace

extern "C" {

// shared memory of one CTA of the forward (backward) chain at R rows, of
// the FP32 or (bf16 != 0) the bf16 mode
long long lstm_layer_smem_bytes(int H, int backward, int R, int bf) {
  const int wb = bf ? 2 : 4;
  return (long long)(backward ? lstm_bwd_smem_bytes(H, R, wb)
                              : lstm_smem_bytes(H, R, wb));
}

// How many clusters of the forward (backward) chain of one mode at R rows
// the card holds at once; -1 if it takes no such launch.
int lstm_layer_resident_clusters(int H, int backward, int R, int bf) {
  if (!hidden_ok(H)) return -1;
  const size_t smem = (size_t)lstm_layer_smem_bytes(H, backward, R, bf);
  return bf ? resident<bf16>(H, backward, R, smem)
              : resident<float>(H, backward, R, smem);
}

// xw (B,T,4H) = x W_ih^T + b; w_hh_t (H,4H); h0, c0 (B,H). Writes ys
// (B,T,H), hn, cn (B,H) and, when acts/cs are not null, the training
// residuals acts (B,T,4H) = [i, f, g, o] and cs (B,T,H). R rows per
// cluster.
int lstm_layer_forward_f32(const float* xw, const float* w_hh_t,
                           const float* h0, const float* c0, float* ys,
                           float* hn, float* cn, float* acts, float* cs,
                           int B, int T, int H, int R, void* stream_ptr) {
  return layer_forward(xw, w_hh_t, h0, c0, ys, hn, cn, acts, cs, B, T, H, R,
                       stream_ptr);
}

// The same in the bf16 mode: w_hh_t bf16, the rest FP32.
int lstm_layer_forward_bf16(const float* xw, const bf16* w_hh_t,
                            const float* h0, const float* c0, float* ys,
                            float* hn, float* cn, float* acts, float* cs,
                            int B, int T, int H, int R, void* stream_ptr) {
  return layer_forward(xw, w_hh_t, h0, c0, ys, hn, cn, acts, cs, B, T, H, R,
                       stream_ptr);
}

// floats of backward scratch: dgates (B, T, 4H) and split-K partials
long long lstm_layer_backward_workspace_floats(int B, int T, int H) {
  return (long long)B * T * 4 * H + (long long)(PART_FLOATS + CPART_FLOATS);
}

// Cotangents dys (B,T,H), dhn, dcn (B,H) -> dx (B,T,Din), dw_ih_t
// (Din,4H), db (4H), dw_hh_t (H,4H), dh0, dc0 (B,H). R rows per cluster.
int lstm_layer_backward_f32(const float* x, const float* w_ih_t,
                            const float* w_hh_t, const float* h0,
                            const float* c0, const float* ys,
                            const float* acts, const float* cs,
                            const float* dys, const float* dhn,
                            const float* dcn, float* dx, float* dwih,
                            float* db, float* dwhh, float* dh0, float* dc0,
                            float* ws, int B, int T, int Din, int H, int R,
                            void* stream_ptr) {
  const LayerBwd<float> kernel = layer_bwd<float>(R);
  if (!kernel || !hidden_ok(H) || B <= 0 || T <= 0 || Din <= 0 || Din % 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int rows = B * T;
  float* dgates = ws;
  float* part = dgates + (size_t)rows * 4 * H;
  int err = launch_cluster(kernel, lstm_bwd_smem_bytes(H, R), B, R, stream,
                           acts, cs, c0, dys, w_hh_t, dhn, dcn,
                           (const float*)nullptr, dgates, dh0, dc0,
                           (float*)nullptr, B, T, H, 0, T);
  if (err) return err;
  if ((err = reduce_rows_tn_tc(x, nullptr, 0, dgates, dwih, part, rows, Din,
                               4 * H, stream)))
    return err;
  if ((err = reduce_rows_tn_tc(ys, h0, T, dgates, dwhh, part, rows, H, 4 * H,
                               stream)))
    return err;
  if ((err = colsum(dgates, db, part + PART_FLOATS, rows, 4 * H, stream)))
    return err;
  return gemm_tc(dgates, w_ih_t, nullptr, nullptr, dx, RowMap{rows, 0, rows},
                 rows, Din, 4 * H, true, stream);
}

// The bf16 mode: x, w_ih_t, w_hh_t bf16; dx, dw_ih_t, dw_hh_t bf16 (each
// its FP32 sum rounded once); db, dh0, dc0 and the rest FP32.
int lstm_layer_backward_bf16(const bf16* x, const bf16* w_ih_t,
                             const bf16* w_hh_t, const float* h0,
                             const float* c0, const float* ys,
                             const float* acts, const float* cs,
                             const float* dys, const float* dhn,
                             const float* dcn, bf16* dx, bf16* dwih,
                             float* db, bf16* dwhh, float* dh0, float* dc0,
                             float* ws, int B, int T, int Din, int H, int R,
                             void* stream_ptr) {
  const LayerBwd<bf16> kernel = layer_bwd<bf16>(R);
  if (!kernel || !hidden_ok(H) || B <= 0 || T <= 0 || Din <= 0 || Din % 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int rows = B * T;
  float* dgates = ws;
  float* part = dgates + (size_t)rows * 4 * H;
  int err = launch_cluster(kernel, lstm_bwd_smem_bytes(H, R, 2), B, R,
                           stream, acts, cs, c0, dys, w_hh_t, dhn, dcn,
                           (const float*)nullptr, dgates, dh0, dc0,
                           (float*)nullptr, B, T, H, 0, T);
  if (err) return err;
  if ((err = reduce_rows_tn_bf16(x, nullptr, 0, dgates, dwih, part, rows,
                                 Din, 4 * H, stream)))
    return err;
  if ((err = reduce_rows_tn_bf16(ys, h0, T, dgates, dwhh, part, rows, H,
                                 4 * H, stream)))
    return err;
  if ((err = colsum(dgates, db, part + PART_FLOATS, rows, 4 * H, stream)))
    return err;
  return gemm_nt_bf16(dgates, w_ih_t, dx, rows, Din, 4 * H, stream);
}

// C (M,N) = A (M,K) @ W (K,N) (+ bias (N), may be null) in 3xTF32 on the
// tensor cores: the product of the backward, exposed to time it against
// torch.matmul for the forward's input product.
int lstm_layer_gemm_tc_f32(const float* A, const float* W, const float* bias,
                           float* C, int M, int N, int K, void* stream_ptr) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  return gemm_tc(A, W, bias, nullptr, C, RowMap{M, 0, M}, M, N, K, false,
                 (cudaStream_t)stream_ptr);
}

}  // extern "C"
