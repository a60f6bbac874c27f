// Rectangular-causal + pad-pair multi-head attention in JAX's bf16 operand
// mode, forward and backward.
//
// Replaces, in multimodalreactiongeneration_tpu/ops/pallas_rect_attention.py
// (rect_attention with bf16 q, k and v):
//   rect_attention_forward_bf16    _fwd_kernel  (_rect_attention_fwd_impl)
//   rect_attention_backward_bf16   _bwd_kernel  (_rect_attention_bwd_impl)
// The f32 mode is rect_attention.cu; ops/rect_attention.py picks the mode
// by JAX's off-TPU operand rule (bf16 when q is bf16, else f32).
//
// What the bf16 mode computes (JAX's kernels, head by head; semantics of
// the mask as rect_attention.cu): the logits s = bf16(q) bf16(k)^T * scale
// with FP32 sums; the masked softmax in FP32, w = e / sum(e) with e =
// exp(s - max); the NORMALIZED weights rounded to bf16 for the context
// bf16(w) bf16(v), an FP32 result. Backward, from the context's cotangent
// g rounded to bf16: dw = bf16(g) bf16(v)^T, ds = w (dw - rowsum(dw w))
// in FP32 (zero where the mask is set, as autograd through the plain
// masked_fill gives it), rounded to bf16 for dq = bf16(ds) bf16(k) *
// scale and dk = bf16(ds)^T bf16(q) * scale; dv = bf16(w)^T bf16(g); each
// gradient rounded to bf16 once from its FP32 sum.
//
// Design (a simple one: making it fast is later work). The online softmax
// of the f32 kernels rounds an unnormalized P and takes D = rowsum(dO O),
// neither of which is JAX's quantity once w and g are rounded, so this
// mode materializes the logits: per (batch, head) an FP32 (Lq, Lk) plane
// (rows of ld = Lk rounded up to 8), written by one batched bf16
// mma.sync.m16n8k16 product (bf16_gemm.cuh, its rows mapped onto the
// projection layout (B, L, E) with no head transposes). A warp a row then
// masks it, takes the max and the sum, and writes bf16(w) (forward), or,
// from the logits and dw, D = rowsum(dw w), bf16(ds) and bf16(w)
// (backward); the remaining products are batched bf16 products again,
// writing the context (FP32) and dq, dk, dv (bf16) straight into the
// projection layout. Pad columns of the bf16 planes are zeros, so the
// products may read a row 4 elements at a time. At the flagship's audio
// integrator (B32, Lq 252, Lk 2016, 4 heads) a plane is 260 MB in FP32;
// the backward holds four (the logits, dw, bf16 ds and w).

#include <cuda_runtime.h>
#include <math.h>

#include "bf16_gemm.cuh"

namespace {

constexpr float NEG = -1e30f;  // the plain path's masked logit

// row stride of the (Lq, Lk) planes
int plane_ld(int Lk) { return (Lk + 7) / 8 * 8; }

// keys visible to query row i: j*Lq < (i+1)*Lk, i.e. ceil((i+1)*Lk/Lq)
__device__ __forceinline__ int visible(int i, int Lq, int Lk) {
  long long v = ((long long)(i + 1) * Lk + Lq - 1) / Lq;
  return v < Lk ? (int)v : Lk;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One row of a plane: batch b, query i, its logits s (FP32, ld wide), the
// keys it may see, and the pad rule
struct Row {
  const float* s;
  const unsigned char* kp;  // the batch's key pads
  bool qpad;
  int vis, Lk;

  __device__ float logit(int j) const {
    return (j >= vis || (qpad && kp[j])) ? NEG : s[j];
  }
  __device__ bool masked(int j) const { return j >= vis || (qpad && kp[j]); }
};

// the row of warp `row` (rows = B * heads * Lq) of the planes
__device__ __forceinline__ Row row_at(const float* S, const unsigned char* qp,
                                      const unsigned char* kp, int row,
                                      int heads, int Lq, int Lk, int ld) {
  const int b = row / (heads * Lq), i = row % Lq;
  return Row{S + (size_t)row * ld, kp + (size_t)b * Lk,
             qp[(size_t)b * Lq + i] != 0, visible(i, Lq, Lk), Lk};
}

// (max, sum of exp(s - max)) of a row over all Lk keys, masked keys at
// -1e30 (a fully masked row: max -1e30, every e 1)
__device__ __forceinline__ void row_stats(const Row& r, int lane, float& m,
                                          float& l) {
  m = NEG;
  for (int j = lane; j < r.Lk; j += 32) m = fmaxf(m, r.logit(j));
  m = warp_max(m);
  l = 0.f;
  for (int j = lane; j < r.Lk; j += 32) l += expf(r.logit(j) - m);
  l = warp_sum(l);
}

// forward: W[j] = bf16(w_j), zeros past Lk
__global__ void __launch_bounds__(256) softmax_rows_kernel(
    const float* __restrict__ S, bf16* __restrict__ W,
    const unsigned char* __restrict__ qp, const unsigned char* __restrict__ kp,
    int rows, int heads, int Lq, int Lk, int ld) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const Row r = row_at(S, qp, kp, row, heads, Lq, Lk, ld);
  float m, l;
  row_stats(r, lane, m, l);
  bf16* w = W + (size_t)row * ld;
  for (int j = lane; j < ld; j += 32)
    w[j] = __float2bfloat16(j < Lk ? expf(r.logit(j) - m) / l : 0.f);
}

// backward: from the logits S and dw, D = rowsum(dw w), then DS[j] =
// bf16(ds_j) (zero where masked) and WB[j] = bf16(w_j), zeros past Lk
__global__ void __launch_bounds__(256) softmax_bwd_rows_kernel(
    const float* __restrict__ S, const float* __restrict__ dW,
    bf16* __restrict__ DS, bf16* __restrict__ WB,
    const unsigned char* __restrict__ qp, const unsigned char* __restrict__ kp,
    int rows, int heads, int Lq, int Lk, int ld) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const Row r = row_at(S, qp, kp, row, heads, Lq, Lk, ld);
  const float* dw = dW + (size_t)row * ld;
  float m, l;
  row_stats(r, lane, m, l);
  float d = 0.f;
  for (int j = lane; j < Lk; j += 32) d += dw[j] * (expf(r.logit(j) - m) / l);
  d = warp_sum(d);
  bf16* ds = DS + (size_t)row * ld;
  bf16* wb = WB + (size_t)row * ld;
  for (int j = lane; j < ld; j += 32) {
    float w = 0.f, g = 0.f;
    if (j < Lk) {
      w = expf(r.logit(j) - m) / l;
      g = r.masked(j) ? 0.f : w * (dw[j] - d);
    }
    ds[j] = __float2bfloat16(g);
    wb[j] = __float2bfloat16(w);
  }
}

int softmax_rows(const float* S, bf16* W, const unsigned char* qp,
                 const unsigned char* kp, int rows, int heads, int Lq, int Lk,
                 int ld, cudaStream_t s) {
  const unsigned blocks = (unsigned)(((size_t)rows * 32 + 255) / 256);
  softmax_rows_kernel<<<blocks, 256, 0, s>>>(S, W, qp, kp, rows, heads, Lq,
                                             Lk, ld);
  return check_launch();
}

int softmax_bwd_rows(const float* S, const float* dW, bf16* DS, bf16* WB,
                     const unsigned char* qp, const unsigned char* kp,
                     int rows, int heads, int Lq, int Lk, int ld,
                     cudaStream_t s) {
  const unsigned blocks = (unsigned)(((size_t)rows * 32 + 255) / 256);
  softmax_bwd_rows_kernel<<<blocks, 256, 0, s>>>(S, dW, DS, WB, qp, kp, rows,
                                                 heads, Lq, Lk, ld);
  return check_launch();
}

// The shapes of one call: batch B, heads, lengths, width E (head dim Dh),
// the planes' row stride, the logits' scale
struct Shape {
  int B, Lq, Lk, E, heads, Dh, ld;
  float scale;

  // rows of a (B, L, E) array, head h's columns: batch z's block
  Rows proj(int L) const {
    Rows r = dense_rows(E);
    r.zb = (long long)L * E;
    r.zh = Dh;
    return r;
  }
  // rows of the (B, heads, Lq, ld) planes
  Rows plane() const {
    Rows r = dense_rows(ld);
    r.zb = (long long)heads * Lq * ld;
    r.zh = (long long)Lq * ld;
    return r;
  }
  BfGemm gemm(Rows a, Rows b, Rows c, int M, int N, int K,
              float alpha) const {
    return BfGemm{a, b, c, nullptr, nullptr, alpha, M, N, K, K, 1, heads, 0};
  }
  int batches() const { return B * heads; }
  int rows() const { return B * heads * Lq; }
};

bool shape_ok(int B, int Lq, int Lk, int E, int heads) {
  return B > 0 && Lq > 0 && Lk > 0 && heads > 0 && E % heads == 0 &&
         (E / heads) % 4 == 0 && B * heads <= 65535;
}

template <typename... P>
bool all_aligned(const P*... p) {
  return (stage_aligned(p) && ...);
}

Shape shape_of(int B, int Lq, int Lk, int E, int heads) {
  const int dh = E / heads;
  return Shape{B, Lq, Lk, E, heads, dh, plane_ld(Lk),
               1.f / sqrtf((float)dh)};
}

// S = scale * bf16(q_h) bf16(x_h)^T per (batch, head): the logits (x = k)
// or dw (x = v, q = the cotangent g, scale 1)
template <typename TQ>
int logits(const TQ* q, const bf16* x, float* S, const Shape& sh, float alpha,
           cudaStream_t s) {
  const BfGemm p = sh.gemm(sh.proj(sh.Lq), sh.proj(sh.Lk), sh.plane(), sh.Lq,
                           sh.Lk, sh.Dh, alpha);
  return launch_bf16_gemm<false, false>(q, x, S, p, sh.batches(), s);
}

}  // namespace

extern "C" {

// the row stride (elements) of the (Lq, Lk) planes the wrappers allocate
int rect_attention_bf16_plane_ld(int Lk) { return plane_ld(Lk); }

// q (B, Lq, E), k, v (B, Lk, E) bf16; pads (B, Lq), (B, Lk) bool. Writes
// the context out (B, Lq, E) FP32. Scratch: S (B, heads, Lq, ld) FP32 and
// W (the same) bf16. Returns 0 or the first CUDA error code.
int rect_attention_forward_bf16(const bf16* q, const bf16* k, const bf16* v,
                                const unsigned char* q_pad,
                                const unsigned char* k_pad, float* out,
                                float* S, bf16* W, int B, int Lq, int Lk,
                                int E, int heads, void* stream_ptr) {
  if (!shape_ok(B, Lq, Lk, E, heads) || !all_aligned(q, k, v, out, S, W))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream_ptr;
  const Shape sh = shape_of(B, Lq, Lk, E, heads);
  int err;
  if ((err = logits(q, k, S, sh, sh.scale, s)) ||
      (err = softmax_rows(S, W, q_pad, k_pad, sh.rows(), heads, Lq, Lk,
                          sh.ld, s)))
    return err;
  // the context bf16(w) bf16(v): w rows x-major, v k-major
  const BfGemm p = sh.gemm(sh.plane(), sh.proj(Lk), sh.proj(Lq), Lq, sh.Dh,
                           Lk, 1.f);
  return launch_bf16_gemm<false, true>(W, v, out, p, sh.batches(), s);
}

// The backward from the context's cotangent g (B, Lq, E) FP32: dq (B, Lq,
// E), dk, dv (B, Lk, E) bf16. Scratch: S and dW (B, heads, Lq, ld) FP32,
// DS and WB (the same) bf16.
int rect_attention_backward_bf16(
    const bf16* q, const bf16* k, const bf16* v, const unsigned char* q_pad,
    const unsigned char* k_pad, const float* g, bf16* dq, bf16* dk, bf16* dv,
    float* S, float* dW, bf16* DS, bf16* WB, int B, int Lq, int Lk, int E,
    int heads, void* stream_ptr) {
  if (!shape_ok(B, Lq, Lk, E, heads) ||
      !all_aligned(q, k, v, g, dq, dk, dv, S, dW, DS, WB))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream_ptr;
  const Shape sh = shape_of(B, Lq, Lk, E, heads);
  const int dh = sh.Dh;
  int err;
  if ((err = logits(q, k, S, sh, sh.scale, s)) ||
      (err = logits(g, v, dW, sh, 1.f, s)) ||
      (err = softmax_bwd_rows(S, dW, DS, WB, q_pad, k_pad, sh.rows(), heads,
                              Lq, Lk, sh.ld, s)))
    return err;
  // dq = scale * ds k: ds rows x-major, k k-major
  if ((err = launch_bf16_gemm<false, true>(
           DS, k, dq,
           sh.gemm(sh.plane(), sh.proj(Lk), sh.proj(Lq), Lq, dh, Lk,
                   sh.scale),
           sh.batches(), s)))
    return err;
  // dk = scale * ds^T q and dv = w^T g: the planes k-major (row i)
  if ((err = launch_bf16_gemm<true, true>(
           DS, q, dk,
           sh.gemm(sh.plane(), sh.proj(Lq), sh.proj(Lk), Lk, dh, Lq,
                   sh.scale),
           sh.batches(), s)))
    return err;
  return launch_bf16_gemm<true, true>(
      WB, g, dv,
      sh.gemm(sh.plane(), sh.proj(Lq), sh.proj(Lk), Lk, dh, Lq, 1.f),
      sh.batches(), s);
}

}  // extern "C"
