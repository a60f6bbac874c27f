// The whole post-warmup AR decode rollout as one persistent launch.
//
// Replaces: multimodalreactiongeneration_tpu/ops/pallas_decode_rollout.py
//   decode_rollout -> pallas_call(_kernel). Per step: write the step's
//   precomputed audio/motion encodings into the shared raw rings; per
//   metaformer block: LSTM cell -> LN/FF/LN -> two folded attends over
//   the rings -> LN/FF/LN each -> cat -> FFN/LN; then the output head and
//   the AR feedback blended with the teacher embedding by the mask.
//
// What bounds it on the H100: the latency of the dependent chain. A
// step is 52 dependent stages (10 per block x 5 blocks + the head's 2)
// over tiny operands (16 rows); the folded panels (~9.7 M values) and
// the rings (8.2 MB + 1 MB in bf16) fit the 50 MB L2, so neither bytes
// nor FLOPs are the limit, and no SM's 227 KB of shared memory holds the
// working set. Measured per stage (%globaltimer stamps of a
// -DROLLOUT_STAMPS build, tools/attention_rollout_ab.py --stages): each
// stage is a few dependent L2 round trips (prologue activations,
// weights, ring rows, the stores) plus a ~1.5 us barrier; the logits
// stage ran its 144 units in two rounds on 132 blocks.
//
// Design: one cooperative launch runs every step, with the grid sized to
// one resident block per SM. The steps loop inside the kernel; each
// stage spreads its work over all blocks and ends in a grid barrier
// (GridSync: one thread of each block arrives with a release add and
// waits with acquire loads). Panels and rings are read through L2 and
// never copied; the rings are updated in place in the device copy the
// wrapper makes. Each stage is a short chain of L2 round trips and of
// one block's instruction stream, so the work is cut wide: a matmul
// stage gives each block a 32-column group (the LSTM cell: the four
// gates of 8 hidden units), splits K over the block's 8 warps and, in
// the narrow stages, over up to 4 blocks as well (partial sums added by
// the next stage's prologue); lanes keep 16-32 weight loads in flight
// and read activations from shared memory as float4. A LayerNorm that
// feeds a matmul is recomputed by every block as the stage's prologue
// (16 rows, cheaper than another barrier), and one block keeps the FP32
// result for later residuals. Attention takes two stages: logits plus
// per-chunk softmax statistics, then normalised weights and the context
// sum over 64-column slices; the host sizes the chunks so that every
// logits unit runs in one round on the grid (ops/decode_rollout.py
// logit_chunk: 144 slots at the flagship's rings), both loops keep
// ring rows packed until used (Pack8), 8 bf16 or 4 f32 rows a lane in
// flight, and the logits' four head sums reduce together
// (sum4_by_lane). One launch handles 16 dialogs; the wrapper runs larger
// batches as consecutive launches. (Measured and taken out, PERF.md:
// merging S9+S10 and S11+S12 by recomputing the narrow middle, copying
// each block's next weight slice into shared memory during the barrier,
// loading the cell's state before its products.)
//
// Numerics follow the TPU kernel: FP32 state, LayerNorms (E[x^2] -
// mean^2, eps 1e-5), softmax and accumulation; matmul inputs rounded to
// the panel type; query and softmax weights rounded to the ring type;
// masked logits at the finite -1e30. Panels and rings are both FP32
// (parity mode) or both BF16 (production).

#include <type_traits>

#include "decode_rollout_stages.cuh"

namespace rollout {

enum {
  W_IH, W_HH, B_G, LN1G, LN1B, W_EF, B_EF, LN2G, LN2B,
  W_QA, B_QA, W_OA, B_OA, LNAG, LNAB, W_FA, B_FA, LNFAG, LNFAB,
  W_QM, B_QM, W_OM, B_OM, LNMG, LNMB, W_FM, B_FM, LNFMG, LNFMB,
  W_CAT, B_CAT, W_1, B_1, W_2, B_2, LNFG, LNFB,
  W_O1, B_O1, W_O2, B_O2, W_FB, B_FB, N_W
};

// Split-K factors of the narrow matmul stages: a stage with N / 32
// column groups runs on N / 32 * P blocks, each over K / P of the depth,
// and leaves P partial sums for the next stage's prologue to add up.
constexpr int P_EF = 4;   // S2  LN+FF of the main embedding  (K 256)
constexpr int P_O = 4;    // S6  out-side fold                (K 1024)
constexpr int P_F = 4;    // S7  integrator LN+FF             (K 256)
constexpr int P_CAT = 4;  // S8  cat linear                   (K 512)
constexpr int P_1 = 4;    // S9  FFN in                       (K 256)
constexpr int P_2 = 2;    // S10 FFN out                      (K = bottleneck)
constexpr int P_O1 = 4;   // S11 output head in               (K 256)

// FP32 scratch of one launch; parts of a split stage are BT x N apart
struct Scratch {
  float *x, *hs, *cs, *ya, *ze, *y, *q, *logit[2], *stat[2], *ctx, *att,
      *y2, *z2, *mparts, *merged, *ff1, *zf, *o1;
};

// Lays the scratch out from `base` (nullptr: only count); returns floats.
long long layout(float* base, int NB, int SA, int SM, int BN, int cs,
                 Scratch* s) {
  const long long nca = (SA + cs - 1) / cs, ncm = (SM + cs - 1) / cs;
  long long used = 0;
  auto take = [&](long long n) {
    float* r = base ? base + used : nullptr;
    used += (n + 3) / 4 * 4;  // keep every buffer 16-byte aligned
    return r;
  };
  s->x = take(BT * H);
  s->hs = take(2LL * NB * BT * H);
  s->cs = take((long long)NB * BT * H);
  s->ya = take(BT * H);
  s->ze = take((long long)P_EF * BT * H);
  s->y = take(BT * H);
  s->q = take(2LL * BT * HD);
  s->logit[0] = take((long long)BT * HEADS * SA);
  s->logit[1] = take((long long)BT * HEADS * SM);
  s->stat[0] = take(BT * HEADS * 2 * nca);
  s->stat[1] = take(BT * HEADS * 2 * ncm);
  s->ctx = take(2LL * BT * HD);
  s->att = take(2LL * P_O * BT * H);
  s->y2 = take(2LL * BT * H);
  s->z2 = take(2LL * P_F * BT * H);
  s->mparts = take((long long)P_CAT * BT * H);
  s->merged = take(BT * H);
  s->ff1 = take((long long)P_1 * BT * BN);
  s->zf = take((long long)P_2 * BT * H);
  s->o1 = take((long long)P_O1 * BT * BN);
  return used;
}

template <typename T>
struct Params {
  const void* w[N_W];
  const T* ea;         // (steps, B, ratio, H)
  const T* em;         // (steps, B, H)
  const float* gt;     // (steps, B, H)
  const float* mask;   // (steps,)
  T* ring[2];          // this launch's dialogs: (bt, S_m, H), in place
  const float* h0;     // (NB, B, H)
  const float* c0;     // (NB, B, H)
  const float* main0;  // (B, H)
  float* ys;           // (steps, B, out_dim)
  Scratch s;
  unsigned int* bar;
  int steps, B, b0, bt, NB, BN, out_dim, S[2], nch[2], chunk, ratio, len_a0,
      len_m0, bud_m;
  float scale;
};

template <typename T>
__global__ void __launch_bounds__(NT, 1) rollout_kernel(Params<T> p) {
  extern __shared__ __align__(16) float smem[];
  float* act = smem;                    // [BT][HD]
  float* red = act + BT * HD;           // [NW][4][BT][32]
  float* wsm = red + NW * 4 * BT * 32;  // [HEADS][SMAX]
  __shared__ float ml[2 * HEADS];
  GridSync sync(p.bar);
  const int tid = threadIdx.x;
  const int bt = p.bt, NB = p.NB, BN = p.BN;
  const Scratch& s = p.s;
  const int gstride = gridDim.x * NT;
  const int gtid = blockIdx.x * NT + tid;

  auto wt = [&](int i) { return static_cast<const T*>(p.w[i]); };
  auto wf = [&](int i) { return static_cast<const float*>(p.w[i]); };

  for (int i = gtid; i < NB * BT * H; i += gstride) {
    const int l = i / (BT * H), r = (i / H) % BT, k = i % H;
    const size_t src = ((size_t)l * p.B + p.b0 + r) * H + k;
    s.hs[i] = r < bt ? p.h0[src] : 0.f;
    s.cs[i] = r < bt ? p.c0[src] : 0.f;
  }
  for (int i = gtid; i < BT * H; i += gstride) {
    const int r = i / H;
    s.x[i] = r < bt ? p.main0[(size_t)(p.b0 + r) * H + i % H] : 0.f;
  }
  sync(gridDim.x);

  for (int t = 0; t < p.steps; ++t) {
    const int cur = t & 1, nxt = cur ^ 1;
    const int off_a = (p.len_a0 + t * p.ratio) % p.S[0];
    const int off_m = (p.len_m0 + t) % p.bud_m;
    const int vis[2] = {min(p.len_a0 + (t + 1) * p.ratio, p.S[0]),
                        min(p.len_m0 + t + 1, p.bud_m)};
    const float m = p.mask[t];
    sync.begin_step(t);

    // ring writes (read from the attention stages on, after >= 3 barriers)
    for (int i = gtid; i < bt * p.ratio * H; i += gstride) {
      const int r = i / (p.ratio * H), j = (i / H) % p.ratio, k = i % H;
      p.ring[0][((size_t)r * p.S[0] + off_a + j) * H + k] =
          p.ea[(((size_t)t * p.B + p.b0 + r) * p.ratio + j) * H + k];
    }
    for (int i = gtid; i < bt * H; i += gstride) {
      const int r = i / H, k = i % H;
      p.ring[1][((size_t)r * p.S[1] + off_m) * H + k] =
          p.em[((size_t)t * p.B + p.b0 + r) * H + k];
    }

    for (int l = 0; l < NB; ++l) {
      float* h_cur = s.hs + ((size_t)cur * NB + l) * BT * H;
      float* h_nxt = s.hs + ((size_t)nxt * NB + l) * BT * H;
      const size_t lh = (size_t)l * H;

      // S1: x (block input) and the LSTM cell -> h_nxt, c
      for (int g = blockIdx.x; g < H / 8; g += gridDim.x) {
        if (l == 0)
          prologue_copy<T>(act, 2 * H, 0, s.x, H, bt);
        else
          prologue_ln<T, P_2>(act, 2 * H, 0, s.zf, s.merged,
                              wf(LNFG) + lh - H, wf(LNFB) + lh - H,
                              g == 0 ? s.x : nullptr, bt);
        prologue_copy<T>(act, 2 * H, H, h_cur, H, bt);
        __syncthreads();
        cell_group<T>(act, wt(W_IH) + lh * 4 * H, wt(W_HH) + lh * 4 * H,
                      wf(B_G) + lh * 4, s.cs + lh * BT, h_nxt, g, bt, red);
      }
      sync(H / 8);

      // S2: ya = LN(h + x); ze = ya @ W_ef + b
      for (int u = blockIdx.x; u < (H / 32) * P_EF; u += gridDim.x) {
        const int g = u / P_EF, q = u % P_EF;
        prologue_ln<T>(act, H, 0, h_nxt, s.x, wf(LN1G) + lh, wf(LN1B) + lh,
                       u == 0 ? s.ya : nullptr, bt);
        __syncthreads();
        mm_group<T>(act, H, q * (H / P_EF), H / P_EF, wt(W_EF) + lh * H, H,
                    g * 32, q ? nullptr : wf(B_EF) + lh, false,
                    s.ze + (size_t)q * BT * H, H, nullptr, 0, 0.f, bt, red);
      }
      sync((H / 32) * P_EF);

      // S3: y = LN(ze + ya); folded queries of both modalities
      // (64 column groups already fill half the grid: no K split)
      for (int g = blockIdx.x; g < 2 * HD / 32; g += gridDim.x) {
        const int md = g / (HD / 32);
        prologue_ln<T, P_EF>(act, H, 0, s.ze, s.ya, wf(LN2G) + lh,
                             wf(LN2B) + lh, g == 0 ? s.y : nullptr, bt);
        __syncthreads();
        mm_group<T>(act, H, 0, H, wt(md ? W_QM : W_QA) + lh * HD, HD,
                    (g % (HD / 32)) * 32, wf(md ? B_QM : B_QA) + l * HD,
                    false, s.q + (size_t)md * BT * HD, HD, nullptr, 0, 0.f,
                    bt, red);
      }
      sync(2 * HD / 32);

      // S4: logits and per-chunk softmax statistics
      const int na = bt * p.nch[0], n_logit = na + bt * p.nch[1];
      for (int u = blockIdx.x; u < n_logit; u += gridDim.x) {
        const int md = u >= na, v = md ? u - na : u;
        const int b = v / p.nch[md], ch = v % p.nch[md];
        logits_unit<T>(p.ring[md], p.S[md], vis[md],
                       s.q + (size_t)md * BT * HD, b, ch, p.chunk, p.nch[md],
                       p.scale,
                       s.logit[md], s.stat[md], wsm);
      }
      sync(n_logit);

      // S5: softmax weights and context, 64 raw columns per unit
      for (int u = blockIdx.x; u < 2 * bt * (H / 64); u += gridDim.x) {
        const int md = u / (bt * (H / 64)), v = u % (bt * (H / 64));
        context_unit<T>(p.ring[md], p.S[md], vis[md], s.logit[md],
                        s.stat[md], p.nch[md], v / (H / 64), v % (H / 64),
                        s.ctx + (size_t)md * BT * HD, wsm, red, ml);
      }
      sync(2 * bt * (H / 64));

      // S6: out-side fold: att = ctx @ W_o + b
      for (int u = blockIdx.x; u < 2 * (H / 32) * P_O; u += gridDim.x) {
        const int md = u / ((H / 32) * P_O), v = u % ((H / 32) * P_O);
        const int g = v / P_O, q = v % P_O;
        prologue_copy<T>(act, HD, 0, s.ctx + (size_t)md * BT * HD, HD, bt);
        __syncthreads();
        mm_group<T>(act, HD, q * (HD / P_O), HD / P_O,
                    wt(md ? W_OM : W_OA) + lh * HD, H, g * 32,
                    q ? nullptr : wf(md ? B_OM : B_OA) + lh, false,
                    s.att + ((size_t)md * P_O + q) * BT * H, H, nullptr, 0,
                    0.f, bt, red);
      }
      sync(2 * (H / 32) * P_O);

      // S7: y2 = LN(att + y); z2 = y2 @ W_f + b
      for (int u = blockIdx.x; u < 2 * (H / 32) * P_F; u += gridDim.x) {
        const int md = u / ((H / 32) * P_F), v = u % ((H / 32) * P_F);
        const int g = v / P_F, q = v % P_F;
        prologue_ln<T, P_O>(act, H, 0, s.att + (size_t)md * P_O * BT * H,
                            s.y, wf(md ? LNMG : LNAG) + lh,
                            wf(md ? LNMB : LNAB) + lh,
                            v == 0 ? s.y2 + (size_t)md * BT * H : nullptr, bt);
        __syncthreads();
        mm_group<T>(act, H, q * (H / P_F), H / P_F,
                    wt(md ? W_FM : W_FA) + lh * H, H, g * 32,
                    q ? nullptr : wf(md ? B_FM : B_FA) + lh, false,
                    s.z2 + ((size_t)md * P_F + q) * BT * H, H, nullptr, 0,
                    0.f, bt, red);
      }
      sync(2 * (H / 32) * P_F);

      // S8: merged = [LN(z2a + y2a) | LN(z2m + y2m)] @ W_cat + b
      for (int u = blockIdx.x; u < (H / 32) * P_CAT; u += gridDim.x) {
        const int g = u / P_CAT, q = u % P_CAT;
        for (int md = 0; md < 2; ++md)
          prologue_ln<T, P_F>(act, 2 * H, md * H,
                              s.z2 + (size_t)md * P_F * BT * H,
                              s.y2 + (size_t)md * BT * H,
                              wf(md ? LNFMG : LNFAG) + lh,
                              wf(md ? LNFMB : LNFAB) + lh, nullptr, bt);
        __syncthreads();
        mm_group<T>(act, 2 * H, q * (2 * H / P_CAT), 2 * H / P_CAT,
                    wt(W_CAT) + lh * 2 * H, H, g * 32,
                    q ? nullptr : wf(B_CAT) + lh, false,
                    s.mparts + (size_t)q * BT * H, H, nullptr, 0, 0.f, bt,
                    red);
      }
      sync((H / 32) * P_CAT);

      // S9: ff1 = merged @ W_1 + b (relu applied by the consumer, after
      //     the parts are summed); block 0 keeps the summed merged
      for (int u = blockIdx.x; u < ((BN + 31) / 32) * P_1; u += gridDim.x) {
        const int g = u / P_1, q = u % P_1;
        prologue_copy<T, P_CAT>(act, H, 0, s.mparts, H, bt, false,
                                u == 0 ? s.merged : nullptr);
        __syncthreads();
        mm_group<T>(act, H, q * (H / P_1), H / P_1, wt(W_1) + lh * BN, BN,
                    g * 32, q ? nullptr : wf(B_1) + (size_t)l * BN, false,
                    s.ff1 + (size_t)q * BT * BN, BN, nullptr, 0, 0.f, bt,
                    red);
      }
      sync(((BN + 31) / 32) * P_1);

      // S10: zf = relu(ff1) @ W_2 + b  (next x = LN(zf + merged), S1/S11)
      for (int u = blockIdx.x; u < (H / 32) * P_2; u += gridDim.x) {
        const int g = u / P_2, q = u % P_2;
        prologue_copy<T, P_1>(act, BN, 0, s.ff1, BN, bt, true);
        __syncthreads();
        mm_group<T>(act, BN, q * (BN / P_2), BN / P_2,
                    wt(W_2) + (size_t)l * BN * H, H, g * 32,
                    q ? nullptr : wf(B_2) + lh, false,
                    s.zf + (size_t)q * BT * H, H, nullptr, 0, 0.f, bt, red);
      }
      sync((H / 32) * P_2);
    }

    // S11: o1 = LN(zf + merged) @ W_o1 + b (relu by the consumer)
    const size_t ll = (size_t)(NB - 1) * H;
    for (int u = blockIdx.x; u < ((BN + 31) / 32) * P_O1; u += gridDim.x) {
      const int g = u / P_O1, q = u % P_O1;
      prologue_ln<T, P_2>(act, H, 0, s.zf, s.merged, wf(LNFG) + ll,
                          wf(LNFB) + ll, nullptr, bt);
      __syncthreads();
      mm_group<T>(act, H, q * (H / P_O1), H / P_O1, wt(W_O1), BN, g * 32,
                  q ? nullptr : wf(B_O1), false, s.o1 + (size_t)q * BT * BN,
                  BN, nullptr, 0, 0.f, bt, red);
    }
    sync(((BN + 31) / 32) * P_O1);

    // S12: the output row, and the next step's main embedding
    //      x = m * (o1 @ W_fb + b_fb) + (1 - m) * gt[t]
    const int ng_out = (p.out_dim + 31) / 32;
    for (int g = blockIdx.x; g < ng_out + H / 32; g += gridDim.x) {
      prologue_copy<T, P_O1>(act, BN, 0, s.o1, BN, bt, true);
      __syncthreads();
      if (g < ng_out)
        mm_group<T>(act, BN, 0, BN, wt(W_O2), p.out_dim, g * 32, wf(B_O2),
                    false, p.ys + ((size_t)t * p.B + p.b0) * p.out_dim,
                    p.out_dim, nullptr, 0, 0.f, bt, red);
      else
        mm_group<T>(act, BN, 0, BN, wt(W_FB), H, (g - ng_out) * 32, wf(B_FB),
                    false, s.x, H, p.gt + ((size_t)t * p.B + p.b0) * H, H, m,
                    bt, red);
    }
    sync(ng_out + H / 32);
  }
}

size_t smem_bytes() {
  return sizeof(float) * ((size_t)BT * HD + NW * 4 * BT * 32 + HEADS * SMAX);
}

template <typename T>
int launch(Params<T>& p, cudaStream_t stream) {
  const void* fn = (const void*)rollout_kernel<T>;
  const size_t smem = smem_bytes();
  int err = (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = (int)cudaGetDevice(&dev))) return err;
  if ((err = (int)cudaDeviceGetAttribute(
           &sms, cudaDevAttrMultiProcessorCount, dev)))
    return err;
  if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fn, NT, smem)))
    return err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&p};
  err = (int)cudaLaunchCooperativeKernel(fn, dim3(sms), dim3(NT), args, smem,
                                         stream);
  if (err) return err;
  return (int)cudaGetLastError();
}

}  // namespace rollout

extern "C" {

// FP32 scratch of one launch (16 dialogs), in floats
long long decode_rollout_workspace_floats(int NB, int SA, int SM, int BN,
                                          int chunk) {
  rollout::Scratch s;
  return rollout::layout(nullptr, NB, SA, SM, BN, chunk, &s);
}

// weights: 43 device pointers in the order of ops/decode_rollout.py
// _W_KEYS. ring_a (B, SA, H), ring_m (B, SM, H) are updated in place.
// bf16 != 0 selects BF16 panels, rings and streams. chunk: ring slots
// per logits unit (ops/decode_rollout.py logit_chunk). Returns 0 or the
// first CUDA error code.
int decode_rollout_launch(
    const void* const* weights, const void* ea, const void* em,
    const float* gt, const float* mask, void* ring_a, void* ring_m,
    const float* h0, const float* c0, const float* main0, float* ys,
    float* ws, unsigned int* bar, int bf16, int steps, int B, int b0,
    int bt, int NB, int BN, int out_dim, int SA, int SM, int chunk,
    int ratio, int len_a0, int len_m0, int bud_m, float scale,
    void* stream_ptr) {
  using namespace rollout;
  if (bt < 1 || bt > BT || SA > SMAX || SM > SMAX || BN % (4 * NW * P_2) ||
      chunk < 1 || chunk > SMAX)
    return (int)cudaErrorInvalidValue;
  const long long nca = (SA + chunk - 1) / chunk;
  const long long ncm = (SM + chunk - 1) / chunk;
  if (nca > 32 || ncm > 32)  // one lane per chunk merges the statistics
    return (int)cudaErrorInvalidValue;
  Scratch s;
  layout(ws, NB, SA, SM, BN, chunk, &s);

  cudaStream_t stream = (cudaStream_t)stream_ptr;
  auto fill = [&](auto& p, auto* ring_type) {
    using T = std::remove_pointer_t<decltype(ring_type)>;
    for (int i = 0; i < N_W; ++i) p.w[i] = weights[i];
    p.ea = static_cast<const T*>(ea);
    p.em = static_cast<const T*>(em);
    p.gt = gt;
    p.mask = mask;
    p.ring[0] = static_cast<T*>(ring_a) + (size_t)b0 * SA * H;
    p.ring[1] = static_cast<T*>(ring_m) + (size_t)b0 * SM * H;
    p.h0 = h0;
    p.c0 = c0;
    p.main0 = main0;
    p.ys = ys;
    p.s = s;
    p.bar = bar;
    p.steps = steps;
    p.B = B;
    p.b0 = b0;
    p.bt = bt;
    p.NB = NB;
    p.BN = BN;
    p.out_dim = out_dim;
    p.S[0] = SA;
    p.S[1] = SM;
    p.nch[0] = (int)nca;
    p.nch[1] = (int)ncm;
    p.chunk = chunk;
    p.ratio = ratio;
    p.len_a0 = len_a0;
    p.len_m0 = len_m0;
    p.bud_m = bud_m;
    p.scale = scale;
  };
  if (bf16) {
    Params<__nv_bfloat16> p;
    fill(p, (__nv_bfloat16*)nullptr);
    return launch(p, stream);
  }
  Params<float> p;
  fill(p, (float*)nullptr);
  return launch(p, stream);
}

#ifdef ROLLOUT_STAMPS
// The stamps of the instrumented build (decode_rollout_stages.cuh):
// dims gets {STAMP_T0, STAMP_STEPS, STAMP_STAGES, STAMP_GRID}; with
// host != nullptr the (steps, stages, grid, 3) u64 array is copied there
// (after the stream's work), with host == nullptr it is zeroed.
int decode_rollout_stamps(unsigned long long* host, int* dims) {
  using namespace rollout;
  dims[0] = STAMP_T0;
  dims[1] = STAMP_STEPS;
  dims[2] = STAMP_STAGES;
  dims[3] = STAMP_GRID;
  if (host) return (int)cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps));
  void* at = nullptr;
  int err = (int)cudaGetSymbolAddress(&at, g_stamps);
  if (err) return err;
  return (int)cudaMemset(at, 0, sizeof(g_stamps));
}
#endif

}  // extern "C"
