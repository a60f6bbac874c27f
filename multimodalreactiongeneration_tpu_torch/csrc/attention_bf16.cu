// Rectangular-causal + pad-pair multi-head attention in JAX's bf16 operand
// mode, forward and backward.
//
// Replaces, in multimodalreactiongeneration_tpu/ops/pallas_rect_attention.py
// (rect_attention with bf16 q, k and v):
//   rect_attention_forward_bf16    _fwd_kernel  (_rect_attention_fwd_impl)
//   rect_attention_backward_bf16   _bwd_kernel  (_rect_attention_bwd_impl)
// The f32 mode is rect_attention.cu; ops/rect_attention.py picks the mode
// by JAX's off-TPU operand rule (bf16 when q is bf16, else f32). The mask,
// the fully masked rows and the key blocks are rect_tiles.cuh's.
//
// What the bf16 mode computes (JAX's kernels, head by head): the logits s
// = bf16(q) bf16(k)^T * scale with FP32 sums; the masked softmax in FP32,
// w = e / sum(e) with e = exp(s - max); the NORMALIZED weights rounded to
// bf16 for the context bf16(w) bf16(v), an FP32 result. Backward, from the
// context's cotangent g rounded to bf16: dw = bf16(g) bf16(v)^T, ds = w
// (dw - rowsum(dw w)) in FP32 (zero where the mask is set, as autograd
// through the plain masked_fill gives it), rounded to bf16 for dq =
// bf16(ds) bf16(k) * scale and dk = bf16(ds)^T bf16(q) * scale; dv =
// bf16(w)^T bf16(g); each gradient rounded to bf16 once from its FP32 sum.
//
// Bound, at the flagship audio integrator (B32, Lq 252, Lk 2016, E 256, 4
// heads, Dh 64): the bytes, each input read once and each output written
// once (q, k, v, the context, m and l in the forward; q, k, v, m, l, g, dq,
// dk and dv in the backward), 0.024 and 0.044 ms at 3.35 TB/s; the
// products, 4 and 10 FLOPs per visible (query, key) pair and head dim (the
// function's two and five products), take 0.008 and 0.021 ms at 989
// TFLOP/s.
//
// Design. An online softmax rounds exp(s - running max) before the sum is
// known, and its backward takes D = rowsum(dO o O); neither is JAX's
// quantity once w and g are rounded. These kernels keep JAX's rounding
// points and hold no (Lq, Lk) plane anywhere, streaming 64-key tiles as
// rect_attention.cu does (16-row warp tiles, a two-stage cp.async ring,
// the stop at the causal horizon except for a tile holding a fully masked
// row, key columns past Lk zero-filled and excluded, never -1e30, so they
// do not join a fully masked row's average; longest ranges first). Every
// product is one bf16 mma.sync.m16n8k16 with FP32 accumulation
// (bf16_mma.cuh); B fragments come from shared tiles by ldmatrix (.trans
// where the sum runs down the tile's rows); shared rows are Dh + 8 bf16,
// so an ldmatrix's eight rows fall in eight 16-byte bank groups.
//   * forward (rect_attn_fwd_bf16): a block per (64 q rows, head, batch):
//     four row groups of 16 rows (Q's A fragments in registers) times two
//     key groups, which take the key tiles in turn, so that the longest
//     rows' chain of tiles is halved. Two passes over the visible tiles.
//     Pass A computes S tile by tile and keeps each group's row max and
//     sum (online, FP32); merged in group order they are the row's m and
//     l. Pass B recomputes S, forms w = exp(s - m) / l and rounds it to
//     bf16 in registers: the S accumulators of two adjacent 8-key groups
//     are the A fragment of one k16 step, so w never leaves registers, and
//     O += bf16(w) V takes V's B fragments by ldmatrix.trans; the groups'
//     O are added in group order. Pass A reads K alone. Under grad the
//     block writes each row's m and l, (B, H, Lq) each.
//   * backward, three kernels. (1) rect_attn_bwd_d_bf16, JAX's D = rowsum(
//     dw o w) before anything else: blocks of the forward's rows (one key
//     group) recompute S and dW = bf16(g) V^T tile by tile, w from (m, l),
//     and sum w dw in FP32; they also write bf16(g), which the key-block
//     pass streams. Its tiles stop at the causal horizon even for a fully
//     masked row, whose ds is zero whatever its D. (D could also come from
//     the forward, writing O' = w bf16(v) with w unrounded for a rowsum(
//     bf16(g) o O') pass; that adds a product to every forward under grad
//     and a residual to the forward's interface, where this pass costs two
//     products a visible tile once per backward.) (2) rect_attn_bwd_kv_bf16,
//     one block of 4 warps per (64-key block, head, batch), the blocks of
//     the longest q range first; K and V of the block in shared memory
//     (each warp's 16 keys as A fragments by ldmatrix); the block streams
//     the 16-row q tiles that see its keys (and, before them, the tiles
//     holding a fully masked row, which add to dV alone) through a
//     two-stage ring of bf16 Q, bf16(g) and the rows' m, l and D. Per (q
//     tile, key block) pair a warp computes S^T = K Q^T and dW^T = V G^T
//     once, w^T from (m, l), dS^T = w^T (dW^T - D), zero where masked, and
//     rounds both; dV += bf16(w)^T G and dK += bf16(dS)^T Q stay in FP32
//     registers (the accumulators as A fragments again). bf16(dS) goes to
//     shared memory (rows of 72 bf16), and each warp takes a quarter of
//     the tile's dQ = dS K over the block's 64 keys; the partial lands in
//     a dQ workspace, rows from floor(j0 Lq / Lk) on. (3) rect_tiles.cuh's
//     dq_sum adds each row's partials in key-block order and rounds dq to
//     bf16 once. No atomics: the same inputs give the same bits, run after
//     run.
// The row passes' grid is flat with the q block slowest (see row_block):
// a (q block, head, batch) grid gave each SM blocks of one length. The
// pads are staged once a block as bit words in shared memory; a tile that
// every row of a warp sees whole, with no pad pair, skips the per-element
// mask; w is e times the row sum's reciprocal (one IEEE reciprocal a row)
// with e the SFU's exp2 (a few FP32 ulps from expf: a weight within
// them of a bf16 rounding boundary may round the other way, as the online
// sum's order already allows). Shared memory per CTA at Dh 64, Lq 252, Lk
// 2016: the forward 75.0 KB (two stages of a K and V tile a key group),
// the D pass 37.6 KB, the key-block pass 30.5 KB (K, V, two stages of Q
// and G, dS); __launch_bounds__ gives 2, 3 and 4 CTAs an SM (16, 12 and
// 16 warps). The build log (_build/attention_bf16.log, -Xptxas -v) gives registers
// and spills. The tile constants below were chosen by a sweep (PERF.md §6,
// PR 22). wgmma wants 64-row warpgroup tiles: a
// 64 x 64 logit tile per warpgroup would need the 64-row softmax statistics
// exchanged across four warps and the fully masked rows' full range taken
// by 64 rows at once, and at Dh 64 a k16 step count of 4 leaves its
// pipeline short; TMA would replace 16-byte cp.async copies of 9 KB tiles,
// and a third ring stage measured no faster, so the copies are not where
// the time goes. Neither is used here.
//
// Head dims: instantiated for Dh 16, 32, 64, 128 and 256, the logits'
// scale from the caller (1/sqrt of the real head dim: ops/rect_attention.py
// runs any other Dh up to 256 on the next of these, on a zero-padded copy
// of the heads). Under Dh 64 a warp of the key-block pass may take no dQ
// column group; past it a warp takes DT / 4 of them, their B fragments
// two groups an ldmatrix. From Dh 128 on the kernels' __launch_bounds__
// leave a thread 255 registers, and at Dh 256 a forward block has one key
// group (two stages of two groups' K and V tiles would take 270 KB). The
// build log prints the spill: at Dh 256 the forward 148 bytes, the
// key-block pass 796 (nvcc 12.8, sm_90a).

#include <cuda_runtime.h>
#include <math.h>

#include "bf16_mma.cuh"
#include "rect_tiles.cuh"

namespace {

// The tile constants, chosen by a sweep (PERF.md §6, PR 22): the forward's
// and the D pass's key groups (each of a block's four row groups, warps of
// 16 q rows, has a warp in each, and the groups take the key tiles in
// turn), the ring's stages, the q rows a step of the key-block pass, and
// each kernel's CTAs an SM for __launch_bounds__.
constexpr int RG = 4;               // row groups of a forward or D-pass
constexpr int FQ = 16 * RG;         // block, its q rows
// key groups of a forward block: at Dh 256 one (two stages of two key
// groups' K and V tiles would take 270 KB of shared memory)
__host__ __device__ constexpr int kgf(int dh) { return dh >= 256 ? 1 : 2; }
constexpr int KGD = 1;              // of a D-pass block
constexpr int FK = KEY_BLOCK;       // keys of a streamed K / V tile
constexpr int STAGES = 2;           // ring stages in flight
constexpr int KW = 4;               // warps of a key-block pass block
constexpr int K_THREADS = 32 * KW;
constexpr int BK = KEY_BLOCK;       // its keys: 16 a warp
constexpr int BQ = 16;              // q rows a step of the key-block pass
constexpr int FWD_MINB = 2, D_MINB = 3, KV_MINB = 4;  // CTAs an SM
// from Dh 128 on, as many CTAs an SM as leave a thread 255 registers (Q's
// and G's fragments and the accumulators grow with Dh; the build log's
// spill lines say what does not fit)
__host__ __device__ constexpr int fwd_minb(int dh) {
  return dh >= 128 ? 1 : FWD_MINB;
}
__host__ __device__ constexpr int d_minb(int dh) {
  return dh >= 128 ? 2 : D_MINB;
}
__host__ __device__ constexpr int kv_minb(int dh) {
  return dh >= 128 ? 2 : KV_MINB;
}
static_assert(BK == 16 * KW, "a warp takes 16 keys of a key block");
static_assert(BQ == 16 || BQ == 32, "k16 steps of q rows");

// the q rows of a warp's fragments (g and g + 8 of its 16): how many keys
// each sees and whether it is padding
struct RowPair {
  int lim[2];
  bool pad[2];
};

__device__ __forceinline__ RowPair row_pair(const unsigned char* qp, int r0,
                                            int Lq, int Lk) {
  RowPair p;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = r0 + 8 * rr;
    p.lim[rr] = r < Lq ? visible(r, Lq, Lk) : 0;
    p.pad[rr] = r < Lq && qp[r];
  }
  return p;
}

// pads [0, n) of a batch row as bits in shared words (bit i % 32 of word
// i / 32; 0 at and past `end`), a word a warp at a time; the caller's next
// __syncthreads publishes them
template <int NTHR>
__device__ __forceinline__ void pad_words(unsigned* words,
                                          const unsigned char* pad, int n,
                                          int end) {
  const int lane = threadIdx.x & 31;
  for (int w = threadIdx.x >> 5; w < (n + 31) / 32; w += NTHR / 32) {
    const int i = 32 * w + lane;
    const unsigned bits = __ballot_sync(0xffffffffu, i < end && pad[i]);
    if (lane == 0) words[w] = bits;
  }
}

__device__ __forceinline__ bool pad_at(const unsigned* words, int i) {
  return (words[i >> 5] >> (i & 31)) & 1u;
}

// shared bytes of the pad words of n rows (16-byte multiple)
__host__ __device__ inline int pad_word_bytes(int n) {
  return (n + 127) / 128 * 16;
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// A fragments (k16 steps over the head dim) of rows r0 and r0 + 8 of one
// head's columns of x (rows of E bf16); rows at or past n are zeros
template <int DH>
__device__ __forceinline__ void a_frags(uint32_t (&f)[DH / 16][4],
                                        const bf16* x, int r0, int n, int E,
                                        int col0, int t4) {
  const int r1 = r0 + 8;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const int d = col0 + kk * 16 + 2 * t4;
    f[kk][0] = r0 < n ? ld_pair(x + (size_t)r0 * E + d) : 0u;
    f[kk][1] = r1 < n ? ld_pair(x + (size_t)r1 * E + d) : 0u;
    f[kk][2] = r0 < n ? ld_pair(x + (size_t)r0 * E + d + 8) : 0u;
    f[kk][3] = r1 < n ? ld_pair(x + (size_t)r1 * E + d + 8) : 0u;
  }
}

// the same for the 16 shared rows at t (DH + 8 bf16 each), by ldmatrix
template <int DH>
__device__ __forceinline__ void a_frags_shared(uint32_t (&f)[DH / 16][4],
                                               const bf16* t, int lane) {
  const bf16* base =
      t + (((lane >> 3) & 1) * 8 + (lane & 7)) * (DH + 8) + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) ldsm_x4(f[kk], base + kk * 16);
}

// the same from FP32 g, rounded to bf16, each value also written to gb
// (bf16(g) in the layout of g) unless gb is null
template <int DH>
__device__ __forceinline__ void g_frags(uint32_t (&f)[DH / 16][4],
                                        const float* g, bf16* gb, int r0,
                                        int Lq, int E, int col0, int t4) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = r0 + 8 * (c & 1);
      const size_t at = (size_t)r * E + col0 + kk * 16 + 2 * t4 + 8 * (c >> 1);
      f[kk][c] = 0u;
      if (r < Lq) {
        const float2 x = *reinterpret_cast<const float2*>(g + at);
        f[kk][c] = pack_bf16(x.x, x.y);
        if (gb != nullptr) *reinterpret_cast<uint32_t*>(gb + at) = f[kk][c];
      }
    }
}

// rows [r0, r0 + n) of one head's columns of x into shared rows of DH + 8
// bf16 by cp.async (a block of NTHR threads); rows at or past `end` are
// zeros
template <int DH, int NTHR>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* x, int r0,
                                          int n, int end, int E, int col0) {
  constexpr int LD = DH + 8, CPR = DH / 8;  // 16-byte chunks a row
  for (int c = threadIdx.x; c < n * CPR; c += NTHR) {
    const int r = c / CPR, d = (c % CPR) * 8, row = r0 + r;
    const bool ok = row < end;
    cp_async16(dst + r * LD + d, x + (ok ? (size_t)row * E + col0 + d : 0),
               ok);
  }
}

// s[nt] = the warp's 16 rows (A fragments a) times the rows 8nt.. of the
// shared tile t (N rows of DH + 8 bf16) transposed, FP32: logits q k^T,
// dw = g v^T, or their transposes k q^T and v g^T
template <int DH, int N>
__device__ __forceinline__ void tile_product(float (&s)[N / 8][4],
                                             const uint32_t (&a)[DH / 16][4],
                                             const bf16* t, int lane) {
  constexpr int LD = DH + 8;
  // lane's ldmatrix row: tile row 16np + 8 (lane / 16) + lane % 8, columns
  // 16kk + 8 ((lane / 8) % 2): b0, b1 of groups 2np and 2np + 1
  const bf16* base =
      t + (((lane >> 4) << 3) + (lane & 7)) * LD + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[nt][c] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      uint32_t b[4];
      ldsm_x4(b, base + np * 16 * LD + kk * 16);
      const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
      mma_bf16(s[2 * np], a[kk], b0);
      mma_bf16(s[2 * np + 1], a[kk], b1);
    }
}

// acc[dt] += a (16 x 16, one k16 step) times the 16 shared rows at t (DH
// + 8 bf16 each) over all DH columns: the sum runs down the rows, so the
// B fragments come by ldmatrix.trans
template <int DH>
__device__ __forceinline__ void rows_product(float (&acc)[DH / 8][4],
                                             const uint32_t (&a)[4],
                                             const bf16* t, int lane) {
  constexpr int LD = DH + 8;
  const bf16* base = t + (lane & 15) * LD + (lane >> 4) * 8;
#pragma unroll
  for (int dp = 0; dp < DH / 16; ++dp) {
    uint32_t b[4];
    ldsm_x4_t(b, base + dp * 16);
    const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
    mma_bf16(acc[2 * dp], a, b0);
    mma_bf16(acc[2 * dp + 1], a, b1);
  }
}

// two C fragments (8-column groups 2k and 2k + 1) rounded to bf16 as the A
// fragment of one k16 step
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// the logits of the warp's rows x keys [j0, j0 + 64) scaled and masked as
// the plain path: -1e30 where masked, keys past Lk -inf (excluded). A
// tile that every row of the warp sees whole, with no pad pair, is only
// scaled (a warp-uniform test); the key pads come as bits (pad_words) and
// only to a warp holding a pad row.
template <int NT>
__device__ __forceinline__ void mask_tile(float (&s)[NT][4], int j0, int t4,
                                          const RowPair& rows, bool warp_pad,
                                          const unsigned* kwords, int Lk,
                                          float scale) {
  static_assert(NT == 8, "a tile is two pad words");
  const unsigned long long kbits =
      warp_pad ? (unsigned long long)kwords[j0 / 32 + 1] << 32 |
                     kwords[j0 / 32]
               : 0ull;
  const unsigned long long pm[2] = {rows.pad[0] ? kbits : 0ull,
                                    rows.pad[1] ? kbits : 0ull};
  const bool whole = j0 + NT * 8 <= rows.lim[0] && (pm[0] | pm[1]) == 0;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[nt][c] *= scale;
  if (__all_sync(0xffffffffu, whole)) return;  // lim[0] <= lim[1] <= Lk
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int jj = nt * 8 + 2 * t4 + c, j = j0 + jj;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float& x = s[nt][2 * rr + c];
        if (j >= rows.lim[rr] || ((pm[rr] >> jj) & 1)) x = NEG;
        if (j >= Lk) x = -INFINITY;
      }
    }
}

// The first q row, head and batch row of a forward or D-pass block. The
// grid is flat, the q block slowest and the longest (the last rows see
// the most keys) first, so that the card's round-robin hands every SM
// blocks of each length (the q block fastest, the order of a (q block,
// head, batch) grid, gave every SM blocks of one q block and measured
// slower).

struct RowBlock {
  int i0, h, b;
};

__device__ __forceinline__ RowBlock row_block(int Lq, int H, int B) {
  const int nqb = (Lq + FQ - 1) / FQ;
  const int qb = blockIdx.x / (H * B), hb = blockIdx.x % (H * B);
  return RowBlock{(nqb - 1 - qb) * FQ, hb % H, hb / H};
}

// the normalized weight of a logit, e / sum(e), as e (the SFU's exp2 of
// the scaled difference) times the sum's reciprocal, rounded once a row
__device__ __forceinline__ float weight(float x, float m, float inv_l) {
  return __expf(x - m) * inv_l;
}

template <int DH>
__global__ void __launch_bounds__(32 * RG * kgf(DH), fwd_minb(DH))
    rect_attn_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const unsigned char* __restrict__ qpad,
                       const unsigned char* __restrict__ kpad,
                       float* __restrict__ out, float* __restrict__ mrow,
                       float* __restrict__ lrow, int B, int Lq, int Lk,
                       int H, float scale) {
  constexpr int KG = kgf(DH), R_THREADS = 32 * RG * KG;
  constexpr int LD = DH + 8, KS = DH / 16, NT = FK / 8, DT = DH / 8;
  constexpr int TILE = 2 * FK * LD;  // bf16 of a tile's K and V
  constexpr int STAGE = KG * TILE;   // a ring stage: a tile a key group
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  float* part = reinterpret_cast<float*>(ring + STAGES * STAGE);
  unsigned* kwords = reinterpret_cast<unsigned*>(part + 2 * KG * FQ);
  __shared__ int s_fu;
  const RowBlock rb = row_block(Lq, H, B);
  const int i0 = rb.i0, h = rb.h, b = rb.b;
  const int E = H * DH, col0 = h * DH;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = warp % RG, kg = warp / RG;  // row group, key group
  const int g = lane >> 2, t4 = lane & 3;
  const bf16* qb = q + (size_t)b * Lq * E;
  const bf16* kb = k + (size_t)b * Lk * E;
  const bf16* vb = v + (size_t)b * Lk * E;
  const unsigned char* qp = qpad + (size_t)b * Lq;
  const unsigned char* kp = kpad + (size_t)b * Lk;

  const int fu = first_unpadded(kp, Lk, &s_fu);
  const int i_end = min(i0 + FQ, Lq);
  const int kend = tile_has_full_row(qp, i0, FQ, Lq, Lk, fu)
                       ? Lk
                       : visible(i_end - 1, Lq, Lk);
  const int ntiles = (kend + FK - 1) / FK;
  const int nsteps = (ntiles + KG - 1) / KG;  // steps a pass: KG tiles each
  const int steps = 2 * nsteps;  // pass A over the tiles, then pass B
  pad_words<R_THREADS>(kwords, kp, ntiles * FK, Lk);

  // step u's tiles into its stage, key group j's tile KG p + j: K, and in
  // pass B V beside it
  auto load = [&](int u) {
    bf16* st = ring + (u % STAGES) * STAGE;
    const bool pass_b = u >= nsteps;
    const int p = pass_b ? u - nsteps : u;
#pragma unroll
    for (int j = 0; j < KG; ++j) {
      const int t = KG * p + j;
      if (t >= ntiles) break;
      load_rows<DH, R_THREADS>(st + j * TILE, kb, t * FK, FK, Lk, E, col0);
      if (pass_b)
        load_rows<DH, R_THREADS>(st + j * TILE + FK * LD, vb, t * FK, FK, Lk,
                                 E, col0);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }

  // this warp's rows r0 = i0 + 16 rg + g and r0 + 8: Q as A fragments,
  // the mask, the running max and (per-thread partial) sum of its key
  // group's tiles
  const int lr0 = rg * 16 + g, r0 = i0 + lr0;  // row in the block, in Lq
  const RowPair rows = row_pair(qp, r0, Lq, Lk);
  const bool warp_pad = __any_sync(0xffffffffu, rows.pad[0] || rows.pad[1]);
  uint32_t qf[KS][4];
  a_frags<DH>(qf, qb, r0, Lq, E, col0, t4);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, il[2];
  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[dt][c] = 0.f;

  for (int u = 0; u < steps; ++u) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step u's tiles landed; every warp is done with u - 1
    if (u + STAGES - 1 < steps) load(u + STAGES - 1);
    cp_async_commit();
    const bool pass_b = u >= nsteps;
    if (u == nsteps) {  // the key groups' max and sum merged, group order
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = lr0 + 8 * rr;
        m[rr] = -INFINITY;
        l[rr] = 0.f;
#pragma unroll
        for (int j = 0; j < KG; ++j) m[rr] = fmaxf(m[rr], part[2 * j * FQ + r]);
#pragma unroll
        for (int j = 0; j < KG; ++j)
          l[rr] += part[(2 * j + 1) * FQ + r] *
                   __expf(part[2 * j * FQ + r] - m[rr]);
        il[rr] = __frcp_rn(l[rr]);
      }
    }
    const int t = KG * (pass_b ? u - nsteps : u) + kg;  // this warp's tile
    if (t < ntiles) {
      const bf16* ks = ring + (u % STAGES) * STAGE + kg * TILE;
      float s[NT][4];
      tile_product<DH, FK>(s, qf, ks, lane);
      mask_tile(s, t * FK, t4, rows, warp_pad, kwords, Lk, scale);
      if (!pass_b) {  // the row max and sum, rescaled as the max grows
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float mt = -INFINITY;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mt = fmaxf(mt, fmaxf(s[nt][2 * rr], s[nt][2 * rr + 1]));
          const float mn = fmaxf(m[rr], quad_max(mt));
          l[rr] *= __expf(m[rr] - mn);
          m[rr] = mn;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            l[rr] +=
                __expf(s[nt][2 * rr] - mn) + __expf(s[nt][2 * rr + 1] - mn);
        }
      } else {  // pass B: w = e / l rounded to bf16 in registers; O += w V
        const bf16* vs = ks + FK * LD;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            s[nt][c] = weight(s[nt][c], m[c >> 1], il[c >> 1]);
#pragma unroll
        for (int kk = 0; kk < FK / 16; ++kk) {
          uint32_t a[4];
          c_to_a(a, s[2 * kk], s[2 * kk + 1]);
          rows_product<DH>(o, a, vs + kk * 16 * LD, lane);
        }
      }
    }
    if (u == nsteps - 1) {  // this key group's max and sum, for the merge
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        l[rr] = quad_sum(l[rr]);
        if (t4 == 0) {
          part[2 * kg * FQ + lr0 + 8 * rr] = m[rr];
          part[(2 * kg + 1) * FQ + lr0 + 8 * rr] = l[rr];
        }
      }
    }
  }
  cp_async_wait<0>();

  // the key groups' contexts summed in group order: groups 1.. through
  // shared memory (the ring's), group 0 adds and writes
  float* obuf = reinterpret_cast<float*>(ring);
  __syncthreads();  // every warp is done with the ring
  if (kg > 0) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int dt = 0; dt < DT; ++dt)
        *reinterpret_cast<float2*>(
            obuf + ((kg - 1) * FQ + lr0 + 8 * rr) * DH + dt * 8 + 2 * t4) =
            make_float2(o[dt][2 * rr], o[dt][2 * rr + 1]);
  }
  __syncthreads();
  if (kg > 0) return;
  float* ob = out + (size_t)b * Lq * E + col0 + 2 * t4;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = r0 + 8 * rr;
    if (r >= Lq) continue;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      float2 x = make_float2(o[dt][2 * rr], o[dt][2 * rr + 1]);
#pragma unroll
      for (int j = 1; j < KG; ++j) {
        const float2 y = *reinterpret_cast<const float2*>(
            obuf + ((j - 1) * FQ + lr0 + 8 * rr) * DH + dt * 8 + 2 * t4);
        x.x += y.x;
        x.y += y.y;
      }
      *reinterpret_cast<float2*>(ob + (size_t)r * E + dt * 8) = x;
    }
    if (mrow != nullptr && t4 == 0) {
      const size_t at = ((size_t)b * H + h) * Lq + r;
      mrow[at] = m[rr];
      lrow[at] = l[rr];
    }
  }
}

// D[b, h, i] = sum over keys of w dw, and gb = bf16(g): see the source note
template <int DH>
__global__ void __launch_bounds__(32 * RG * KGD, d_minb(DH))
    rect_attn_bwd_d_bf16(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const unsigned char* __restrict__ qpad,
                         const unsigned char* __restrict__ kpad,
                         const float* __restrict__ g,
                         const float* __restrict__ mrow,
                         const float* __restrict__ lrow,
                         float* __restrict__ Drow, bf16* __restrict__ gb,
                         int B, int Lq, int Lk, int H, float scale) {
  constexpr int KG = KGD, R_THREADS = 32 * RG * KG;
  constexpr int LD = DH + 8, KS = DH / 16, NT = FK / 8;
  constexpr int TILE = 2 * FK * LD;
  constexpr int STAGE = KG * TILE;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  float* part = reinterpret_cast<float*>(ring + STAGES * STAGE);
  unsigned* kwords = reinterpret_cast<unsigned*>(part + 2 * KG * FQ);
  const RowBlock rb = row_block(Lq, H, B);
  const int i0 = rb.i0, h = rb.h, b = rb.b;
  const int E = H * DH, col0 = h * DH;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = warp % RG, kg = warp / RG;
  const int g8 = lane >> 2, t4 = lane & 3;
  const size_t bq = (size_t)b * Lq * E;
  const bf16* kb = k + (size_t)b * Lk * E;
  const bf16* vb = v + (size_t)b * Lk * E;
  const unsigned char* qp = qpad + (size_t)b * Lq;
  const unsigned char* kp = kpad + (size_t)b * Lk;

  const int ntiles = (visible(min(i0 + FQ, Lq) - 1, Lq, Lk) + FK - 1) / FK;
  const int steps = (ntiles + KG - 1) / KG;
  pad_words<R_THREADS>(kwords, kp, ntiles * FK, Lk);
  auto load = [&](int u) {
    bf16* st = ring + (u % STAGES) * STAGE;
#pragma unroll
    for (int j = 0; j < KG; ++j) {
      const int t = KG * u + j;
      if (t >= ntiles) break;
      load_rows<DH, R_THREADS>(st + j * TILE, kb, t * FK, FK, Lk, E, col0);
      load_rows<DH, R_THREADS>(st + j * TILE + FK * LD, vb, t * FK, FK, Lk,
                               E, col0);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }

  const int lr0 = rg * 16 + g8, r0 = i0 + lr0;
  const RowPair rows = row_pair(qp, r0, Lq, Lk);
  const bool warp_pad = __any_sync(0xffffffffu, rows.pad[0] || rows.pad[1]);
  uint32_t qf[KS][4], gf[KS][4];
  a_frags<DH>(qf, q + bq, r0, Lq, E, col0, t4);
  g_frags<DH>(gf, g + bq, kg == 0 ? gb + bq : nullptr, r0, Lq, E, col0, t4);
  float m[2], il[2], d[2] = {0.f, 0.f};
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = r0 + 8 * rr;
    const size_t at = ((size_t)b * H + h) * Lq + r;
    m[rr] = r < Lq ? mrow[at] : 0.f;
    il[rr] = r < Lq ? __frcp_rn(lrow[at]) : 0.f;
  }

  for (int u = 0; u < steps; ++u) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (u + STAGES - 1 < steps) load(u + STAGES - 1);
    cp_async_commit();
    const int t = KG * u + kg;
    if (t >= ntiles) continue;
    const bf16* ks = ring + (u % STAGES) * STAGE + kg * TILE;
    float s[NT][4], dw[NT][4];
    tile_product<DH, FK>(s, qf, ks, lane);
    tile_product<DH, FK>(dw, gf, ks + FK * LD, lane);
    mask_tile(s, t * FK, t4, rows, warp_pad, kwords, Lk, scale);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        d[c >> 1] += weight(s[nt][c], m[c >> 1], il[c >> 1]) * dw[nt][c];
  }
  cp_async_wait<0>();
  // the key groups' sums added in group order through shared memory
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    d[rr] = quad_sum(d[rr]);
    if (kg > 0 && t4 == 0) part[(kg - 1) * FQ + lr0 + 8 * rr] = d[rr];
  }
  __syncthreads();
  if (kg > 0) return;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = r0 + 8 * rr;
#pragma unroll
    for (int j = 1; j < KG; ++j) d[rr] += part[(j - 1) * FQ + lr0 + 8 * rr];
    if (r < Lq && t4 == 0) Drow[((size_t)b * H + h) * Lq + r] = d[rr];
  }
}

// dK, dV and the dQ partials of one key block: see the source note
template <int DH>
__global__ void __launch_bounds__(K_THREADS, kv_minb(DH))
    rect_attn_bwd_kv_bf16(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const unsigned char* __restrict__ qpad,
                          const unsigned char* __restrict__ kpad,
                          const bf16* __restrict__ gb,
                          const float* __restrict__ mrow,
                          const float* __restrict__ lrow,
                          const float* __restrict__ Drow,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          float* __restrict__ ws, int B, int Lq, int Lk,
                          int H, int R, float scale) {
  constexpr int LD = DH + 8;   // bf16 rows of K, V, Q and G in shared memory
  constexpr int LDS = BK + 8;  // bf16 rows of dS
  constexpr int KS = DH / 16, DT = DH / 8, NQ = BQ / 8, MQ = BQ / 16;
  // dQ 8-column groups a warp; under Dh 64 there are fewer groups than
  // warps and the last warps take none
  constexpr int PPW = DT >= KW ? DT / KW : 1;
  static_assert((DT < KW || DT % KW == 0) && (PPW == 1 || PPW % 2 == 0),
                "dQ columns a warp");
  constexpr int STAGE_BYTES = 2 * BQ * LD * 2 + 3 * BQ * 4;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + BK * LD;
  unsigned char* ring = reinterpret_cast<unsigned char*>(Vs + BK * LD);
  bf16* dSs = reinterpret_cast<bf16*>(ring + STAGES * STAGE_BYTES);
  const int nqt = (Lq + BQ - 1) / BQ;
  unsigned* qwords = reinterpret_cast<unsigned*>(dSs + BQ * LDS);
  int* full = reinterpret_cast<int*>(qwords + pad_word_bytes(Lq) / 4);
  int* tiles = full + nqt;
  __shared__ int s_fu, s_ntl;

  // key blocks in order of their q range, the longest first
  const int jb = blockIdx.x / (B * H), bh = blockIdx.x % (B * H);
  const int b = bh / H, h = bh % H;
  const int j0 = jb * BK, E = H * DH, col0 = h * DH;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const size_t rows = (size_t)bh * Lq;
  const bf16* qb = q + (size_t)b * Lq * E;
  const bf16* gbb = gb + (size_t)b * Lq * E;
  const bf16* kb = k + (size_t)b * Lk * E;
  const bf16* vb = v + (size_t)b * Lk * E;
  const unsigned char* qp = qpad + (size_t)b * Lq;
  const unsigned char* kp = kpad + (size_t)b * Lk;

  // K and V of the block, in the first group: the warps' A fragments of
  // S^T and dW^T, and K the dQ product's B operand
  load_rows<DH, K_THREADS>(Ks, kb, j0, BK, Lk, E, col0);
  load_rows<DH, K_THREADS>(Vs, vb, j0, BK, Lk, E, col0);

  // the q tiles to visit, in order: those that see a key of the block
  // (from the tile of row r0 on), and before them each tile holding a
  // row whose every key is masked (it averages over all Lk keys: dV only)
  pad_words<K_THREADS>(qwords, qp, Lq, Lq);
  const int fu = first_unpadded(kp, Lk, &s_fu);
  const int r0 = first_row(jb, Lq, Lk), q_first = r0 / BQ;
  for (int t = threadIdx.x; t < nqt; t += K_THREADS) full[t] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < q_first * BQ; i += K_THREADS)
    if (pad_at(qwords, i) && fu >= visible(i, Lq, Lk)) full[i / BQ] = 1;
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int base = 0; base < nqt; base += 32) {
      const int qt = base + lane;
      const bool need = qt < nqt && (qt >= q_first || full[qt]);
      const unsigned bal = __ballot_sync(0xffffffffu, need);
      if (need) tiles[n + __popc(bal & ((1u << lane) - 1u))] = qt;
      n += __popc(bal);
    }
    if (lane == 0) s_ntl = n;
  }
  const int off = ws_rows_before(jb, Lq, Lk);
  __syncthreads();
  const int ntl = s_ntl;
  // row i (>= r0) of this block's dQ partials
  float* wsb = ws + ((size_t)bh * R + off - r0) * DH;

  // q tile qt's Q and bf16(g) rows, then its rows' m, l and D, into stage s
  auto load = [&](int s, int qt) {
    unsigned char* st = ring + (s % STAGES) * STAGE_BYTES;
    bf16* qs = reinterpret_cast<bf16*>(st);
    float* rs = reinterpret_cast<float*>(qs + 2 * BQ * LD);
    const int i0 = qt * BQ;
    load_rows<DH, K_THREADS>(qs, qb, i0, BQ, Lq, E, col0);
    load_rows<DH, K_THREADS>(qs + BQ * LD, gbb, i0, BQ, Lq, E, col0);
    for (int c = threadIdx.x; c < 3 * BQ; c += K_THREADS) {
      const int row = i0 + c % BQ;
      const float* src = c < BQ ? mrow : c < 2 * BQ ? lrow : Drow;
      const bool ok = row < Lq;
      cp_async4(rs + c, src + rows + (ok ? row : 0), ok);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntl) load(s, tiles[s]);
    cp_async_commit();
  }

  // this warp's keys ka and ka + 8 of the block
  const int ka = warp * 16 + g8;
  const int jk[2] = {j0 + ka, j0 + ka + 8};
  const bool kin[2] = {jk[0] < Lk, jk[1] < Lk};
  const bool kpd[2] = {kin[0] && kp[jk[0]], kin[1] && kp[jk[1]]};
  const long long jL[2] = {(long long)jk[0] * Lq, (long long)jk[1] * Lq};
  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int c = 0; c < 4; ++c) dka[dt][c] = dva[dt][c] = 0.f;

  for (int t = 0; t < ntl; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage t landed; every warp is done with step t - 1
    if (t + STAGES - 1 < ntl) load(t + STAGES - 1, tiles[t + STAGES - 1]);
    cp_async_commit();
    const unsigned char* st = ring + (t % STAGES) * STAGE_BYTES;
    const bf16* Qs = reinterpret_cast<const bf16*>(st);
    const bf16* Gs = Qs + BQ * LD;
    const float* Ms = reinterpret_cast<const float*>(Gs + BQ * LD);
    const float* Ls = Ms + BQ;
    const float* Ds = Ls + BQ;
    const int i0 = tiles[t] * BQ;
    const bool vis = tiles[t] >= q_first;  // else every pair is masked

    // S^T = K Q^T and dW^T = V G^T: s[nt] and dw[nt] hold keys (ka, ka +
    // 8) x q rows i0 + 8nt + (2t4, 2t4 + 1)
    float s[NQ][4], dw[NQ][4];
    if (vis) {
      uint32_t af[KS][4];
      a_frags_shared<DH>(af, Ks + warp * 16 * LD, lane);
      tile_product<DH, BQ>(s, af, Qs, lane);
      a_frags_shared<DH>(af, Vs + warp * 16 * LD, lane);
      tile_product<DH, BQ>(dw, af, Gs, lane);
    } else {
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[nt][c] = dw[nt][c] = 0.f;
    }

    // w^T from the forward's max and sum, dS^T = w^T (dW^T - D), zero
    // where the mask is set; key columns past Lk are excluded (w = 0)
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = nt * 8 + 2 * t4 + c, i = i0 + col;
        const bool in = i < Lq;
        const float mq = Ms[col], Dq = Ds[col];
        const float il = in ? __frcp_rn(Ls[col]) : 0.f;
        const bool qpi = in && pad_at(qwords, i);
        const long long iL = (long long)(i + 1) * Lk;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int e = 2 * rr + c;
          const bool masked = jL[rr] >= iL || (qpi && kpd[rr]);
          const float x = masked ? NEG : s[nt][e] * scale;
          const float w = kin[rr] && in ? weight(x, mq, il) : 0.f;
          dw[nt][e] = masked ? 0.f : w * (dw[nt][e] - Dq);
          s[nt][e] = w;
        }
      }

    // dV += bf16(w)^T G and dK += bf16(dS)^T Q over the step's q rows, 16
    // at a time
#pragma unroll
    for (int kq = 0; kq < MQ; ++kq) {
      uint32_t a[4];
      c_to_a(a, s[2 * kq], s[2 * kq + 1]);
      rows_product<DH>(dva, a, Gs + kq * 16 * LD, lane);
      if (vis) {
        c_to_a(a, dw[2 * kq], dw[2 * kq + 1]);
        rows_product<DH>(dka, a, Qs + kq * 16 * LD, lane);
      }
    }
    if (vis) {
      // bf16(dS) for the dQ product, rows q, columns keys
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dSs[(nt * 8 + 2 * t4 + (e & 1)) * LDS + ka + 8 * (e >> 1)] =
              __float2bfloat16(dw[nt][e]);
      __syncthreads();  // dS complete

      // this block's part of dQ for the step's rows, dS K over its BK
      // keys, into the workspace; each warp takes PPW 8-column groups
      if (warp * PPW >= DT) continue;  // no group for this warp (Dh 16)
      float acc[MQ][PPW][4];
#pragma unroll
      for (int mt = 0; mt < MQ; ++mt)
#pragma unroll
        for (int u = 0; u < PPW; ++u)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[mt][u][c] = 0.f;
      const bf16* arow =
          dSs + (((lane >> 3) & 1) * 8 + (lane & 7)) * LDS + (lane >> 4) * 8;
      const bf16* brow = Ks + (lane & 15) * LD + warp * PPW * 8;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t bq[PPW][2];
        if constexpr (PPW == 1) {
          ldsm_x2_t(bq[0], brow + kk * 16 * LD);
        } else {
#pragma unroll
          for (int pr = 0; pr < PPW / 2; ++pr) {
            uint32_t bf[4];
            ldsm_x4_t(bf, brow + kk * 16 * LD + pr * 16 + (lane >> 4) * 8);
            bq[2 * pr][0] = bf[0], bq[2 * pr][1] = bf[1];
            bq[2 * pr + 1][0] = bf[2], bq[2 * pr + 1][1] = bf[3];
          }
        }
#pragma unroll
        for (int mt = 0; mt < MQ; ++mt) {
          uint32_t af[4];
          ldsm_x4(af, arow + mt * 16 * LDS + kk * 16);
#pragma unroll
          for (int u = 0; u < PPW; ++u) mma_bf16(acc[mt][u], af, bq[u]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < MQ; ++mt)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = i0 + mt * 16 + g8 + 8 * rr;
          if (i < r0 || i >= Lq) continue;
#pragma unroll
          for (int u = 0; u < PPW; ++u)
            *reinterpret_cast<float2*>(wsb + (size_t)i * DH +
                                       (warp * PPW + u) * 8 + 2 * t4) =
                make_float2(acc[mt][u][2 * rr], acc[mt][u][2 * rr + 1]);
        }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (!kin[rr]) continue;
    const size_t at = ((size_t)b * Lk + jk[rr]) * E + col0 + 2 * t4;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      *reinterpret_cast<uint32_t*>(dk + at + dt * 8) = pack_bf16(
          dka[dt][2 * rr] * scale, dka[dt][2 * rr + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + at + dt * 8) =
          pack_bf16(dva[dt][2 * rr], dva[dt][2 * rr + 1]);
    }
  }
}

// a forward or D-pass block's shared bytes at KG key groups: the ring (a
// tile a key group a stage), the key groups' row maxima and sums, the key
// pad words
template <int DH>
int row_pass_smem(int KG, int Lk) {
  return STAGES * KG * 2 * FK * (DH + 8) * (int)sizeof(bf16) +
         2 * KG * FQ * (int)sizeof(float) +
         pad_word_bytes((Lk + FK - 1) / FK * FK);
}

template <int DH>
int forward(const bf16* q, const bf16* k, const bf16* v,
            const unsigned char* qpad, const unsigned char* kpad, float* out,
            float* mrow, float* lrow, int B, int Lq, int Lk, int H,
            float scale, cudaStream_t stream) {
  constexpr int KG = kgf(DH);
  const int smem = row_pass_smem<DH>(KG, Lk);
  cudaError_t err = set_smem(rect_attn_fwd_bf16<DH>, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((Lq + FQ - 1) / FQ * H * B);
  rect_attn_fwd_bf16<DH><<<grid, 32 * RG * KG, smem, stream>>>(
      q, k, v, qpad, kpad, out, mrow, lrow, B, Lq, Lk, H, scale);
  return (int)cudaGetLastError();
}

// The backward's scratch, one allocation: D (B, H, Lq) FP32, bf16(g) (B,
// Lq, E), the dQ workspace (B, H, ws_rows, Dh) FP32; each part 256-byte
// aligned
struct Scratch {
  size_t g_at, ws_at, bytes;
};

Scratch scratch_of(int B, int Lq, int Lk, int E, int H) {
  auto up = [](size_t n) { return (n + 255) / 256 * 256; };
  const size_t d = up((size_t)4 * B * H * Lq);
  const size_t g = up((size_t)2 * B * Lq * E);
  return Scratch{d, d + g, d + g + (size_t)4 * B * E * ws_rows(Lq, Lk)};
}

template <int DH>
int backward(const bf16* q, const bf16* k, const bf16* v,
             const unsigned char* qpad, const unsigned char* kpad,
             const float* g, const float* mrow, const float* lrow, bf16* dq,
             bf16* dk, bf16* dv, unsigned char* scratch, int B, int Lq,
             int Lk, int H, float scale, cudaStream_t stream) {
  const Scratch sc = scratch_of(B, Lq, Lk, H * DH, H);
  float* D = reinterpret_cast<float*>(scratch);
  bf16* gb = reinterpret_cast<bf16*>(scratch + sc.g_at);
  float* ws = reinterpret_cast<float*>(scratch + sc.ws_at);

  const int smem_d = row_pass_smem<DH>(KGD, Lk);
  cudaError_t err = set_smem(rect_attn_bwd_d_bf16<DH>, smem_d);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid_d = (unsigned)((Lq + FQ - 1) / FQ * H * B);
  rect_attn_bwd_d_bf16<DH><<<grid_d, 32 * RG * KGD, smem_d, stream>>>(
      q, k, v, qpad, kpad, g, mrow, lrow, D, gb, B, Lq, Lk, H, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  constexpr int LD = DH + 8;
  const int R = (int)ws_rows(Lq, Lk);
  const int nqt = (Lq + BQ - 1) / BQ, nkb = (Lk + BK - 1) / BK;
  const int smem = 2 * BK * LD * 2 + STAGES * (2 * BQ * LD * 2 + 3 * BQ * 4) +
                   BQ * (BK + 8) * 2 + pad_word_bytes(Lq) +
                   2 * nqt * (int)sizeof(int);
  if ((err = set_smem(rect_attn_bwd_kv_bf16<DH>, smem)) != cudaSuccess)
    return (int)err;
  rect_attn_bwd_kv_bf16<DH><<<(unsigned)(nkb * B * H), K_THREADS, smem,
                              stream>>>(q, k, v, qpad, kpad, gb, mrow, lrow,
                                        D, dk, dv, ws, B, Lq, Lk, H, R,
                                        scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)launch_dq_sum<DH>(ws, dq, B, Lq, Lk, H, R, scale, stream);
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// rect_tiles.cuh's shapes, and the row passes' flat grid fits
bool shape_ok(int B, int Lq, int Lk, int E, int H) {
  return rect_shape_ok(B, Lq, Lk, E, H) &&
         (long long)((Lq + FQ - 1) / FQ) * H * B < (1LL << 31);
}

}  // namespace

extern "C" {

// q (B, Lq, E), k, v (B, Lk, E) bf16, 16-byte aligned; pads (B, Lq), (B,
// Lk) bytes (1 = pad). Writes the context out (B, Lq, E) FP32 and, when
// mrow / lrow are not null, each row's softmax max and sum, (B, H, Lq)
// each. Head dim E / H 16, 32, 64, 128 or 256 (ops/rect_attention.py pads
// any other up to the next with zero columns); scale: the logits' factor,
// 1/sqrt of the unpadded head dim rounded once. Returns 0 or the first
// CUDA error code.
int rect_attention_forward_bf16(const bf16* q, const bf16* k, const bf16* v,
                                const unsigned char* qpad,
                                const unsigned char* kpad, float* out,
                                float* mrow, float* lrow, int B, int Lq,
                                int Lk, int E, int H, float scale,
                                void* stream_ptr) {
  if (!shape_ok(B, Lq, Lk, E, H) || !aligned(q, 16) ||
      !aligned(k, 16) || !aligned(v, 16) || !aligned(out, 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream_ptr;
#define RECT_FWD(D)                                                       \
  case D:                                                                 \
    return forward<D>(q, k, v, qpad, kpad, out, mrow, lrow, B, Lq, Lk, H, \
                      scale, s);
  switch (E / H) {
    RECT_FWD(16)
    RECT_FWD(32)
    RECT_FWD(64)
    RECT_FWD(128)
    RECT_FWD(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RECT_FWD
}

// Bytes of the backward's scratch for these shapes (-1 if none).
long long rect_attention_bf16_backward_workspace_bytes(int B, int Lq, int Lk,
                                                       int E, int H) {
  if (!shape_ok(B, Lq, Lk, E, H)) return -1;
  return (long long)scratch_of(B, Lq, Lk, E, H).bytes;
}

// From the forward's mrow, lrow and the context's cotangent g (B, Lq, E)
// FP32: dq (B, Lq, E), dk, dv (B, Lk, E) bf16. scratch: the bytes
// rect_attention_bf16_backward_workspace_bytes gives, 256-byte aligned;
// head dims and scale as the forward's.
int rect_attention_backward_bf16(const bf16* q, const bf16* k, const bf16* v,
                                 const unsigned char* qpad,
                                 const unsigned char* kpad, const float* g,
                                 const float* mrow, const float* lrow,
                                 bf16* dq, bf16* dk, bf16* dv, void* scratch,
                                 int B, int Lq, int Lk, int E, int H,
                                 float scale, void* stream_ptr) {
  if (!shape_ok(B, Lq, Lk, E, H) || !aligned(q, 16) ||
      !aligned(k, 16) || !aligned(v, 16) || !aligned(g, 8) ||
      !aligned(dq, 8) || !aligned(dk, 4) || !aligned(dv, 4) ||
      !aligned(scratch, 256) || mrow == nullptr || lrow == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream_ptr;
  unsigned char* sc = static_cast<unsigned char*>(scratch);
#define RECT_BWD(D)                                                          \
  case D:                                                                    \
    return backward<D>(q, k, v, qpad, kpad, g, mrow, lrow, dq, dk, dv, sc, B, \
                       Lq, Lk, H, scale, s);
  switch (E / H) {
    RECT_BWD(16)
    RECT_BWD(32)
    RECT_BWD(64)
    RECT_BWD(128)
    RECT_BWD(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RECT_BWD
}

}  // extern "C"
