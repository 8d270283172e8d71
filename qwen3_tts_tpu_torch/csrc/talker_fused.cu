// The talker's decode step, every layer in ONE persistent cooperative
// launch: replaces the Pallas kernel qwen3_tts_tpu/ops/talker_fused.py::
// talker_step_fused (all 28 layers of one decode step in one program).
//
// What bounds it on the H100: bytes. A step reads every layer's bf16
// weights once (28 x 15.7 M values = 881 MB at the 0.6B widths, 0.26 ms at
// 3.35 TB/s) plus the K/V rows attention needs (4 KiB per slot, stream and
// layer: 235 MB at B = 8 and read_ctx 256, 4.2 GB at B = 32 and 1,152).
// Its products have M = B rows, far under the ~295 flop/byte ridge, so
// they are bandwidth work as long as the weights stream at HBM rate and
// the products run on tensor cores (f32 FMA makes one pass over the
// weights per 8 rows of streams). So the design:
// - one cooperative launch of about two CTAs per SM (sized by occupancy)
//   runs the layer loop itself; a grid-wide barrier ends each of the 7
//   phases of a layer (196 barriers a step at 28 layers):
//    1. residual (+ the previous layer's down-projection K splits),
//       RMSNorm, bf16 -> abuf, one CTA per stream;
//    2. the QKV product;
//    3. attention per (stream, kv head, S split) into partials (m, l,
//       acc). Each item first sums its QKV K splits and applies the head
//       norms and NEOX RoPE; the split whose tiles hold slot widx also
//       writes the K/V row there in place (int8: rounded half to even,
//       rintf, with its f32 scale) before it copies a tile;
//    4. the wo product, whose A tile is the merge of the S splits of one
//       query head (an item's K span of 128 rows is that head), rounded
//       to bf16;
//    5. residual (+ wo's K splits) + RMSNorm -> abuf;
//    6. the gate/up product;
//    7. the down product, whose A tile is bf16(silu(g) * u) of its K rows,
//       summed from gate/up's K splits; its residual add is step 1 of the
//       next layer (or the final pass).
// - products on tensor cores: mma.sync.m16n8k16 bf16 -> f32 through the
//   item walk, ring loop and partial-sum epilogue of csrc/mma_ring.cuh,
//   which the code predictor shares. An item is 64 output columns (one n8
//   slice a warp) x a K span; the spans fit the ~264-CTA grid: QKV 256
//   rows (64 x 4 = 256 items), wo 128 (16 x 16 = 256), gate/up 256 (96 x
//   4 = 384: 3 items on most SMs, as 768 items of 128 rows would be, with
//   half the partials; spans of 512, one item a CTA, were no faster on an
//   H100), down 192 (16 x 16 = 256). Weights stream through
//   an 8-stage cp.async ring of [64 K rows][64 columns] chunks (XOR-
//   swizzled 16-byte chunks, B fragments by ldmatrix.x2.trans on the
//   [K, N] row-major weights, the JAX layout, nothing packed); the A tile
//   of an item (up to 64 rows of streams x its K span, bf16, swizzled) is
//   built in shared memory while its weights land: a copy of abuf, the
//   split merge (wo) or the silu product (down). Rows go in groups of 64
//   (4 m16 tiles, zero past B: any B >= 1); a further group streams the
//   item's weights again (from L2). Split-K partial sums go to scratch
//   (part0 for QKV and gate/up, part1 for wo and down, so that down's A
//   build reads gate/up's partials while it writes its own) and the
//   consuming phase adds them in a fixed order: no atomics, deterministic.
//   The scratch sizes follow from the spans: q3_talker_scratch gives them
//   to the wrapper;
// - weights in flight across the barrier: a product's weights depend on
//   nothing the launch computes and a CTA knows its items statically
//   (it = blockIdx.x + i * gridDim.x), so each CTA, once its own work in
//   the phase before is done and its shared memory is free, issues the
//   cp.async of its first 7 weight chunks (56 KB, 112 KB a SM) of the
//   next product before it arrives at the barrier (QKV's across the norm
//   phase, which uses no dynamic shared memory). After the barrier it
//   builds its A tile and runs. (On an H100 this shortened each product
//   by 2-3 us and lengthened the phase before it by nearly as much: 1-2%
//   of a step at B = 8 and 32.)
// - attention items take the head norms over: with n_split splits a
//   (stream, kv head), its queries are normed and roped n_split times,
//   which costs less than a phase and its grid barrier;
// - attention copies tiles of 64 slots of K and V into shared memory with
//   cp.async (the ring's memory), the next tile in flight while this one
//   is scored. Scores, softmax and P.V in f32: P stays f32 before the PV
//   product, as in csrc/flash_decode.cu, where the TPU kernel rounds it to
//   bf16. The current row is read back from the cache like any other
//   slot, which gives the TPU kernel's current-row term (the dequantized
//   row for int8);
// - every read of data written in the launch goes through L2 (__ldcg,
//   cp.async.cg): L1 is not coherent across SMs; positions, n_valid,
//   widx and valid_mask are read from device memory, so a step needs no
//   host sync. Nothing at or past read_ctx is read. An optional clock
//   (phase_ns) times each phase kind.
// Numerics as the TPU kernel: xn rounded to bf16 before each product, f32
// accumulation, head norms, RoPE and softmax in f32, the attention output
// rounded to bf16 before wo, bf16(silu(g) * u) before down.

#include <cooperative_groups.h>
#include <math_constants.h>

#include <algorithm>

#include "attn_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int TF_THREADS = 256;
constexpr int TF_WARPS = TF_THREADS / 32;
constexpr int TF_D = 128;        // head dim
constexpr int TF_G = 2;          // query heads per kv head
constexpr int AT_ROWS = ATTN_TILE_ROWS;  // attention tile: cache slots
// products (items of PROD_NT columns, csrc/mma_ring.cuh)
constexpr int NST = 8;           // ring stages (7 in flight ahead)
constexpr int W_STAGE = PROD_KC * PROD_NT * 2;
constexpr int RING_BYTES = NST * W_STAGE;             // 64 KB
// each product's K span per item: the plan of the source note, and the
// scratch sizes q3_talker_scratch gives
constexpr int SPAN_QKV = 256, SPAN_WO = 128, SPAN_GU = 256, SPAN_DOWN = 192;
constexpr int SPAN_MAX = 256;
constexpr int A_BYTES = PROD_MG * SPAN_MAX * 2;   // an item's A tile
constexpr int SMEM_BYTES = RING_BYTES + A_BYTES;
// attention's S splits a query head, at most: wo's merge keeps a weight
// per (row, split) and a sum per row beside its A tile
constexpr int MAX_SPLIT = 60;
static_assert(TF_G * TF_D == TF_THREADS, "P.V maps a thread to (head, dim)");
static_assert(AT_ROWS * 4 == TF_THREADS, "scores map 4 threads to a slot");
static_assert(PROD_NT == TF_WARPS * 8, "one n8 slice a warp");
static_assert(SPAN_WO == TF_D, "a wo item's K span is one query head");
static_assert(3 * SPAN_WO == 2 * SPAN_DOWN,
              "wo (K 2H) and down (K 3H) leave the same K splits");
static_assert(SPAN_QKV % PROD_KC == 0 && SPAN_WO % PROD_KC == 0 &&
              SPAN_GU % PROD_KC == 0 && SPAN_DOWN % PROD_KC == 0 &&
              SPAN_QKV <= SPAN_MAX && SPAN_GU <= SPAN_MAX &&
              SPAN_DOWN <= SPAN_MAX, "spans of whole ring chunks");
static_assert(4 * AT_ROWS * TF_D * 2 <= RING_BYTES, "attention tiles fit");
static_assert(PROD_MG * (SPAN_WO * 2 + (MAX_SPLIT + 1) * 4) <= A_BYTES,
              "the merge's weights fit beside wo's A tile");

struct Params {
  const float* x_in;       // [B, H]
  const int* positions;    // [B]
  const int* n_valid;      // [B] prefix mode, else null
  const uint8_t* mask;     // [B, S] ring mode, else null
  const int* widx;         // the batch's cache slot
  const bf16* wqkv;        // [L, H, 4H]
  const bf16* wo;          // [L, 2H, H]
  const bf16* wgu;         // [L, H, 6H]
  const bf16* wdown;       // [L, 3H, H]
  const float* attn_norm;  // [L, H]
  const float* ffn_norm;   // [L, H]
  const float* q_norm;     // [L, D]
  const float* k_norm;     // [L, D]
  void* cache;             // [L, 2, B, NKV, S, D] bf16 or int8
  float* scales;           // [L, 2, B, NKV, S] (int8)
  bf16* abuf;              // [B, H] the normed residual, the next A operand
  float* part0;            // QKV and gate/up K splits: [H / 256, B, 6H]
  float* part1;            // wo and down K splits: [H / 64, B, H]
  float* part_ml;          // [B * NH, n_split, 2] (room for n_tiles splits)
  float* part_acc;         // [B * NH, n_split, D]
  float* y;                // [B, H] residual stream, then the output
  unsigned long long* phase_ns;  // [PH_KINDS] ns by phase kind, or null
  int B, L, H, NKV, S, read_ctx, n_split;
  float eps, theta, qscale;
};

// Phase kinds of the optional clock: CTA 0 adds the globaltimer time from
// one barrier's end to the next (the phase and its barrier) to
// phase_ns[kind].
enum { PH_NORM, PH_QKV, PH_ATTN, PH_WO, PH_GU, PH_DOWN, PH_KINDS };

// y[b] = (base ? base[b] : y[b]) + sum of the ksplit partial sums of a
// [ksplit, B, H] product (part1), in order; then, when w is given,
// abuf[b] = bf16(RMSNorm(y[b]) * w). One CTA per stream.
__device__ void phase_norm(const Params& p, const float* base, int ksplit,
                           const float* w) {
  __shared__ float red[TF_WARPS];
  const int H = p.H;
  for (int b = blockIdx.x; b < p.B; b += gridDim.x) {
    float ss = 0.f;
    for (int i = threadIdx.x; i < H; i += TF_THREADS) {
      const size_t o = (size_t)b * H + i;
      float s = 0.f;
#pragma unroll 8
      for (int ks = 0; ks < ksplit; ++ks)
        s += __ldcg(p.part1 + ((size_t)ks * p.B + b) * H + i);
      const float v = (base ? base[o] : __ldcg(p.y + o)) + s;
      p.y[o] = v;
      ss += v * v;
    }
    if (w == nullptr) continue;                     // uniform in the grid
    const float scale =
        rsqrtf(block_sum<TF_WARPS>(ss, red) / (float)H + p.eps);
    for (int i = threadIdx.x; i < H; i += TF_THREADS) {
      const size_t o = (size_t)b * H + i;
      p.abuf[o] = f2bf((p.y[o] * scale) * w[i]);
    }
  }
}

// A product: part[ks][m][n] = the sum over the K rows of split ks of
// A[m][k] W[k][n], W [K, N] bf16, in items of PROD_NT columns x span rows
// (mma_ring.cuh's walk and ring; a stage holds a chunk's W rows); the A
// operand built in shared memory as `akind` says.
enum { A_COPY, A_MERGE, A_ACT };
struct Prod {
  const bf16* W;
  int N, K, span, akind;
  float* part;
};

template <int KIND>
constexpr int SPAN_OF = KIND == PH_QKV ? SPAN_QKV
                        : KIND == PH_WO ? SPAN_WO
                        : KIND == PH_GU ? SPAN_GU : SPAN_DOWN;

template <int KIND>
__device__ __forceinline__ Prod product_of(const Params& p, int l) {
  const size_t H = p.H;
  constexpr int span = SPAN_OF<KIND>;
  if constexpr (KIND == PH_QKV)
    return {p.wqkv + l * H * 4 * H, 4 * p.H, p.H, span, A_COPY, p.part0};
  else if constexpr (KIND == PH_WO)
    return {p.wo + l * 2 * H * H, p.H, 2 * p.H, span, A_MERGE, p.part1};
  else if constexpr (KIND == PH_GU)
    return {p.wgu + l * H * 6 * H, 6 * p.H, p.H, span, A_COPY, p.part0};
  else
    return {p.wdown + l * 3 * H * H, p.H, 3 * p.H, span, A_ACT, p.part1};
}

template <int KIND>
__device__ __forceinline__ ItemWalk<SPAN_OF<KIND>> walk_of(const Prod& pr,
                                                           int B) {
  return ItemWalk<SPAN_OF<KIND>>(pr.N, pr.K, B);
}

// Issue the copies of chunk ch's weights into ring stage `stage` (no
// commit).
__device__ __forceinline__ void issue_w(const Prod& pr, const Chunk& ch,
                                        int stage, char* smem) {
  char* sw = smem + stage * W_STAGE;
  const bf16* src = pr.W +
                    (size_t)(ch.ks * pr.span + ch.kc * PROD_KC) * pr.N +
                    ch.tile * PROD_NT;
  for (int i = threadIdx.x; i < PROD_KC * 8; i += TF_THREADS) {
    const int r = i >> 3, c16 = i & 7;
    cp_async16(sw + swz(r, c16), src + (size_t)r * pr.N + c16 * 8);
  }
}

// The first NST - 1 weight chunks of this CTA's share of product KIND at
// layer l, one commit group each: issued before the barrier that
// precedes the product, once the CTA's dynamic shared memory is free.
template <int KIND>
__device__ void prefetch(const Params& p, int l, char* smem) {
  const Prod pr = product_of<KIND>(p, l);
  const auto wk = walk_of<KIND>(pr, p.B);
  for (int s = 0; s < NST - 1; ++s) {
    if (s < wk.total) issue_w(pr, wk.at(s), s, smem);
    cp_async_commit();                  // empty past the end: counts stay
  }
}

// 8 bf16(silu(g) * u) at K rows j0 .. j0 + 7 of stream m, from gate/up's
// K splits summed in order ([g | u] = columns j and I + j of part0).
__device__ __forceinline__ uint4 act8(const Params& p, int m, int j0) {
  const int I = 3 * p.H, N = 2 * I, n_gu = p.H / SPAN_GU;
  float g[8], u[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) g[e] = u[e] = 0.f;
#pragma unroll 4
  for (int ks = 0; ks < n_gu; ++ks) {
    const float* src = p.part0 + ((size_t)ks * p.B + m) * N + j0;
    const float4 g0 = __ldcg(reinterpret_cast<const float4*>(src));
    const float4 g1 = __ldcg(reinterpret_cast<const float4*>(src + 4));
    const float4 u0 = __ldcg(reinterpret_cast<const float4*>(src + I));
    const float4 u1 = __ldcg(reinterpret_cast<const float4*>(src + I + 4));
    const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
    const float uv[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      g[e] += gv[e];
      u[e] += uv[e];
    }
  }
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(
        (g[2 * e] / (1.f + expf(-g[2 * e]))) * u[2 * e],
        (g[2 * e + 1] / (1.f + expf(-g[2 * e + 1]))) * u[2 * e + 1]);
    w[e] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The A tile of chunk ch's item and row group: rows m0 .. m0 + 16 n_mt
// (zero past B) x the item's K span, bf16, in rows of span * 2 bytes with
// swizzled 16-byte chunks.
__device__ void build_a(const Params& p, const Prod& pr, const Chunk& ch,
                        char* As) {
  const int rows = ch.n_mt * 16, rb = pr.span * 2, cpr = pr.span / 8;
  if (pr.akind == A_MERGE) {
    // the S splits of query head hq merged, as phase_attn left them (0 for
    // a stream with no counted slot): a thread per row finds its max M,
    // the weights c_i = exp(m_i - M) and L = sum l_i c_i (kept beside the
    // A tile), then every (row, dim) adds its acc_i c_i and divides by L
    const int hq = ch.ks, NH = 2 * p.NKV, n = p.n_split;
    float* cw = reinterpret_cast<float*>(As + PROD_MG * SPAN_WO * 2);
    float* rl = cw + PROD_MG * MAX_SPLIT;   // cw [PROD_MG][n], rl [PROD_MG]
    for (int r = threadIdx.x; r < rows; r += TF_THREADS) {
      const int m = ch.m0 + r;
      float M = -CUDART_INF_F, L = 0.f;
      if (m < p.B) {
        const float* ml = p.part_ml + ((size_t)m * NH + hq) * n * 2;
#pragma unroll 4
        for (int i = 0; i < n; ++i) M = fmaxf(M, __ldcg(ml + 2 * i));
#pragma unroll 4
        for (int i = 0; i < n; ++i) {
          const float c = M == -CUDART_INF_F ? 0.f
                                             : expf(__ldcg(ml + 2 * i) - M);
          cw[r * MAX_SPLIT + i] = c;
          L += __ldcg(ml + 2 * i + 1) * c;
        }
      }
      rl[r] = M == -CUDART_INF_F ? 0.f : L;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < rows * TF_D; e += TF_THREADS) {
      const int r = e / TF_D, d = e % TF_D, m = ch.m0 + r;
      float o = 0.f;
      if (m < p.B && rl[r] != 0.f) {
        const float* acc = p.part_acc + ((size_t)m * NH + hq) * n * TF_D + d;
        float A = 0.f;
#pragma unroll 4
        for (int i = 0; i < n; ++i)
          A += __ldcg(acc + i * TF_D) * cw[r * MAX_SPLIT + i];
        o = A / rl[r];
      }
      *reinterpret_cast<bf16*>(As + swz_row(r, d >> 3, rb) + (d & 7) * 2) =
          f2bf(o);
    }
    return;
  }
  for (int i = threadIdx.x; i < rows * cpr; i += TF_THREADS) {
    const int r = i / cpr, c16 = i % cpr, m = ch.m0 + r;
    const int k0 = ch.ks * pr.span + c16 * 8;      // K row of the chunk
    uint4 v = make_uint4(0, 0, 0, 0);
    if (m < p.B)
      v = pr.akind == A_COPY
          ? __ldcg(reinterpret_cast<const uint4*>(p.abuf + (size_t)m * pr.K +
                                                  k0))
          : act8(p, m, k0);
    *reinterpret_cast<uint4*>(As + swz_row(r, c16, rb)) = v;
  }
}

// One product phase. The first NST - 1 chunks' weights were issued by
// prefetch() before the barrier; the ring issues each later chunk NST - 1
// ahead, and the A tile is built at an item's (row group's) first chunk.
template <int KIND>
__device__ void phase_product(const Params& p, int l, char* smem) {
  const Prod pr = product_of<KIND>(p, l);
  const auto wk = walk_of<KIND>(pr, p.B);
  char* As = smem + RING_BYTES;
  ring_product<NST>(
      wk, pr.part, pr.N,
      [&](int c) {
        if (c < wk.total) issue_w(pr, wk.at(c), c % NST, smem);
        cp_async_commit();
      },
      [&](int c) {
        const Chunk ch = wk.at(c);
        if (ch.kc == 0) build_a(p, pr, ch, As);
      },
      [&](int c, const Chunk& ch) {
        return Operands{As, pr.span * 2, ch.kc * (PROD_KC / 8),
                        smem + (c % NST) * W_STAGE};
      });
}

// Stream b, kv head h: sum the QKV product's K tiles; round 0 treats the
// two query heads (one per half of the CTA), round 1, when `write`, k
// (half 0) and v (half 1). q and k: head RMSNorm, then NEOX RoPE at
// positions[b]; qs[half] = bf16(q) * qscale; k and v into slot widx of
// cache[l]. Ends with a CTA barrier: the row is in the cache for the
// CTA's own tile copies.
template <bool INT8>
__device__ void item_heads(const Params& p, int l, int b, int h, bool write,
                           float (*qs)[TF_D]) {
  __shared__ float buf[TF_THREADS];
  __shared__ float red[TF_WARPS];
  const int N = 4 * p.H, ksplit = p.H / SPAN_QKV, NKV = p.NKV, NH = 2 * NKV;
  const int half = threadIdx.x >> 7, d = threadIdx.x & (TF_D - 1);
  const float freq =
      expf((float)(d & (TF_D / 2 - 1)) * (-2.0f / TF_D) * logf(p.theta));
  const int widx = __ldg(p.widx);
  const bool slot_ok = widx >= 0 && widx < p.S;
  float sn, cs;
  sincosf((float)__ldg(p.positions + b) * freq, &sn, &cs);
  for (int round = 0; round < (write ? 2 : 1); ++round) {
    const int col = round == 0 ? (TF_G * h + half) * TF_D + d
                               : (NH + half * NKV + h) * TF_D + d;
    float v = 0.f;
#pragma unroll 4
    for (int ks = 0; ks < ksplit; ++ks)
      v += __ldcg(p.part0 + ((size_t)ks * p.B + b) * N + col);
    const bool roped = round == 0 || half == 0;
    const float ss = half_reduce<false>(v * v, red);
    if (roped) {
      const float* nw = round == 0 ? p.q_norm : p.k_norm;
      v = (v * rsqrtf(ss / (float)TF_D + p.eps)) * nw[l * TF_D + d];
    }
    __syncthreads();                            // buf is free
    buf[threadIdx.x] = v;
    __syncthreads();
    if (roped) {
      const float o = buf[threadIdx.x ^ (TF_D / 2)];
      v = d < TF_D / 2 ? v * cs - o * sn : v * cs + o * sn;
    }
    if (round == 0) {
      qs[half][d] = round_bf(v) * p.qscale;
      continue;
    }
    const size_t row =
        ((((size_t)l * 2 + half) * p.B + b) * NKV + h) * p.S + widx;
    if (!INT8) {
      if (slot_ok) static_cast<bf16*>(p.cache)[row * TF_D + d] = f2bf(v);
      continue;
    }
    const float amax = half_reduce<true>(fabsf(v), red);
    const float scale = fmaxf(amax, 1e-8f) * (1.0f / 127.0f);
    const float q = fminf(fmaxf(rintf(v / scale), -127.f), 127.f);
    if (slot_ok) {
      static_cast<int8_t*>(p.cache)[row * TF_D + d] = (int8_t)q;
      if (d == 0) p.scales[row] = scale;
    }
  }
  __syncthreads();
}

template <bool INT8>
__device__ __forceinline__ float tile_value(const char* t, int i) {
  if constexpr (INT8) return (float)reinterpret_cast<const int8_t*>(t)[i];
  return bf2f(reinterpret_cast<const bf16*>(t)[i]);
}

// Copy slots [tile*64, tile*64 + 64) of K and V of (b, h) at layer l into
// shared memory (cp.async, one commit group); slots at or past ctx are
// zero-filled, never read.
template <bool INT8>
__device__ void attn_copy(const Params& p, int l, int b, int h, int tile,
                          int ctx, char* kdst, char* vdst) {
  constexpr int RB = TF_D * (INT8 ? 1 : 2);         // bytes per cache row
  const char* kb = static_cast<const char*>(p.cache) +
                   (((size_t)l * 2 * p.B + b) * p.NKV + h) * p.S * RB;
  const char* vb = kb + (size_t)p.B * p.NKV * p.S * RB;
  copy_kv_tile<RB, TF_THREADS>(kdst, vdst, kb, vb, tile * AT_ROWS,
                               [ctx](int s) { return s < ctx; });
  cp_async_commit();
}

// Attention of the two query heads of kv head h of stream b over the
// tiles of one S split: online softmax over the counted slots (prefix
// s < n_valid[b], or mask[b][s]; always s < read_ctx), written as this
// split's (m, l) and acc rows of part_ml / part_acc. Each item first
// finishes its heads (item_heads); the split whose tiles hold slot widx
// (the last split where widx is past them) also writes the K/V row there,
// before it copies any tile.
template <bool INT8>
__device__ void phase_attn(const Params& p, int l, char* smem) {
  constexpr int RB = TF_D * (INT8 ? 1 : 2);
  constexpr int TILE = AT_ROWS * RB;                // bytes of K (or V) tile
  __shared__ float qs[TF_G][TF_D];
  __shared__ float sc[TF_G][AT_ROWS];
  __shared__ float pw[TF_G][AT_ROWS];
  __shared__ float sm_m[TF_G], sm_l[TF_G], sm_a[TF_G];
  const int NKV = p.NKV, NH = 2 * NKV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = tid >> 7, d = tid & (TF_D - 1);     // P.V: (head, dim)
  const int r = tid >> 2, qd = tid & 3;             // scores: (slot, quarter)
  const int ctx = p.read_ctx;                       // nothing past it is read
  const int n_tiles = (ctx + AT_ROWS - 1) / AT_ROWS;
  const int per_split = (n_tiles + p.n_split - 1) / p.n_split;
  const int writer =
      min(max(__ldg(p.widx), 0) / AT_ROWS / per_split, p.n_split - 1);
  for (int it = blockIdx.x; it < p.B * NKV * p.n_split; it += gridDim.x) {
    const int split = it % p.n_split, b = it / p.n_split / NKV;
    const int h = it / p.n_split % NKV;
    const int nv = p.n_valid ? __ldg(p.n_valid + b) : 0;
    const int last = p.n_valid
        ? min(n_tiles, (max(nv, 0) + AT_ROWS - 1) / AT_ROWS) : n_tiles;
    const int t0 = split * per_split;
    const int t1 = min(t0 + per_split, last);
    // scale index of slot 0 of K (V adds B * NKV * S)
    const size_t srow = (((size_t)l * 2 * p.B + b) * NKV + h) * p.S;
    __syncthreads();                    // the last item is done with smem
    item_heads<INT8>(p, l, b, h, split == writer, qs);
    if (tid < TF_G) {
      sm_m[tid] = -CUDART_INF_F;
      sm_l[tid] = 0.f;
    }
    float acc = 0.f;
    if (t0 < t1) attn_copy<INT8>(p, l, b, h, t0, ctx, smem, smem + TILE);
    __syncthreads();
    for (int t = t0; t < t1; ++t) {
      const char* kt = smem + ((t - t0) & 1) * 2 * TILE;
      const char* vt = kt + TILE;
      if (t + 1 < t1) {
        char* kn = smem + ((t + 1 - t0) & 1) * 2 * TILE;
        attn_copy<INT8>(p, l, b, h, t + 1, ctx, kn, kn + TILE);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      // scores: 4 threads a slot, 32 dims each
      const int s = t * AT_ROWS + r;
      const bool valid = s < ctx &&
          (p.n_valid ? s < nv : p.mask[(size_t)b * p.S + s] != 0);
      float d0 = 0.f, d1 = 0.f;
      const char* krow = kt + r * RB + qd * 32 * (INT8 ? 1 : 2);
#pragma unroll
      for (int c = 0; c < (INT8 ? 2 : 4); ++c) {
        const uint4 raw = reinterpret_cast<const uint4*>(krow)[c];
        float kv[16];
        if constexpr (INT8) {
          const int8_t* k8 = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
          for (int i = 0; i < 16; ++i) kv[i] = (float)k8[i];
        } else {
          unpack8(raw, kv);
        }
        const int n = INT8 ? 16 : 8;
        const int i0 = qd * 32 + c * n;
#pragma unroll
        for (int i = 0; i < n; ++i) {
          d0 = fmaf(qs[0][i0 + i], kv[i], d0);
          d1 = fmaf(qs[1][i0 + i], kv[i], d1);
        }
      }
      d0 += __shfl_xor_sync(0xffffffffu, d0, 1);
      d0 += __shfl_xor_sync(0xffffffffu, d0, 2);
      d1 += __shfl_xor_sync(0xffffffffu, d1, 1);
      d1 += __shfl_xor_sync(0xffffffffu, d1, 2);
      if (qd == 0) {
        const float ks = (INT8 && valid) ? __ldcg(p.scales + srow + s) : 1.f;
        sc[0][r] = valid ? d0 * ks : -CUDART_INF_F;
        sc[1][r] = valid ? d1 * ks : -CUDART_INF_F;
      }
      __syncthreads();
      if (warp < TF_G) {                        // online softmax of head warp
        const float s0 = sc[warp][lane], s1 = sc[warp][lane + 32];
        const float m_old = sm_m[warp];
        const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
        const float p0 = s0 == -CUDART_INF_F ? 0.f : expf(s0 - m_new);
        const float p1 = s1 == -CUDART_INF_F ? 0.f : expf(s1 - m_new);
        const float alpha = m_old == -CUDART_INF_F ? 0.f : expf(m_old - m_new);
        const float psum = warp_sum(p0 + p1);
        float v0 = 1.f, v1 = 1.f;               // int8: V row scales
        if (INT8) {
          const size_t vs = srow + (size_t)p.B * NKV * p.S + t * AT_ROWS;
          if (p0 != 0.f) v0 = __ldcg(p.scales + vs + lane);
          if (p1 != 0.f) v1 = __ldcg(p.scales + vs + lane + 32);
        }
        pw[warp][lane] = p0 * v0;
        pw[warp][lane + 32] = p1 * v1;
        if (lane == 0) {
          sm_l[warp] = sm_l[warp] * alpha + psum;
          sm_m[warp] = m_new;
          sm_a[warp] = alpha;
        }
      }
      __syncthreads();
      float a = acc * sm_a[g];
      for (int j = 0; j < AT_ROWS; ++j) {
        const float pj = pw[g][j];              // uniform in the warp
        if (pj != 0.f) a = fmaf(pj, tile_value<INT8>(vt, j * TF_D + d), a);
      }
      acc = a;
      __syncthreads();                  // the tile's buffers may be refilled
    }
    const size_t prow = ((size_t)b * NH + TF_G * h + g) * p.n_split + split;
    p.part_acc[prow * TF_D + d] = acc;
    if (d == 0) {
      p.part_ml[prow * 2] = sm_m[g];
      p.part_ml[prow * 2 + 1] = sm_l[g];
    }
  }
}

template <bool INT8>
__global__ void __launch_bounds__(TF_THREADS, 2)
talker_step_kernel(Params p) {
  extern __shared__ __align__(16) char smem[];
  cg::grid_group grid = cg::this_grid();
  const int H = p.H, nsum = 2 * H / SPAN_WO;   // K splits of wo and down
  unsigned long long t_mark = globaltimer();
  const auto sync = [&](int kind) {
    grid.sync();
    if (p.phase_ns && blockIdx.x == 0 && threadIdx.x == 0) {
      const unsigned long long t = globaltimer();
      p.phase_ns[kind] += t - t_mark;
      t_mark = t;
    }
  };
  // each product's first weight chunks go out before the barrier that
  // precedes it
  prefetch<PH_QKV>(p, 0, smem);
  for (int l = 0; l < p.L; ++l) {
    phase_norm(p, l == 0 ? p.x_in : nullptr, l == 0 ? 0 : nsum,
               p.attn_norm + (size_t)l * H);
    sync(PH_NORM);
    phase_product<PH_QKV>(p, l, smem);
    sync(PH_QKV);
    phase_attn<INT8>(p, l, smem);
    prefetch<PH_WO>(p, l, smem);
    sync(PH_ATTN);
    phase_product<PH_WO>(p, l, smem);
    prefetch<PH_GU>(p, l, smem);
    sync(PH_WO);
    phase_norm(p, nullptr, nsum, p.ffn_norm + (size_t)l * H);
    sync(PH_NORM);
    phase_product<PH_GU>(p, l, smem);
    prefetch<PH_DOWN>(p, l, smem);
    sync(PH_GU);
    phase_product<PH_DOWN>(p, l, smem);
    if (l + 1 < p.L) prefetch<PH_QKV>(p, l + 1, smem);
    sync(PH_DOWN);
  }
  phase_norm(p, nullptr, nsum, nullptr);            // y += the last down
  if (p.phase_ns) sync(PH_NORM);
}

// The CTAs of one cooperative launch: occupancy x SMs, at most 2 a SM
// (every CTA must be resident for the grid barrier). Sets the kernel's
// shared-memory size on first use.
template <bool INT8>
cudaError_t grid_size(int* blocks) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0, sms = 0, occ = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(talker_step_kernel<INT8>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &occ, talker_step_kernel<INT8>, TF_THREADS, SMEM_BYTES);
    if (e != cudaSuccess) return e;
    if (occ < 1) return cudaErrorInvalidConfiguration;
    cached = sms * std::min(occ, 2);
  }
  *blocks = cached;
  return cudaSuccess;
}

template <bool INT8>
cudaError_t launch(Params p, cudaStream_t stream) {
  int blocks = 0;
  const cudaError_t e = grid_size<INT8>(&blocks);
  if (e != cudaSuccess) return e;
  // S splits of attention: about one (stream, kv head, split) item a CTA
  const int n_tiles = (p.read_ctx + AT_ROWS - 1) / AT_ROWS;
  p.n_split = std::max(
      1, std::min({n_tiles, blocks / (p.B * p.NKV), MAX_SPLIT}));
  void* args[] = {&p};
  return cudaLaunchCooperativeKernel((const void*)talker_step_kernel<INT8>,
                                     dim3(blocks), dim3(TF_THREADS), args,
                                     SMEM_BYTES, stream);
}

}  // namespace

extern "C" {

// The element counts of q3_talker_step's scratch for a step of B streams,
// hidden size H, NKV kv heads and read_ctx, from the product spans above:
// n[0] abuf (bf16), n[1] part0, n[2] part1, n[3] part_ml, n[4] part_acc
// (f32; the attention partials hold one split a 64-slot tile under
// read_ctx). Returns cudaErrorInvalidValue where the spans do not divide H
// or an argument is out of range.
int q3_talker_scratch(int B, int H, int NKV, int read_ctx, long long* n) {
  if (B < 1 || NKV < 1 || read_ctx < 1 || H < SPAN_MAX || H % SPAN_QKV ||
      H % SPAN_GU || 2 * H % SPAN_WO || 3 * H % SPAN_DOWN)
    return (int)cudaErrorInvalidValue;
  const long long b = B, h = H, heads = 2LL * NKV * B;
  const long long tiles = (read_ctx + AT_ROWS - 1) / AT_ROWS;
  n[0] = b * h;
  n[1] = std::max(h / SPAN_QKV * 4 * h, h / SPAN_GU * 6 * h) * b;
  n[2] = std::max(2 * h / SPAN_WO, 3 * h / SPAN_DOWN) * b * h;
  n[3] = heads * tiles * 2;
  n[4] = heads * tiles * TF_D;
  return 0;
}

// One decode step of all L layers (Params above; the scratch abuf .. part_acc
// of q3_talker_scratch's sizes; phase_ns, when given, [6] u64 that gains
// the ns of each phase kind). One cooperative launch on `stream`; returns
// its error.
int q3_talker_step(const float* x_in, const int* positions,
                   const int* n_valid, const uint8_t* mask, const int* widx,
                   const void* wqkv, const void* wo, const void* wgu,
                   const void* wdown, const float* attn_norm,
                   const float* ffn_norm, const float* q_norm,
                   const float* k_norm, void* cache, float* scales,
                   void* abuf, float* part0, float* part1, float* part_ml,
                   float* part_acc, float* y, unsigned long long* phase_ns,
                   int B, int L, int H, int NKV, int S, int read_ctx,
                   int int8, float eps, float theta, float qscale,
                   void* stream) {
  const Params p{x_in, positions, n_valid, mask, widx,
                 static_cast<const bf16*>(wqkv), static_cast<const bf16*>(wo),
                 static_cast<const bf16*>(wgu),
                 static_cast<const bf16*>(wdown), attn_norm, ffn_norm, q_norm,
                 k_norm, cache, scales, static_cast<bf16*>(abuf), part0,
                 part1, part_ml, part_acc, y,
                 phase_ns, B, L, H, NKV, S, read_ctx, 0, eps, theta,
                 qscale};
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e = int8 ? launch<true>(p, st) : launch<false>(p, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
