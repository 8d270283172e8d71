// The code predictor's whole frame in ONE persistent cooperative launch:
// replaces qwen3_tts_tpu/ops/codepred_fused.py::predict_codes_fused (the
// Pallas megakernel, body _make_kernel): 16 single-token positions through
// the 5 shared layers, attention over a 16-slot KV cache, the per-position
// lm_head and top-k + Gumbel-argmax sampling, all in one program.
//
// What bounds it on the H100. Bytes at small batches: a position streams
// the 157 MB of bf16 layer weights (which do not fit in the 50 MB L2, so
// every position reads them again: ~2.6 GB, ~0.77 ms a frame) plus a
// 4 MB head. Operations at serving batches: 2 x B x 78.6 M FLOP a position
// (0.48 TFLOP a frame at B = 192, ~0.5 ms on bf16 tensor cores and ~7 ms
// on FP32 FMA). And, as first ported, ~960 launches a frame from Python.
// So the design:
// - one cooperative launch of at most 2 CTAs a SM (sized by occupancy,
//   cached) runs the loops over positions and layers itself; a grid
//   barrier separates the phases. Per (position, layer):
//    1. per stream: the down product's K-split sums + residual add +
//       RMSNorm -> bf16 xn (layer 0: done by the phase that wrote x);
//    2. the QKV product;
//    3. per (stream, kv head): the QKV K-split sums, head RMSNorms, NEOX
//       RoPE, the bf16 K/V row of slot p written in place, attention of the
//       two query heads over slots 0..p in f32 -> bf16;
//    4. the wo product; 5. per stream: residual + RMSNorm -> bf16 xn;
//    6. the gate/up product; 7. bf16(silu(g) * u) from its K splits;
//    8. the down product;
//   8 grid barriers per (position, layer), 7 in layer 0. Per position
//   p >= 1 three more: the output RMSNorm, the head product, and the
//   sampler, whose CTA (one a stream) also gathers the next position's
//   embedding row into x and normalizes it (phase 1 of layer 0). Position
//   0 stops after layer 4's attention (its output is never read), where
//   the embedding of cb0 is gathered. 664 grid barriers a frame. (Folding
//   7 into 6, as an epilogue over the whole K, left 96 items of 16 chunks
//   each, which was slower on an H100 than PR 4's split product and its
//   extra barrier.) An optional clock (phase_ns) times each phase kind;
// - products weight-stationary on Hopper's warpgroup tensor cores (wgmma,
//   bf16 -> f32). An item is 64 output features (the wgmma M side) x one
//   K span; its weight tile is read from the [K, N] row-major weights as
//   they are, an MN-major (transposed) bf16 operand, and the streams are
//   the N side: a K-major operand of all the pass's activation rows. A
//   ring stage holds KC K rows of the item's weights and of every stream
//   row of the pass, so each weight chunk enters shared memory once per
//   phase and is multiplied against every stream at once (PR 4's design
//   copied it again for each 64-row group of streams, and the activation
//   slice again for each column tile, and waited on two __syncthreads a
//   chunk). Passes: ceil(B / N_MAX) of equal rows rounded up to 8
//   (pass_rows), N_MAX = 192 (at 256 the accumulators spilled and every
//   phase ran slower); the two warpgroups split a pass's rows in n32
//   tiles, at most 3 each (48 f32 accumulators a thread). KC = 64 where a
//   pass has at most 64 rows, else 32 (stage_k): halving the chunks of an
//   item took 0.8 ms off a frame at B 8-64 on an H100. Items of each
//   product on the 264 CTAs of an H100 (K rows an item sums, items, share
//   of the grid), so that none needs a second round on the grid (gate/up's
//   384 items of span 256 did) and none leaves most CTAs idle:
//     qkv     1024 x 4096: span 256, 64 x 4  = 256 items, 97%
//     wo      2048 x 1024: span 128, 16 x 16 = 256 items, 97%
//     gate/up 1024 x 6144: span 512, 96 x 2  = 192 items, 73%
//     down    3072 x 1024: span 192, 16 x 16 = 256 items, 97%
//     head    1024 x 2048: span 128, 32 x 8  = 256 items, 97%
//   Copies are TMA tiles (tensor maps made on the host at each call, in
//   the __grid_constant__ parameters; 128-byte swizzle
//   for the weights, 64- or 128-byte for the rows as KC) into a ring of
//   4-6 stages in 64 KB, full / empty mbarriers a stage. A phase's first
//   weight tiles are issued by thread 0 once its CTA has arrived at the
//   grid barrier before the phase (the weights are never written in the
//   launch), its row tiles and the refills by one producer thread after
//   it. The grid barrier is the kernel's own (grid_barrier): split so, and
//   0.6-1.2 us faster a barrier than cooperative groups' on an H100. Split-K
//   partial sums go to part [splits, B, N] and the consuming phase adds
//   them in a fixed order: no atomics, deterministic;
// - every read of data written in the launch goes through L2 (__ldcg,
//   TMA): L1 is not coherent across SMs. The producer's proxy fence
//   orders the last phase's generic writes before its TMA reads.
// Rows behind an mtp projection (the 1.7B shape: a 2048-wide talker before
// the 1024-wide code predictor): the projection is linear and sits only at
// the stack's input, so the wrapper projects position 0's hidden and hands
// the kernel f32 tables of pre-projected rows (ops/codepred_fused.py
// fold_mtp) in place of the bf16 embeddings. The row type of the gathers
// (embed_norm) is a template parameter of the kernel: F32_ROWS. The other
// is the K rows of a ring stage, KC = stage_k(B): a kernel holds one
// product loop (with both, the 32-row loop ran ~5% slower on an H100).
// Numerics as the twin (ops/codepred_fused.py): xn rounded to bf16 before
// each product, f32 accumulation, head norms, RoPE and softmax in f32, the
// attention output and silu(g) * u rounded to bf16; greedy = first
// argmax; sampled = exact top-k threshold (32-step binary search over
// monotone uint32 keys, ties kept), then first argmax of z + noise.

#include <cuda.h>  // CUtensorMap and its enums (the encoder is looked up)
#include <math_constants.h>

#include <algorithm>
#include <type_traits>

#include "attn_tile.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// the code predictor of the 0.6B, the 1.7B and Qwen3-Omni's talker
constexpr int H = 1024, NH = 16, NKV = 8, D = 128, I = 3072, V = 2048;
constexpr int L = 5, CTX = 16;
constexpr int NQKV = (NH + 2 * NKV) * D;            // 4096
// products: an item's output features, the stream rows of one wgmma and
// the most of them a warpgroup takes
constexpr int FT = 64, SUB = 32, SUB_WG = 3;
constexpr int N_MAX = 2 * SUB_WG * SUB;   // 192 streams a pass
constexpr int MAX_NST = 8;                // ring stages at most
// the thread that issues a product's row tiles and refills (the weight
// tiles before it come from thread 0, inside the grid barrier):
// warpgroup 1's first, which has no stream rows at B <= 32 (a wgmma waits
// for the 4 warps of its warpgroup, so a refill there holds it back)
constexpr int PRODUCER = 128;
constexpr int RING_BYTES = 64 * 1024;
constexpr int ATTN_BYTES = 2 * CTX * D * 4;        // phase_attn's K/V rows
constexpr int SMEM_BYTES = 1024 + RING_BYTES + ATTN_BYTES;  // + alignment
static_assert(RING_BYTES / ((FT + N_MAX) * 32 * 2) >= 4 &&
                  RING_BYTES / ((FT + 64) * 64 * 2) >= 4,
              "at least 4 stages");
static_assert((CTX - 1) * D / 8 <= THREADS, "earlier slots in one load");

// A product: [B, K] activations x [K, N] weights, in items of FT output
// features x `span` K rows (the table above).
struct Shape { int K, N, span; };
__host__ __device__ constexpr Shape QKV() { return {H, NQKV, 256}; }
__host__ __device__ constexpr Shape WO() { return {NH * D, H, 128}; }
__host__ __device__ constexpr Shape GU() { return {H, 2 * I, 512}; }
__host__ __device__ constexpr Shape DOWN() { return {I, H, 192}; }
__host__ __device__ constexpr Shape HEAD() { return {H, V, 128}; }
__host__ __device__ constexpr int splits(Shape s) { return s.K / s.span; }
constexpr int part_cols(Shape s) { return splits(s) * s.N; }
// part's floats a stream: the most any product writes (16 x 1024)
constexpr int PART_COLS = std::max(
    {part_cols(QKV()), part_cols(WO()), part_cols(GU()), part_cols(DOWN()),
     part_cols(HEAD())});
static_assert(PART_COLS == 16384, "ops/codepred_fused.py PART_COLS");

// Stream rows a pass: B in ceil(B / N_MAX) passes of equal rows, rounded
// up to 8 (the TMA box of the activation maps has this many rows).
__host__ __device__ constexpr int pass_rows(int B) {
  const int passes = (B + N_MAX - 1) / N_MAX;
  return ((B + passes - 1) / passes + 7) / 8 * 8;
}

// K rows a ring stage holds: 64 where a pass has at most 64 rows (half
// the chunks, copies and waits a product walks at small batches), else 32
__host__ __device__ constexpr int stage_k(int B) {
  return pass_rows(B) <= 64 ? 64 : 32;
}

// tensor maps in Params::tm
enum { TM_WQKV, TM_WO, TM_WGU, TM_WDOWN, TM_HEADS, TM_XN, TM_ATTN, TM_ACT,
       TM_COUNT };

struct Params {
  const float* hidden;     // [B, H]
  const int* cb0;          // [B]
  const void* codec_embd;  // [n_codec, H] rows, bf16 or f32 (F32_ROWS)
  const float* attn_norm;  // [L, H]
  const float* ffn_norm;   // [L, H]
  const float* q_norm;     // [L, D]
  const float* k_norm;     // [L, D]
  const float* out_norm;   // [H]
  const void* embd;        // [15, V, H] rows, as codec_embd
  const float* gumbel;     // [15, B, V], null when greedy
  const float* rope_c;     // [CTX, D]: [cos | cos]
  const float* rope_s;     // [CTX, D]: [-sin | sin]
  float* logits;           // [15, B, V] or null
  int* codes;              // [B, 15]
  float* x;                // [B, H] residual stream
  bf16* xn;                // [B, H] the next product's input
  bf16* attn;              // [B, NH * D]
  bf16* act;               // [B, I]
  float* part;             // [splits, B, N] split-K sums (<= PART_COLS a
                           // stream), then the grid barrier's word
  bf16* kc;                // [L, B, NKV, CTX, D]
  bf16* vc;
  unsigned long long* phase_ns;  // [PH_KINDS] ns by phase kind, or null
  int n_codec, B, top_k, greedy;
  float eps, tinv;
  // TMA maps: the weights wqkv [L * H, NQKV], wo [L * NH * D, H], wgu
  // [L * H, 2I], wdown [L * I, H], heads [15 * H, V] in tiles of FT x
  // stage_k(B); the activations xn, attn, act [B, K] in tiles of
  // stage_k(B) x pass_rows(B)
  CUtensorMap tm[TM_COUNT];
};

// Phase kinds of the optional clock: CTA 0 adds the globaltimer time from
// one barrier's end to the next (the phase and its barrier) to
// phase_ns[kind].
enum { PH_NORM, PH_QKV, PH_ATTN, PH_WO, PH_GU, PH_ACT, PH_DOWN, PH_HEAD,
       PH_SAMPLE, PH_KINDS };

__device__ __forceinline__ void clock_mark(const Params& p, int kind,
                                           unsigned long long& t_mark) {
  const unsigned long long t = globaltimer();
  p.phase_ns[kind] += t - t_mark;
  t_mark = t;
}

// ---- mbarriers, TMA and wgmma (PTX) ----
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(count)
               : "memory");
}

// arrive once and expect `bytes` more of TMA transactions this phase
__device__ __forceinline__ void mbar_expect(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(b)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(b))
               : "memory");
}

__device__ __forceinline__ bool mbar_done(uint32_t b, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(b), "r"(parity)
      : "memory");
  return ok != 0;
}

// Wait for the completion of the barrier's phase of this parity. A wait
// of over 4 s traps (the launch fails) rather than hold the card.
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  const uint32_t a = smem_u32(b);
  if (mbar_done(a, parity)) return;
  const unsigned long long t0 = globaltimer();
  while (!mbar_done(a, parity))
    if (globaltimer() - t0 > 4000000000ull) __trap();
}

// a box of a 2D tensor map at (c0 inner, c1 outer) -> shared, completing
// on barrier b
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       int c0, int c1, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(b)), "r"(c0),
      "r"(c1)
      : "memory");
}

// generic-proxy accesses to global memory before, async-proxy (TMA) ones
// after
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* a) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(a)
               : "memory");
  return v;
}

// The grid barrier, split so that thread 0 can issue copies between its
// CTA's arrival and its wait. One word, zero at allocation: CTA 0 adds
// 2^31 - (gridDim.x - 1), the others 1, so the last arrival flips its top
// bit (as cooperative groups' barrier does) and a CTA waits for the flip.
template <class Between>
__device__ __forceinline__ void grid_barrier(unsigned* state,
                                             Between between) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned add = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    __threadfence();                    // the CTA's writes, then arrive
    const unsigned old = atomicAdd(state, add);
    between();
    const unsigned long long t0 = globaltimer();
    while (((ld_acquire(state) ^ old) & 0x80000000u) == 0)
      if (globaltimer() - t0 > 4000000000ull) __trap();
  }
  __syncthreads();
}

// wgmma shared-memory descriptor: start address, leading byte offset 16
// (unused by these layouts), stride byte offset (8-row groups), swizzle
// (1: 128-byte, 2: 64-byte)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t sbo,
                                              uint64_t swizzle) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (swizzle << 62);
}

// d[64 features x 32 streams] (+)= A[64 x 16] B[16 x 32]: A the weight
// tile, MN-major (transposed); B the stream rows, K-major; f32 sums,
// D = A B where `acc` is 0
__device__ __forceinline__ void wgmma_n32(float* d, uint64_t da, uint64_t db,
                                          int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

// keep the compiler from moving accumulator accesses across a wgmma
__device__ __forceinline__ void fence_acc(float (*acc)[16]) {
#pragma unroll
  for (int j = 0; j < SUB_WG; ++j)
#pragma unroll
    for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(acc[j][i])::"memory");
}

// One stage on this warpgroup's NS n32 tiles of stream rows: KK k-steps
// of 16 (32 or 64 K rows), then wait for the tensor cores (the stage may
// be refilled). (Keeping a group in flight across stages was serialized
// by ptxas.)
template <int NS, int KK>
__device__ __forceinline__ void mma_stage(float (*acc)[16], uint32_t sa,
                                          uint32_t sb, int accumulate) {
  // a stream row: 64 bytes, 64-byte swizzle; or 128 bytes, 128-byte
  constexpr uint32_t ROW = KK * 32, SWIZZLE = KK == 4 ? 1 : 2;
  fence_acc(acc);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    // weights: 16 K rows of 128 bytes, 8-row groups 1,024 bytes apart;
    // stream rows: 8-row groups 8 rows apart, the k-step 32 bytes in
    const uint64_t da = smem_desc(sa + kk * 16 * FT * 2, 1024, 1);
#pragma unroll
    for (int j = 0; j < NS; ++j)
      wgmma_n32(acc[j], da,
                smem_desc(sb + j * SUB * ROW + kk * 32, 8 * ROW, SWIZZLE),
                accumulate | kk);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);
}

// The ring of product stages in shared memory: stage s holds a chunk's
// weight tile (FT x kc) then its nt n32 tiles of stream rows; full[s]
// completes when both TMA copies have landed, empty[s] when every warp
// has read the stage. g counts the chunks this CTA has consumed in the
// launch (every thread keeps it), so chunk q uses stage q % nst for the
// (q / nst)-th time.
struct Ring {
  char* base;
  uint64_t* full;
  uint64_t* empty;
  int R, nt, kc, a_bytes, stage, nst;   // kc: stage_k(B)
  uint32_t g;
};

// A product phase: the activation map, the weight map and the first
// weight row of the layer (or head).
struct Prod {
  const CUtensorMap* a;
  const CUtensorMap* w;
  Shape sh;
  int w_row0;
};

// The CTA's chunks of a product: its items it = blockIdx.x + r x
// gridDim.x, per item its passes, per pass its span / kc chunks.
struct Chunk { int tile, ks, pass, kc; };

struct Walk {
  int tiles, n_kc, per_item, total;
  __device__ Walk(const Shape& sh, int B, int kc) {
    tiles = sh.N / FT;
    n_kc = sh.span / kc;
    const int items = tiles * (sh.K / sh.span);
    const int mine = (int)blockIdx.x < items
        ? (items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
    per_item = (B + N_MAX - 1) / N_MAX * n_kc;
    total = mine * per_item;
  }
  __device__ Chunk at(int c) const {
    const int it = blockIdx.x + (c / per_item) * gridDim.x;
    const int rem = c % per_item;
    return Chunk{it % tiles, it / tiles, rem / n_kc, rem % n_kc};
  }
};

__device__ __forceinline__ int k_row(const Ring& r, const Prod& pr,
                                     const Chunk& ch) {
  return ch.ks * pr.sh.span + ch.kc * r.kc;
}

// Thread 0 (prefetch) or the producer: wait until chunk q's stage is
// free, expect its bytes, copy its weight tile.
__device__ void fill_weights(Ring& r, uint32_t q, const Prod& pr,
                             const Chunk& ch) {
  const int s = q % r.nst;
  const uint32_t use = q / r.nst;
  if (use > 0) mbar_wait(&r.empty[s], (use - 1) & 1);
  mbar_expect(&r.full[s], r.a_bytes + r.R * r.kc * 2);
  tma_2d(r.base + s * r.stage, pr.w, ch.tile * FT,
         pr.w_row0 + k_row(r, pr, ch), &r.full[s]);
}

// The producer: copy chunk q's stream rows (rows past B arrive as zeros).
__device__ void fill_rows(Ring& r, uint32_t q, const Prod& pr,
                          const Chunk& ch) {
  tma_2d(r.base + (q % r.nst) * r.stage + r.a_bytes, pr.a, k_row(r, pr, ch),
         ch.pass * r.R, &r.full[q % r.nst]);
}

// Thread 0, once its CTA has arrived at the grid barrier before the
// product: the weight tiles of the CTA's first nst chunks.
__device__ void prefetch(Ring& r, const Prod& pr, int B) {
  const Walk wk(pr.sh, B, r.kc);
  for (int c = 0; c < min(r.nst, wk.total); ++c)
    fill_weights(r, r.g + c, pr, wk.at(c));
}

// A pass's sums of this warpgroup's tiles to part[ks][b][feature] (rows
// of the pass below B).
__device__ __forceinline__ void store_part(const float (*acc)[16], int n_sub,
                                           int row0, const Chunk& ch,
                                           const Ring& r, int N, int B,
                                           float* part) {
  const int t = threadIdx.x & 127, l = t & 31;
  float* out = part + (size_t)ch.ks * B * N + ch.tile * FT + (t >> 5) * 16 +
               (l >> 2);
#pragma unroll
  for (int j = 0; j < SUB_WG; ++j) {
#pragma unroll
    for (int v = 0; v < 8; ++v) {       // n8 group v / 2, stream column v % 2
      const int local = row0 + j * SUB + (v >> 1) * 8 + (l & 3) * 2 + (v & 1);
      const int b = ch.pass * r.R + local;
      if (j < n_sub && local < r.R && b < B) {
        const int i = (v >> 1) * 4 + (v & 1);
        __stcg(out + (size_t)b * N, acc[j][i]);
        __stcg(out + (size_t)b * N + 8, acc[j][i + 2]);
      }
    }
  }
}

// One product phase: part[ks][b][n] = the sum over the K rows of split ks
// of A[b][k] W[k][n]. The first min(nst, total) chunks' weight tiles were
// issued by prefetch; their stream rows are issued here, after the grid
// barrier. Per chunk: wait for its stage, the warpgroup's wgmma over its
// n32 tiles, each warp releases the stage, the producer refills it with
// the chunk nst later; a pass's last chunk stores its sums. KC: r.kc, a
// constant of the loop.
template <int KC>
__device__ uint32_t product(const Params& p, Ring r, Prod pr) {
  // the warpgroup, broadcast so that the compiler sees it warp-uniform
  // (a wgmma on a path it takes for divergent is serialized)
  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const Walk wk(pr.sh, p.B, KC);
  if (tid == PRODUCER) {
    fence_proxy_async();    // the rows were written by the generic proxy
    for (int c = 0; c < min(r.nst, wk.total); ++c)
      fill_rows(r, r.g + c, pr, wk.at(c));
  }
  const int nt0 = (r.nt + 1) / 2;                   // warpgroup 0's tiles
  const int n_sub = wg == 0 ? nt0 : r.nt - nt0;
  const int row0 = wg == 0 ? 0 : nt0 * SUB;
  float acc[SUB_WG][16];
#pragma unroll
  for (int j = 0; j < SUB_WG; ++j)
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[j][i] = 0.f;
  for (int c = 0; c < wk.total; ++c) {
    const Chunk ch = wk.at(c);
    const uint32_t q = r.g + c;
    const int s = q % r.nst;
    mbar_wait(&r.full[s], (q / r.nst) & 1);
    const uint32_t sa = smem_u32(r.base + s * r.stage);
    const uint32_t sb = sa + (FT + row0) * KC * 2;
    const int accumulate = ch.kc > 0;
    if (KC == 64) {                     // up to 64 rows: a tile each
      if (n_sub == 1) mma_stage<1, 4>(acc, sa, sb, accumulate);
    } else {
      switch (n_sub) {                  // uniform over the warpgroup
        case 1: mma_stage<1, 2>(acc, sa, sb, accumulate); break;
        case 2: mma_stage<2, 2>(acc, sa, sb, accumulate); break;
        case 3: mma_stage<3, 2>(acc, sa, sb, accumulate); break;
        default: break;
      }
    }
    __syncwarp();
    if ((tid & 31) == 0) mbar_arrive(&r.empty[s]);
    if (tid == PRODUCER && c + r.nst < wk.total) {
      const Chunk nx = wk.at(c + r.nst);
      fill_weights(r, q + r.nst, pr, nx);
      fill_rows(r, q + r.nst, pr, nx);
    }
    if (ch.kc == wk.n_kc - 1)
      store_part(acc, n_sub, row0, ch, r, pr.sh.N, p.B, p.part);
  }
  return r.g + wk.total;
}

// act[b][j] = bf16(silu(g) * u) from the gate/up product's K splits,
// summed in order ([g | u] = columns j and I + j).
__device__ void phase_act(const Params& p) {
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < p.B * I;
       i += gridDim.x * THREADS) {
    const int b = i / I, j = i % I;
    float g = 0.f, u = 0.f;
#pragma unroll
    for (int ks = 0; ks < splits(GU()); ++ks) {
      const float* pr = p.part + ((size_t)ks * p.B + b) * 2 * I;
      g += __ldcg(pr + j);
      u += __ldcg(pr + I + j);
    }
    p.act[i] = f2bf((g / (1.f + expf(-g))) * u);
  }
}

// x[b] = base[b] or x[b], plus the KSPLIT partial sums of a [KSPLIT, B, H]
// product in order; xn[b] = bf16(RMSNorm(x[b]) * w). One CTA per stream.
// KSPLIT is a constant so that every load is issued before the first sum.
template <int KSPLIT>
__device__ void phase_norm(const Params& p, const float* base,
                           const float* w) {
  __shared__ float red[WARPS];
  for (int b = blockIdx.x; b < p.B; b += gridDim.x) {
    float xv[H / THREADS], ss = 0.f;
#pragma unroll
    for (int j = 0; j < H / THREADS; ++j) {
      const size_t o = (size_t)b * H + threadIdx.x + j * THREADS;
      float s = 0.f;
#pragma unroll
      for (int ks = 0; ks < KSPLIT; ++ks)
        s += __ldcg(p.part + (size_t)ks * p.B * H + o);
      xv[j] = (base ? base[o] : __ldcg(p.x + o)) + s;
      p.x[o] = xv[j];
      ss += xv[j] * xv[j];
    }
    const float scale = rsqrtf(block_sum<WARPS>(ss, red) / (float)H + p.eps);
#pragma unroll
    for (int j = 0; j < H / THREADS; ++j) {
      const int i = threadIdx.x + j * THREADS;
      p.xn[(size_t)b * H + i] = f2bf((xv[j] * scale) * w[i]);
    }
  }
}

__device__ __forceinline__ float as_f32(bf16 v) { return bf2f(v); }
__device__ __forceinline__ float as_f32(float v) { return v; }

// x[b] = row (an embedding row, bf16, or f32 when pre-projected), xn[b] =
// bf16(RMSNorm(x[b]) * attn_norm[0]): layer 0's input of the next position.
template <typename Row>
__device__ void embed_norm(const Params& p, int b, const Row* row,
                           float* red) {
  float xv[H / THREADS], ss = 0.f;
#pragma unroll
  for (int j = 0; j < H / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    xv[j] = as_f32(row[i]);
    p.x[(size_t)b * H + i] = xv[j];
    ss += xv[j] * xv[j];
  }
  const float scale = rsqrtf(block_sum<WARPS>(ss, red) / (float)H + p.eps);
#pragma unroll
  for (int j = 0; j < H / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    p.xn[(size_t)b * H + i] = f2bf((xv[j] * scale) * p.attn_norm[i]);
  }
}

// Per (stream b, kv head h): sum the QKV product's 4 K splits; round 0
// treats the two query heads (one per half of the CTA), round 1 k (half 0)
// and v (half 1); q and k get head RMSNorm and NEOX RoPE at position pos;
// the bf16 K/V row goes to slot pos of layer l; then both query heads
// attend slots 0..pos in f32 -> attn (bf16). With embed, B more items
// gather codec_embd[cb0[b]] for position 1.
template <typename Row>
__device__ void phase_attn(const Params& p, int l, int pos, bool embed,
                           char* smem) {
  __shared__ float buf[THREADS];
  __shared__ float red[WARPS];
  __shared__ float qs[2][D];
  __shared__ float sc[2][CTX];
  float* ks = reinterpret_cast<float*>(smem);      // [CTX][D]
  float* vs = ks + CTX * D;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int half = tid >> 7, d = tid & (D - 1);
  const float c = p.rope_c[pos * D + d], s = p.rope_s[pos * D + d];
  const float qscale = (float)0.088388347648318440550;  // D ** -0.5
  const int n_attn = p.B * NKV;
  for (int it = blockIdx.x; it < n_attn + (embed ? p.B : 0);
       it += gridDim.x) {
    if (it >= n_attn) {
      const int b = it - n_attn;
      const int code = min(max(__ldg(p.cb0 + b), 0), p.n_codec - 1);
      embed_norm(p, b,
                 static_cast<const Row*>(p.codec_embd) + (size_t)code * H,
                 red);
      continue;
    }
    const int b = it / NKV, h = it % NKV;
    const size_t slot0 = (((size_t)l * p.B + b) * NKV + h) * CTX * D;
    for (int round = 0; round < 2; ++round) {
      const int col = round == 0 ? (2 * h + half) * D + d
                                 : (NH + half * NKV + h) * D + d;
      float v = 0.f;
#pragma unroll
      for (int k4 = 0; k4 < splits(QKV()); ++k4)
        v += __ldcg(p.part + ((size_t)k4 * p.B + b) * NQKV + col);
      const bool roped = round == 0 || half == 0;
      const float ss = half_reduce<false>(v * v, red);
      if (roped) {
        const float* nw = round == 0 ? p.q_norm : p.k_norm;
        v = (v * rsqrtf(ss / (float)D + p.eps)) * nw[l * D + d];
      }
      __syncthreads();                              // buf is free
      buf[tid] = v;
      __syncthreads();
      if (roped) v = v * c + buf[half * D + ((d + D / 2) & (D - 1))] * s;
      if (round == 0) {
        qs[half][d] = v * qscale;
        continue;
      }
      const bf16 r = f2bf(v);
      (half == 0 ? p.kc : p.vc)[slot0 + pos * D + d] = r;
      (half == 0 ? ks : vs)[pos * D + d] = bf2f(r);
    }
    if (tid < pos * D / 8) {            // earlier slots via L2, 16 B a thread
      float kv[8], vv[8];
      unpack8(__ldcg(reinterpret_cast<const uint4*>(p.kc + slot0) + tid), kv);
      unpack8(__ldcg(reinterpret_cast<const uint4*>(p.vc + slot0) + tid), vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        ks[tid * 8 + j] = kv[j];
        vs[tid * 8 + j] = vv[j];
      }
    }
    __syncthreads();
    for (int j = warp; j <= pos; j += WARPS) {      // scores: a warp a slot
      float d0 = 0.f, d1 = 0.f;
#pragma unroll
      for (int i = 0; i < D / 32; ++i) {
        const float kv = ks[j * D + lane + 32 * i];
        d0 = fmaf(qs[0][lane + 32 * i], kv, d0);
        d1 = fmaf(qs[1][lane + 32 * i], kv, d1);
      }
      d0 = warp_sum(d0);
      d1 = warp_sum(d1);
      if (lane == 0) {
        sc[0][j] = d0;
        sc[1][j] = d1;
      }
    }
    __syncthreads();
    float m = -CUDART_INF_F;
    for (int j = 0; j <= pos; ++j) m = fmaxf(m, sc[half][j]);
    float den = 0.f, acc = 0.f;
    for (int j = 0; j <= pos; ++j) {
      const float e = expf(sc[half][j] - m);
      den += e;
      acc = fmaf(e, vs[j * D + d], acc);
    }
    p.attn[(size_t)b * NH * D + (2 * h + half) * D + d] = f2bf(acc / den);
    __syncthreads();                    // ks, vs, qs, sc free for the next
  }
}

__device__ __forceinline__ void argmax_merge(float& v, int& i, float ov,
                                             int oi) {
  if (ov > v || (ov == v && oi < i)) { v = ov; i = oi; }
}

// First index of the row maximum over the CTA; every thread gets it.
__device__ int block_first_argmax(float v, int i) {
  __shared__ float sv[WARPS];
  __shared__ int si[WARPS];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    argmax_merge(v, i, __shfl_xor_sync(0xffffffffu, v, o),
                 __shfl_xor_sync(0xffffffffu, i, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) { sv[warp] = v; si[warp] = i; }
  __syncthreads();
  float bv = sv[0];
  int bi = si[0];
  for (int w = 1; w < WARPS; ++w) argmax_merge(bv, bi, sv[w], si[w]);
  return bi;
}

constexpr int SPT = V / THREADS;  // logits per thread

// Position pos >= 1, one CTA per stream: logits = the head product's 4 K
// splits in order (-> logits_out); greedy = first argmax; otherwise z =
// logits * tinv, keep z >= its k-th largest (ties kept), first argmax of
// z + noise. Writes codes[b][pos - 1]; before the last position, gathers
// embd[pos - 1][code] as the next position's x and normalizes it.
template <typename Row>
__device__ void phase_sample(const Params& p, int pos) {
  __shared__ float red[WARPS];
  const int tid = threadIdx.x;
  for (int b = blockIdx.x; b < p.B; b += gridDim.x) {
    float lg[SPT];
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int i = tid + j * THREADS;
      float s = 0.f;
#pragma unroll
      for (int k4 = 0; k4 < splits(HEAD()); ++k4)
        s += __ldcg(p.part + ((size_t)k4 * p.B + b) * V + i);
      lg[j] = s;
      if (p.logits) p.logits[((size_t)(pos - 1) * p.B + b) * V + i] = s;
    }
    float bv = -CUDART_INF_F;
    int bi = 0x7fffffff;
    if (p.greedy) {
#pragma unroll
      for (int j = 0; j < SPT; ++j) argmax_merge(bv, bi, lg[j], tid + j * THREADS);
    } else {
      float z[SPT];
      uint32_t us[SPT];
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        z[j] = lg[j] * p.tinv;
        const uint32_t u = __float_as_uint(z[j]);
        us[j] = z[j] >= 0.f ? (u | 0x80000000u) : ~u;
      }
      uint32_t t = 0u;
      if (p.top_k > 0 && p.top_k < V) {
        for (int bit = 31; bit >= 0; --bit) {
          const uint32_t cand = t | (1u << bit);
          float cnt = 0.f;
#pragma unroll
          for (int j = 0; j < SPT; ++j) cnt += us[j] >= cand ? 1.f : 0.f;
          if (block_sum<WARPS>(cnt, red) >= (float)p.top_k) t = cand;
        }
      }
      const float* g = p.gumbel + ((size_t)(pos - 1) * p.B + b) * V;
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        const int i = tid + j * THREADS;
        argmax_merge(bv, bi, (us[j] >= t ? z[j] : -1.0e30f) + g[i], i);
      }
    }
    int code = block_first_argmax(bv, bi);
    code = (code >= 0 && code < V) ? code : 0;
    if (tid == 0) p.codes[b * (CTX - 1) + pos - 1] = code;
    if (pos < CTX - 1)
      embed_norm(p, b, static_cast<const Row*>(p.embd) +
                           ((size_t)(pos - 1) * V + code) * H, red);
  }
}

template <bool F32_ROWS, int KC>
__global__ void __launch_bounds__(THREADS, 2)
    codepred_frame_kernel(const __grid_constant__ Params p) {
  using Row = std::conditional_t<F32_ROWS, float, bf16>;
  extern __shared__ __align__(1024) char smem[];
  __shared__ uint64_t bars[2 * MAX_NST];
  // the ring at the first 1,024-byte boundary (the swizzles' period),
  // phase_attn's rows after it
  char* base = smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);
  Ring ring;
  ring.base = base;
  ring.full = bars;
  ring.empty = bars + MAX_NST;
  ring.R = pass_rows(p.B);
  ring.nt = (ring.R + SUB - 1) / SUB;
  ring.kc = KC;                         // stage_k(p.B)
  ring.a_bytes = FT * ring.kc * 2;
  ring.stage = (FT + ring.nt * SUB) * ring.kc * 2;
  ring.nst = min(MAX_NST, RING_BYTES / ring.stage);
  ring.g = 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ring.nst; ++s) {
      mbar_init(&ring.full[s], 1);
      mbar_init(&ring.empty[s], WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  char* attn_smem = base + RING_BYTES;
  // the products at layer l (or head h)
  const auto qkv = [&](int l) {
    return Prod{&p.tm[TM_XN], &p.tm[TM_WQKV], QKV(), l * H};
  };
  const auto wo = [&](int l) {
    return Prod{&p.tm[TM_ATTN], &p.tm[TM_WO], WO(), l * NH * D};
  };
  const auto gu = [&](int l) {
    return Prod{&p.tm[TM_XN], &p.tm[TM_WGU], GU(), l * H};
  };
  const auto down = [&](int l) {
    return Prod{&p.tm[TM_ACT], &p.tm[TM_WDOWN], DOWN(), l * I};
  };
  const auto head = [&](int h) {
    return Prod{&p.tm[TM_XN], &p.tm[TM_HEADS], HEAD(), h * H};
  };
  unsigned long long t_mark = globaltimer();
  // the grid barrier after a phase; once its CTA has arrived, thread 0
  // issues the weight tiles of the product that follows (`next`)
  unsigned* bar =
      reinterpret_cast<unsigned*>(p.part + (size_t)PART_COLS * p.B);
  const auto sync = [&](int kind, const Prod* next) {
    grid_barrier(bar, [&] {
      if (next) prefetch(ring, *next, p.B);
    });
    if (p.phase_ns && blockIdx.x == 0 && threadIdx.x == 0)
      clock_mark(p, kind, t_mark);
  };
  Prod next = qkv(0);
  phase_norm<0>(p, p.hidden, p.attn_norm);          // position 0's input
  sync(PH_NORM, &next);
  for (int pos = 0; pos < CTX; ++pos) {
    for (int l = 0; l < L; ++l) {
      if (l > 0) {
        phase_norm<splits(DOWN())>(p, nullptr, p.attn_norm + (size_t)l * H);
        sync(PH_NORM, &next);
      }
      const bool last0 = pos == 0 && l == L - 1;
      // position 0's output is never read: position 1 follows layer 4's
      // attention
      next = last0 ? qkv(0) : wo(l);
      ring.g = product<KC>(p, ring, qkv(l));
      sync(PH_QKV, nullptr);
      phase_attn<Row>(p, l, pos, last0, attn_smem);
      sync(PH_ATTN, &next);
      if (last0) break;
      next = gu(l);
      ring.g = product<KC>(p, ring, wo(l));
      sync(PH_WO, nullptr);
      phase_norm<splits(WO())>(p, nullptr, p.ffn_norm + (size_t)l * H);
      sync(PH_NORM, &next);
      next = down(l);
      ring.g = product<KC>(p, ring, gu(l));
      sync(PH_GU, nullptr);
      phase_act(p);
      sync(PH_ACT, &next);
      next = l + 1 < L ? qkv(l + 1) : head(pos - 1);
      ring.g = product<KC>(p, ring, down(l));
      sync(PH_DOWN, nullptr);
    }
    if (pos == 0) continue;
    phase_norm<splits(DOWN())>(p, nullptr, p.out_norm);
    sync(PH_NORM, &next);
    next = qkv(0);
    ring.g = product<KC>(p, ring, head(pos - 1));
    sync(PH_HEAD, nullptr);
    phase_sample<Row>(p, pos);
    if (pos < CTX - 1) sync(PH_SAMPLE, &next);
  }
  if (p.phase_ns) sync(PH_SAMPLE, nullptr);  // the last sampler's end
}

int g_launches = 0;               // cooperative launches made

// The CTAs of one cooperative launch of an instantiation: occupancy x
// SMs, at most 2 a SM (every CTA must be resident for the grid barrier).
// Sets the kernel's shared-memory size on first use.
template <bool F32_ROWS, int KC>
cudaError_t grid_size(int* blocks) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0, sms = 0, occ = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(codepred_frame_kernel<F32_ROWS, KC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &occ, codepred_frame_kernel<F32_ROWS, KC>, THREADS, SMEM_BYTES);
    if (e != cudaSuccess) return e;
    if (occ < 1) return cudaErrorInvalidConfiguration;
    cached = sms * std::min(occ, 2);
  }
  *blocks = cached;
  return cudaSuccess;
}

template <bool F32_ROWS, int KC>
cudaError_t launch(Params& p, cudaStream_t stream) {
  int blocks = 0;
  cudaError_t e = grid_size<F32_ROWS, KC>(&blocks);
  if (e != cudaSuccess) return e;
  void* args[] = {&p};
  return cudaLaunchCooperativeKernel(
      (const void*)codepred_frame_kernel<F32_ROWS, KC>, dim3(blocks),
      dim3(THREADS), args, SMEM_BYTES, stream);
}

// ---- tensor maps ----
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, through the runtime (no link
// against the driver library).
cudaError_t encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (!cached) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || !f)
      return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(f);
  }
  *fn = cached;
  return cudaSuccess;
}

// A 2D bf16 map of [outer, inner] row-major at ptr, in boxes of box_outer
// rows x box_inner elements.
cudaError_t make_map(EncodeTiled enc, CUtensorMap* m, const void* ptr,
                     uint64_t inner, uint64_t outer, uint32_t box_inner,
                     uint32_t box_outer, CUtensorMapSwizzle swizzle,
                     CUtensorMapL2promotion promote) {
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {inner * 2};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                         const_cast<void*>(ptr), dims, strides, box, step,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, promote,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The maps of a weight set and batch (their addresses and B), made at
// every call: encoding the eight takes microseconds on the host against a
// frame of milliseconds, and a graph capture bakes them into the kernel
// node's parameters, so a replay makes none.
cudaError_t tensor_maps(const void* const* ptr, int B, CUtensorMap* out) {
  EncodeTiled enc = nullptr;
  cudaError_t e = encoder(&enc);
  // [inner, outer] of each map
  const uint64_t dims[TM_COUNT][2] = {
      {NQKV, L * H}, {H, L * NH * D}, {2 * I, L * H}, {H, L * I},
      {V, (CTX - 1) * H}, {H, (uint64_t)B}, {NH * D, (uint64_t)B},
      {I, (uint64_t)B}};
  for (int i = 0; i < TM_COUNT && e == cudaSuccess; ++i) {
    const bool rows = i >= TM_XN;
    e = make_map(enc, &out[i], ptr[i], dims[i][0], dims[i][1],
                 rows ? stage_k(B) : FT, rows ? pass_rows(B) : stage_k(B),
                 rows && stage_k(B) == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                          : CU_TENSOR_MAP_SWIZZLE_128B,
                 rows ? CU_TENSOR_MAP_L2_PROMOTION_L2_128B
                      : CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
  }
  return e;
}

}  // namespace

extern "C" {

// Codes [B, 15] of one frame (Params above; scratch x, xn, attn, act, part
// [16384 * B + 1] f32 whose last word is zero when first passed, kc /
// vc [5, B, 8, 16, 128] bf16; phase_ns, when
// given, [9] u64 that gains the ns of each phase kind). codec_embd and
// embd hold bf16 rows, or f32 rows when f32_rows. The weights, xn, attn
// and act must be 16-byte aligned (their TMA maps). One cooperative
// launch on `stream`; returns its error.
int q3_codepred_frame(const float* hidden, const int* cb0,
                      const void* codec_embd, const void* wqkv,
                      const void* wo, const void* wgu, const void* wdown,
                      const float* attn_norm, const float* ffn_norm,
                      const float* q_norm, const float* k_norm,
                      const float* out_norm, const void* heads,
                      const void* embd, const float* gumbel,
                      const float* rope_c, const float* rope_s, float* logits,
                      int* codes, float* x, void* xn, void* attn, void* act,
                      float* part, void* kc, void* vc,
                      unsigned long long* phase_ns, int n_codec, int B,
                      int top_k, int greedy, int f32_rows, float eps,
                      float tinv, void* stream) {
  Params p{hidden, cb0, codec_embd, attn_norm, ffn_norm, q_norm, k_norm,
           out_norm, embd, gumbel, rope_c, rope_s, logits, codes, x,
           static_cast<bf16*>(xn), static_cast<bf16*>(attn),
           static_cast<bf16*>(act), part, static_cast<bf16*>(kc),
           static_cast<bf16*>(vc), phase_ns, n_codec, B, top_k, greedy, eps,
           tinv, {}};
  const void* maps[TM_COUNT] = {wqkv, wo, wgu, wdown, heads, xn, attn, act};
  cudaError_t e = tensor_maps(maps, B, p.tm);
  const cudaStream_t st = (cudaStream_t)stream;
  if (e == cudaSuccess)
    e = stage_k(B) == 64
            ? (f32_rows ? launch<true, 64>(p, st) : launch<false, 64>(p, st))
            : (f32_rows ? launch<true, 32>(p, st) : launch<false, 32>(p, st));
  if (e != cudaSuccess) return (int)e;
  ++g_launches;
  return (int)cudaGetLastError();
}

// Cooperative launches q3_codepred_frame has made in this process.
int q3_codepred_launches() { return g_launches; }

// Adds n to that count: a CUDA graph replay launches the kernel nodes its
// capture recorded without calling q3_codepred_frame (a capture, which
// launches nothing, takes its calls back). Returns the new count.
int q3_codepred_add_launches(int n) { return g_launches += n; }

}  // extern "C"
