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
//   7 into 6, as an epilogue over the whole K, leaves 96 items of 16
//   chunks each, which was slower on an H100 than the split product and
//   its extra barrier.) An optional clock (phase_ns) times each phase
//   kind;
// - products on tensor cores: mma.sync.aligned.m16n8k16 bf16 -> f32. An
//   item is 64 output columns (one n8 slice a warp) x 256 K rows.
//   Activation rows (bf16, written earlier in the launch) and weight rows
//   stream through a 4-stage cp.async ring of 64-row K chunks (A [64
//   rows][64 k] and W [64 k][64 cols], XOR-swizzled 16-byte chunks),
//   three chunks in flight ahead of the one the tensor cores consume,
//   across the item's and the next items' chunks. A fragments come from
//   ldmatrix.x4, B fragments from ldmatrix.x2.trans on the [K, N]
//   row-major weights (the JAX layout, nothing packed; the item walk,
//   the ring loop, the tensor-core and cp.async helpers and the partial
//   sums' epilogue are csrc/mma_ring.cuh's). Rows go in groups
//   of up to 64 (4 m16 tiles; any B >= 1, ragged tiles zero-filled); a
//   second group streams the item's weights again (from L2). Split-K
//   partial sums go to scratch and the consuming phase adds them in a
//   fixed order: no atomics, deterministic;
// - every read of data written in the launch goes through L2 (__ldcg,
//   cp.async.cg): L1 is not coherent across SMs.
// Rows behind an mtp projection (the 1.7B shape: a 2048-wide talker before
// the 1024-wide code predictor): the projection is linear and sits only at
// the stack's input, so the wrapper projects position 0's hidden and hands
// the kernel f32 tables of pre-projected rows (ops/codepred_fused.py
// fold_mtp) in place of the bf16 embeddings. The row type of the gathers
// (embed_norm) is the kernel's one template parameter: F32_ROWS.
// Numerics as the twin (ops/codepred_fused.py): xn rounded to bf16 before
// each product, f32 accumulation, head norms, RoPE and softmax in f32, the
// attention output and silu(g) * u rounded to bf16; greedy = first
// argmax; sampled = exact top-k threshold (32-step binary search over
// monotone uint32 keys, ties kept), then first argmax of z + noise.

#include <cooperative_groups.h>
#include <math_constants.h>

#include <algorithm>
#include <type_traits>

#include "attn_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// the code predictor of the 0.6B, the 1.7B and Qwen3-Omni's talker
constexpr int H = 1024, NH = 16, NKV = 8, D = 128, I = 3072, V = 2048;
constexpr int L = 5, CTX = 16;
constexpr int NQKV = (NH + 2 * NKV) * D;            // 4096
// products (items of PROD_NT columns, csrc/mma_ring.cuh)
constexpr int KC = PROD_KC;       // K rows a ring stage
constexpr int NST = 4;            // ring stages
constexpr int KSPAN = 256;        // K rows a split-K item sums
constexpr int A_BYTES = PROD_MG * KC * 2;
constexpr int STAGE_BYTES = A_BYTES + KC * PROD_NT * 2;  // 16 KB
constexpr int SMEM_BYTES = NST * STAGE_BYTES;
static_assert(PROD_NT == WARPS * 8, "one n8 slice a warp");
static_assert(2 * CTX * D * 4 <= SMEM_BYTES, "attention rows fit");
static_assert((CTX - 1) * D / 8 <= THREADS, "earlier slots in one load");

struct Params {
  const float* hidden;     // [B, H]
  const int* cb0;          // [B]
  const void* codec_embd;  // [n_codec, H] rows, bf16 or f32 (F32_ROWS)
  const bf16* wqkv;        // [L, H, NQKV]
  const bf16* wo;          // [L, NH * D, H]
  const bf16* wgu;         // [L, H, 2I]
  const bf16* wdown;       // [L, I, H]
  const float* attn_norm;  // [L, H]
  const float* ffn_norm;   // [L, H]
  const float* q_norm;     // [L, D]
  const float* k_norm;     // [L, D]
  const float* out_norm;   // [H]
  const bf16* heads;       // [15, H, V]
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
  float* part;             // [splits, B, N] split-K sums, <= 4 x 6144
  bf16* kc;                // [L, B, NKV, CTX, D]
  bf16* vc;
  unsigned long long* phase_ns;  // [PH_KINDS] ns by phase kind, or null
  int n_codec, B, top_k, greedy;
  float eps, tinv;
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

// One product phase: part[ks][m][n] = the sum over the K rows of split ks
// of A[m][k] W[k][n], for A [B, K] (bf16, written earlier in the launch)
// and W [K, ldw] (bf16), in items of PROD_NT columns x KSPAN rows
// (mma_ring.cuh's walk and ring). A stage holds a chunk's A rows and its
// W rows, both copied by cp.async.
struct Prod {
  const bf16* A;
  int lda;
  const bf16* W;
  int ldw, K;
};

__device__ void phase_product(const Params& p, const Prod& pr, char* smem) {
  const int tid = threadIdx.x;
  const ItemWalk<KSPAN> wk(pr.ldw, pr.K, p.B);
  // chunk c -> stage c % NST: its A rows (zero past B), then its W rows
  const auto issue = [&](int c) {
    if (c < wk.total) {
      const Chunk ch = wk.at(c);
      char* sa = smem + (c % NST) * STAGE_BYTES;
      char* sw = sa + A_BYTES;
      const int k0 = ch.ks * KSPAN + ch.kc * KC;
      for (int i = tid; i < ch.n_mt * 16 * 8; i += THREADS) {
        const int r = i >> 3, c16 = i & 7, m = ch.m0 + r;
        if (m < p.B)
          cp_async16(sa + swz(r, c16),
                     pr.A + (size_t)m * pr.lda + k0 + c16 * 8);
        else
          *reinterpret_cast<uint4*>(sa + swz(r, c16)) = make_uint4(0, 0, 0, 0);
      }
      for (int i = tid; i < KC * 8; i += THREADS) {
        const int r = i >> 3, c16 = i & 7;
        cp_async16(sw + swz(r, c16), pr.W + (size_t)(k0 + r) * pr.ldw +
                                         ch.tile * PROD_NT + c16 * 8);
      }
    }
    cp_async_commit();                  // empty past the end: counts stay
  };
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) issue(s);
  ring_product<NST>(wk, p.part, pr.ldw, issue, [](int) {},
                    [&](int c, const Chunk&) {
                      const char* sa = smem + (c % NST) * STAGE_BYTES;
                      return Operands{sa, KC * 2, 0, sa + A_BYTES};
                    });
}

// act[b][j] = bf16(silu(g) * u) from the gate/up product's K splits,
// summed in order ([g | u] = columns j and I + j).
__device__ void phase_act(const Params& p) {
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < p.B * I;
       i += gridDim.x * THREADS) {
    const int b = i / I, j = i % I;
    float g = 0.f, u = 0.f;
#pragma unroll
    for (int ks = 0; ks < H / KSPAN; ++ks) {
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
      for (int k4 = 0; k4 < H / KSPAN; ++k4)
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
      for (int k4 = 0; k4 < H / KSPAN; ++k4)
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

template <bool F32_ROWS>
__global__ void __launch_bounds__(THREADS, 2) codepred_frame_kernel(Params p) {
  using Row = std::conditional_t<F32_ROWS, float, bf16>;
  extern __shared__ __align__(16) char smem[];
  cg::grid_group grid = cg::this_grid();
  const Prod qkv{p.xn, H, p.wqkv, NQKV, H};
  const Prod wo{p.attn, NH * D, p.wo, H, NH * D};
  const Prod gu{p.xn, H, p.wgu, 2 * I, H};
  const Prod down{p.act, I, p.wdown, H, I};
  const Prod head{p.xn, H, p.heads, V, H};
  // a product's weights at layer l (or head p - 1)
  const auto at = [](Prod pr, size_t offset) {
    pr.W += offset;
    return pr;
  };
  unsigned long long t_mark = globaltimer();
  const auto sync = [&](int kind) {
    grid.sync();
    if (p.phase_ns && blockIdx.x == 0 && threadIdx.x == 0)
      clock_mark(p, kind, t_mark);
  };
  phase_norm<0>(p, p.hidden, p.attn_norm);          // position 0's input
  sync(PH_NORM);
  for (int pos = 0; pos < CTX; ++pos) {
    for (int l = 0; l < L; ++l) {
      if (l > 0) {
        phase_norm<I / KSPAN>(p, nullptr, p.attn_norm + (size_t)l * H);
        sync(PH_NORM);
      }
      phase_product(p, at(qkv, (size_t)l * H * NQKV), smem);
      sync(PH_QKV);
      const bool last0 = pos == 0 && l == L - 1;
      phase_attn<Row>(p, l, pos, last0, smem);
      sync(PH_ATTN);
      if (last0) break;                 // position 0's output is never read
      phase_product(p, at(wo, (size_t)l * NH * D * H), smem);
      sync(PH_WO);
      phase_norm<NH * D / KSPAN>(p, nullptr, p.ffn_norm + (size_t)l * H);
      sync(PH_NORM);
      phase_product(p, at(gu, (size_t)l * H * 2 * I), smem);
      sync(PH_GU);
      phase_act(p);
      sync(PH_ACT);
      phase_product(p, at(down, (size_t)l * I * H), smem);
      sync(PH_DOWN);
    }
    if (pos == 0) continue;
    phase_norm<I / KSPAN>(p, nullptr, p.out_norm);
    sync(PH_NORM);
    phase_product(p, at(head, (size_t)(pos - 1) * H * V), smem);
    sync(PH_HEAD);
    phase_sample<Row>(p, pos);
    if (pos < CTX - 1) sync(PH_SAMPLE);
  }
  if (p.phase_ns) sync(PH_SAMPLE);     // the last sampler's end
}

int g_launches = 0;               // cooperative launches made

// The CTAs of one cooperative launch of an instantiation: occupancy x
// SMs, at most 2 a SM (every CTA must be resident for the grid barrier).
// Sets the kernel's shared-memory size on first use.
template <bool F32_ROWS>
cudaError_t grid_size(int* blocks) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0, sms = 0, occ = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(codepred_frame_kernel<F32_ROWS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &occ, codepred_frame_kernel<F32_ROWS>, THREADS, SMEM_BYTES);
    if (e != cudaSuccess) return e;
    if (occ < 1) return cudaErrorInvalidConfiguration;
    cached = sms * std::min(occ, 2);
  }
  *blocks = cached;
  return cudaSuccess;
}

template <bool F32_ROWS>
cudaError_t launch(Params& p, cudaStream_t stream) {
  int blocks = 0;
  cudaError_t e = grid_size<F32_ROWS>(&blocks);
  if (e != cudaSuccess) return e;
  void* args[] = {&p};
  return cudaLaunchCooperativeKernel(
      (const void*)codepred_frame_kernel<F32_ROWS>, dim3(blocks),
      dim3(THREADS), args, SMEM_BYTES, stream);
}

}  // namespace

extern "C" {

// Codes [B, 15] of one frame (Params above; scratch x, xn, attn, act, part
// [24576 * B] f32, kc / vc [5, B, 8, 16, 128] bf16; phase_ns, when
// given, [9] u64 that gains the ns of each phase kind). codec_embd and
// embd hold bf16 rows, or f32 rows when f32_rows. One cooperative launch
// on `stream`; returns its error.
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
  const auto b16 = [](const void* q) { return static_cast<const bf16*>(q); };
  Params p{hidden, cb0, codec_embd, b16(wqkv), b16(wo), b16(wgu),
           b16(wdown), attn_norm, ffn_norm, q_norm, k_norm, out_norm,
           b16(heads), embd, gumbel, rope_c, rope_s, logits, codes, x,
           static_cast<bf16*>(xn), static_cast<bf16*>(attn),
           static_cast<bf16*>(act), part, static_cast<bf16*>(kc),
           static_cast<bf16*>(vc), phase_ns, n_codec, B, top_k, greedy, eps,
           tinv};
  const cudaError_t e = f32_rows ? launch<true>(p, (cudaStream_t)stream)
                                 : launch<false>(p, (cudaStream_t)stream);
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
