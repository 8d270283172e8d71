// The talker's decode step, every layer in ONE persistent cooperative
// launch: replaces the Pallas kernel qwen3_tts_tpu/ops/talker_fused.py::
// talker_step_fused (all 28 layers of one decode step in one program).
//
// What bounds it on the H100: bytes. A step reads every layer's bf16
// weights once (28 x 15.7 M values = 881 MB at the 0.6B widths, 0.26 ms at
// 3.35 TB/s) plus the K/V rows attention needs (4 KiB per slot, stream and
// layer: 235 MB at B = 8 and read_ctx 256, 4.2 GB at B = 32 and 1,152).
// Its products have M = B rows, far under the ~295 flop/byte ridge, so
// they are bandwidth work; and the per-layer torch path this replaces was
// bound by ~100 host launches per layer. So the design:
// - one cooperative launch of about two CTAs per SM (sized by occupancy)
//   runs the layer loop itself; a grid-wide barrier separates the phases
//   of a layer:
//    1. residual (+ the previous layer's down-projection sums), RMSNorm,
//       bf16 -> abuf, one CTA per stream;
//    2. the QKV product;
//    3. per (stream, kv head): head norms, NEOX RoPE, and the K/V row
//       written in place at slot widx of cache[l] (int8: rounded half to
//       even, rintf, with its f32 scale);
//    4. attention per (stream, kv head, S split) into partials (m, l, acc);
//    5. the merge of the splits -> bf16 attention output;
//    6. the wo product; 7. residual + RMSNorm; 8. the gate/up product;
//    9. bf16(silu(g) * u); 10. the down product, whose residual add is
//       step 1 of the next layer (or the final pass);
// - a product is cut into tiles of 64 output columns x 256 K rows. A CTA
//   streams its tile's weights once into registers (16-byte loads,
//   coalesced along N), sums the 256 rows inside the CTA in a fixed order
//   and writes one partial sum per K tile; the phase that consumes the
//   product adds the K tiles in a fixed order. Deterministic, no atomics.
//   Tiles over K too, not only over columns, so that wo and down (1,024
//   columns, 16 tiles wide) still spread over every SM;
// - attention copies tiles of 64 slots of K and V into shared memory with
//   cp.async, the next tile in flight while this one is scored. Scores,
//   softmax and P.V in f32: P stays f32 before the PV product, as in
//   csrc/flash_decode.cu, where the TPU kernel rounds it to bf16. The
//   current row is read back from the cache like any other slot, which
//   gives the TPU kernel's current-row term (the dequantized row for int8);
// - positions, n_valid, widx and valid_mask are read from device memory,
//   so a step needs no host sync. Nothing at or past read_ctx is read.
// Numerics as the TPU kernel: xn rounded to bf16 before each product, f32
// accumulation, head norms, RoPE and softmax in f32, the attention output
// rounded to bf16 before wo, bf16(silu(g) * u) before down.
// Simple by intent: plain FMA in f32 on bf16 operands, no tensor cores, no
// TMA, 10 grid barriers per layer.

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
constexpr int GT_N = 64;         // product tile: output columns (8 x 8)
constexpr int GT_K = 256;        // product tile: K rows (32 groups x 8)
constexpr int GT_M = 8;          // stream rows per pass over a tile
constexpr int AT_ROWS = ATTN_TILE_ROWS;  // attention tile: cache slots
static_assert(TF_G * TF_D == TF_THREADS, "P.V maps a thread to (head, dim)");
static_assert(AT_ROWS * 4 == TF_THREADS, "scores map 4 threads to a slot");

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
  bf16* abuf;              // [B, <= 3H] the next product's input
  float* part;             // [K tiles, B, N] product partial sums
  bf16* qbuf;              // [B, NH, D] roped queries
  float* part_ml;          // [B * NH, n_split, 2] (room for n_tiles splits)
  float* part_acc;         // [B * NH, n_split, D]
  float* y;                // [B, H] residual stream, then the output
  int B, L, H, NKV, S, read_ctx, n_split;
  float eps, theta, qscale;
};

// y[b] = (base ? base[b] : y[b]) + sum of the ksplit partial sums of a
// [ksplit, B, H] product, in order; then, when w is given,
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
      for (int ks = 0; ks < ksplit; ++ks)
        s += __ldcg(p.part + ((size_t)ks * p.B + b) * H + i);
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

// part[ks][m][n] = sum over k in [ks*GT_K, (ks+1)*GT_K) of A[m][k] W[k][n]
// for A [M, K] bf16 (written in this launch) and W [K, N] bf16. Tile
// (64 columns, 256 rows): thread (c = tid % 8, rg = tid / 8) holds rows
// rg, rg + 32, ... and columns c*8 .. c*8+7 in registers; the 32 row groups
// are summed by two shuffles (4 groups a warp) and then over the 8 warps.
__device__ void phase_gemm(const bf16* A, const bf16* W, int M, int K, int N,
                           float* part, char* smem) {
  float* As = reinterpret_cast<float*>(smem);       // [GT_M][GT_K]
  float* red = As + GT_M * GT_K;                    // [warps][GT_M][GT_N]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c = tid & 7, rg = tid >> 3;
  const int n_tiles = N / GT_N, n_items = n_tiles * (K / GT_K);
  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    const int n0 = (it % n_tiles) * GT_N, ks = it / n_tiles;
    const int k0 = ks * GT_K;
    float w[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
      unpack8(__ldg(reinterpret_cast<const uint4*>(
                  W + (size_t)(k0 + r * 32 + rg) * N + n0 + c * 8)),
              w[r]);
    for (int m0 = 0; m0 < M; m0 += GT_M) {
      const int mc = min(GT_M, M - m0);
      __syncthreads();                  // the last pass is done with As, red
      {
        const int m = tid >> 5, kk = lane * 8;
        float a[8];
        if (m < mc) {
          unpack8(__ldcg(reinterpret_cast<const uint4*>(
                      A + (size_t)(m0 + m) * K + k0 + kk)),
                  a);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) a[j] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) As[m * GT_K + kk + j] = a[j];
      }
      __syncthreads();
      for (int m = 0; m < mc; ++m) {
        float acc[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] = 0.f;
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float a = As[m * GT_K + r * 32 + rg];
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[j] = fmaf(a, w[r][j], acc[j]);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], 8);
          acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], 16);
        }
        if (lane < 8) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            red[(warp * GT_M + m) * GT_N + c * 8 + j] = acc[j];
        }
      }
      __syncthreads();
      for (int o = tid; o < mc * GT_N; o += TF_THREADS) {
        const int m = o / GT_N, n = o % GT_N;
        float s = 0.f;
#pragma unroll
        for (int wi = 0; wi < TF_WARPS; ++wi)
          s += red[(wi * GT_M + m) * GT_N + n];
        part[((size_t)ks * M + m0 + m) * N + n0 + n] = s;
      }
    }
  }
}

// Per (stream b, kv head h): sum the QKV product's K tiles; round 0 treats
// the two query heads (one per half of the CTA), round 1 k (half 0) and v
// (half 1). q and k: head RMSNorm, then NEOX RoPE at positions[b]; q goes
// to qbuf as bf16, k and v into slot widx of cache[l].
template <bool INT8>
__device__ void phase_heads(const Params& p, int l) {
  __shared__ float buf[TF_THREADS];
  __shared__ float red[TF_WARPS];
  const int N = 4 * p.H, ksplit = p.H / GT_K, NKV = p.NKV, NH = 2 * NKV;
  const int half = threadIdx.x >> 7, d = threadIdx.x & (TF_D - 1);
  const float freq =
      expf((float)(d & (TF_D / 2 - 1)) * (-2.0f / TF_D) * logf(p.theta));
  const int widx = __ldg(p.widx);
  const bool slot_ok = widx >= 0 && widx < p.S;
  for (int it = blockIdx.x; it < p.B * NKV; it += gridDim.x) {
    const int b = it / NKV, h = it % NKV;
    float sn, cs;
    sincosf((float)__ldg(p.positions + b) * freq, &sn, &cs);
    for (int round = 0; round < 2; ++round) {
      const int col = round == 0 ? (TF_G * h + half) * TF_D + d
                                 : (NH + half * NKV + h) * TF_D + d;
      float v = 0.f;
      for (int ks = 0; ks < ksplit; ++ks)
        v += __ldcg(p.part + ((size_t)ks * p.B + b) * N + col);
      const bool roped = round == 0 || half == 0;
      const float ss = half_reduce<false>(v * v, red);
      if (roped) {
        const float* nw = round == 0 ? p.q_norm : p.k_norm;
        v = (v * rsqrtf(ss / (float)TF_D + p.eps)) * nw[l * TF_D + d];
      }
      __syncthreads();                          // buf is free
      buf[threadIdx.x] = v;
      __syncthreads();
      if (roped) {
        const float o = buf[threadIdx.x ^ (TF_D / 2)];
        v = d < TF_D / 2 ? v * cs - o * sn : v * cs + o * sn;
      }
      if (round == 0) {
        p.qbuf[((size_t)b * NH + TF_G * h + half) * TF_D + d] = f2bf(v);
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
  }
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
// split's (m, l) and acc rows of part_ml / part_acc.
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
    qs[g][d] = ldcg_bf(p.qbuf + ((size_t)b * NH + TF_G * h + g) * TF_D + d) *
               p.qscale;
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

// Merge the S splits of each query head; abuf [B, NH * D] = bf16 output
// (0 for a stream with no counted slot). Two heads a CTA item.
__device__ void phase_merge(const Params& p) {
  const int n = p.n_split, rows = p.B * 2 * p.NKV;
  const int d = threadIdx.x & (TF_D - 1);
  for (int it = blockIdx.x; it < rows / 2; it += gridDim.x) {
    const size_t row = (size_t)it * 2 + (threadIdx.x >> 7);
    const float* ml = p.part_ml + row * n * 2;
    float M = -CUDART_INF_F;
    for (int i = 0; i < n; ++i) M = fmaxf(M, __ldcg(ml + 2 * i));
    float o = 0.f;
    if (M != -CUDART_INF_F) {
      float L = 0.f, A = 0.f;
      for (int i = 0; i < n; ++i) {
        const float c = expf(__ldcg(ml + 2 * i) - M);
        L += __ldcg(ml + 2 * i + 1) * c;
        A += __ldcg(p.part_acc + (row * n + i) * TF_D + d) * c;
      }
      o = A / L;
    }
    p.abuf[row * TF_D + d] = f2bf(o);
  }
}

// abuf [B, I] = bf16(silu(g) * u) from the gate/up product's K tiles.
__device__ void phase_act(const Params& p) {
  const int I = 3 * p.H, N = 2 * I, ksplit = p.H / GT_K;
  for (int i = blockIdx.x * TF_THREADS + threadIdx.x; i < p.B * I;
       i += gridDim.x * TF_THREADS) {
    const int b = i / I, j = i % I;
    float gt = 0.f, up = 0.f;
    for (int ks = 0; ks < ksplit; ++ks) {
      const float* pr = p.part + ((size_t)ks * p.B + b) * N;
      gt += __ldcg(pr + j);
      up += __ldcg(pr + I + j);
    }
    p.abuf[i] = f2bf((gt / (1.f + expf(-gt))) * up);
  }
}

template <bool INT8>
__global__ void __launch_bounds__(TF_THREADS, 2)
talker_step_kernel(Params p) {
  extern __shared__ __align__(16) char smem[];
  cg::grid_group grid = cg::this_grid();
  const int H = p.H, NQ = 2 * H, I = 3 * H;
  for (int l = 0; l < p.L; ++l) {
    phase_norm(p, l == 0 ? p.x_in : nullptr, l == 0 ? 0 : I / GT_K,
               p.attn_norm + (size_t)l * H);
    grid.sync();
    phase_gemm(p.abuf, p.wqkv + (size_t)l * H * 4 * H, p.B, H, 4 * H, p.part,
               smem);
    grid.sync();
    phase_heads<INT8>(p, l);
    grid.sync();
    phase_attn<INT8>(p, l, smem);
    grid.sync();
    phase_merge(p);
    grid.sync();
    phase_gemm(p.abuf, p.wo + (size_t)l * NQ * H, p.B, NQ, H, p.part, smem);
    grid.sync();
    phase_norm(p, nullptr, NQ / GT_K, p.ffn_norm + (size_t)l * H);
    grid.sync();
    phase_gemm(p.abuf, p.wgu + (size_t)l * H * 2 * I, p.B, H, 2 * I, p.part,
               smem);
    grid.sync();
    phase_act(p);
    grid.sync();
    phase_gemm(p.abuf, p.wdown + (size_t)l * I * H, p.B, I, H, p.part, smem);
    grid.sync();
  }
  phase_norm(p, nullptr, I / GT_K, nullptr);        // y += the last down
}

template <bool INT8>
constexpr size_t smem_bytes() {
  return std::max<size_t>(4 * AT_ROWS * TF_D * (INT8 ? 1 : 2),
                          (GT_M * GT_K + TF_WARPS * GT_M * GT_N) *
                              sizeof(float));
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
                               (int)smem_bytes<INT8>());
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &occ, talker_step_kernel<INT8>, TF_THREADS, smem_bytes<INT8>());
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
  p.n_split = std::max(1, std::min(n_tiles, blocks / (p.B * p.NKV)));
  void* args[] = {&p};
  return cudaLaunchCooperativeKernel((const void*)talker_step_kernel<INT8>,
                                     dim3(blocks), dim3(TF_THREADS), args,
                                     smem_bytes<INT8>(), stream);
}

}  // namespace

extern "C" {

// One decode step of all L layers (Params above; the scratch part_ml and
// part_acc hold ceil(read_ctx / 64) splits a query head). One cooperative
// launch on `stream`; returns its error.
int q3_talker_step(const float* x_in, const int* positions,
                   const int* n_valid, const uint8_t* mask, const int* widx,
                   const void* wqkv, const void* wo, const void* wgu,
                   const void* wdown, const float* attn_norm,
                   const float* ffn_norm, const float* q_norm,
                   const float* k_norm, void* cache, float* scales,
                   void* abuf, float* part, void* qbuf, float* part_ml,
                   float* part_acc, float* y, int B, int L, int H, int NKV,
                   int S, int read_ctx, int int8, float eps, float theta,
                   float qscale, void* stream) {
  const Params p{x_in, positions, n_valid, mask, widx,
                 static_cast<const bf16*>(wqkv), static_cast<const bf16*>(wo),
                 static_cast<const bf16*>(wgu),
                 static_cast<const bf16*>(wdown), attn_norm, ffn_norm, q_norm,
                 k_norm, cache, scales, static_cast<bf16*>(abuf), part,
                 static_cast<bf16*>(qbuf), part_ml, part_acc, y, B, L, H, NKV,
                 S, read_ctx, 0, eps, theta, qscale};
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e = int8 ? launch<true>(p, st) : launch<false>(p, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
