// Single-token GQA decode attention over the kv-major KV cache, as
// flash-decoding: replaces the Pallas kernel
// qwen3_tts_tpu/ops/flash_decode.py::flash_decode / flash_decode_masked.
//
// What bounds it: bytes. A decode step reads each needed K/V row once
// (2 x 128 values per row and kv head) and does about 4G FLOPs per value
// read, far under the ~295 FLOPs per byte where the H100's tensor cores
// would become the limit. So the design spends nothing on tensor cores and
// everything on keeping enough bytes in flight to cover HBM latency while
// reading only what is needed, once:
// - one CTA of 256 threads per (S split, kv head, stream), at most 3 CTAs
//   a SM (__launch_bounds__; two stages of a bf16 tile take 64 KB of
//   shared memory); a second kernel merges the splits' (m, l, acc). A CTA
//   walks its split's tiles one after another and the tiles a call needs
//   cluster (a prefix, a ring window), so the wrapper keeps splits short:
//   two tiles, one where that would leave CTA slots idle (split_plan in
//   ops/flash_decode.py);
// - K and V are copied in tiles of 64 slots (and, for int8, the tile's 64
//   K and 64 V scales) into shared memory with cp.async, 16 bytes a
//   thread, two stages: the next needed tile is in flight while this one
//   is scored. One tile of K and V per CTA is in flight while the CTA
//   computes, 32 KB bf16 (16.5 KB int8), so with 3 CTAs a SM about 96 KB
//   (bf16) or 50 KB (int8) a SM: at read_ctx 1,152, B=8 (64 (stream, kv
//   head) pairs x 9 splits, 576 CTAs) and B=32 (2,304 CTAs) hold 3 CTAs
//   on every SM until their last wave. Little's law asks ~25 KB a SM
//   (3.35 TB/s x ~1 us / 132 SMs). A warp a row, one 512-byte row in
//   flight per warp, held ~4 KB a SM;
// - scores per tile, not per row: 4 threads a slot, 32 dims each (odd
//   slots read their 16-byte chunks in a rotated order, so that no two
//   slots of a read phase share banks), two shuffles; one online-softmax update per tile and query
//   head (one warp a head); P.V with one thread per (query head, dim)
//   over the tile (G = 1: two threads, one per half of the tile, summed
//   at the end in a fixed order; G = 4: two (head, dim) pairs a thread;
//   G = 8, Qwen3-Omni's 16 / 2 heads: four pairs a thread, a warp a head
//   in the softmax step).
//   Probabilities stay f32; int8 rows are dequantized from shared memory
//   (the K scale on the score, the V scale on the probability);
// - the CTA decides in the kernel which 64-slot tiles it needs, from
//   device-resident n_valid / lo / hi: the prefix t*64 < n_valid, or the
//   ring window [0, prefill_len) U [lo, hi) (U of both ends when lo > hi),
//   never past read_ctx; rows of a needed tile that do not count (past
//   n_valid, mask bit clear, at or past read_ctx) are zero-filled, not read.
//   The split's mask bytes are staged in shared memory at the start, so
//   that no row copy waits on a mask load.
// What bounds it as built: the chain of tiles each CTA walks, not bytes.
// A tile costs a copy issued one tile ahead, four CTA barriers, scores,
// one softmax step and P.V, so a split of many needed tiles sets the
// time; on an H100 that is ~3x the bytes bound, and the int8 cache, half
// the bytes, takes longer than bf16 (PERF.md).
// Online softmax in f32; a stream with no valid slot outputs 0.

#include <math_constants.h>

#include "attn_tile.cuh"

namespace {

constexpr int FD_D = 128;        // head dim served
constexpr int FD_THREADS = 256;
constexpr int FD_ROWS = ATTN_TILE_ROWS;
static_assert(FD_ROWS * 4 == FD_THREADS, "scores map 4 threads to a slot");

template <int G, bool INT8>
struct FdGeom {
  static constexpr int RB = FD_D * (INT8 ? 1 : 2);   // bytes per cache row
  static constexpr int TILE = FD_ROWS * RB;           // bytes of a K tile
  // one stage: K tile, V tile, then (int8) 64 K and 64 V scales
  static constexpr int STAGE = 2 * TILE + (INT8 ? 2 * FD_ROWS * 4 : 0);
  static constexpr int SMEM = 2 * STAGE;
  static constexpr int NP = G * FD_D;                 // (head, dim) pairs
  static constexpr int P0 = NP < FD_THREADS ? NP : FD_THREADS;
  static constexpr int SUBS = FD_THREADS / P0;        // slot ranges of P.V
  static constexpr int PAIRS = NP / P0;               // pairs a thread
};

template <bool INT8>
__device__ __forceinline__ float tile_value(const char* t, int i) {
  if constexpr (INT8) return (float)reinterpret_cast<const int8_t*>(t)[i];
  return bf2f(reinterpret_cast<const bf16*>(t)[i]);
}

// grid (n_split, n_kv, B), 256 threads. Writes this split's (m, l) to
// part_ml[row, split] and acc to part_acc[row, split, :], row =
// (b * n_kv + h) * G + g; m = -inf and l = acc = 0 when it saw no slot.
template <int G, bool INT8>
__global__ void __launch_bounds__(FD_THREADS, 3)
fd_split_kernel(const bf16* __restrict__ q, const void* __restrict__ k,
                const void* __restrict__ v,
                const float* __restrict__ k_scale,
                const float* __restrict__ v_scale,
                const int* __restrict__ n_valid,
                const uint8_t* __restrict__ mask,
                const int* __restrict__ lo, const int* __restrict__ hi,
                int hi_stride, int prefill_len, int S, int read_ctx,
                int tiles_per_split, float scale,
                float* __restrict__ part_ml, float* __restrict__ part_acc,
                int* __restrict__ wrapped) {
  using Geo = FdGeom<G, INT8>;
  constexpr int RB = Geo::RB, TILE = Geo::TILE, STAGE = Geo::STAGE;
  constexpr int P0 = Geo::P0, SUBS = Geo::SUBS, PAIRS = Geo::PAIRS;
  constexpr int SPAN = FD_ROWS / SUBS;
  static_assert(SUBS <= 2, "P.V sums at most two slot ranges");
  extern __shared__ __align__(16) char smem[];
  __shared__ float qs[G][FD_D];
  __shared__ float sc[G][FD_ROWS];
  __shared__ float pw[G][FD_ROWS];
  __shared__ float sm_m[G], sm_l[G], sm_a[G];
  __shared__ float red[P0];
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x, n_kv = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t head0 = (size_t)(b * n_kv + h) * G;   // first query row

  for (int i = tid; i < G * FD_D; i += FD_THREADS)
    qs[i / FD_D][i % FD_D] = bf2f(q[head0 * FD_D + i]) * scale;
  if (tid < G) {
    sm_m[tid] = -CUDART_INF_F;
    sm_l[tid] = 0.f;
  }
  const int nv = n_valid ? n_valid[b] : 0;
  const int wlo = lo ? lo[b] : 0;
  const int whi = lo ? hi[b * hi_stride] : 0;
  if (wrapped && lo && wlo > whi && split == 0 && h == 0 && tid == 0)
    atomicAdd(wrapped, 1);
  const int n_tiles = (read_ctx + FD_ROWS - 1) / FD_ROWS;
  const int t0 = split * tiles_per_split;
  const int t1 = min(t0 + tiles_per_split, n_tiles);
  // the split's mask bytes, staged once: no row copy waits on a mask load
  uint8_t* msk = reinterpret_cast<uint8_t*>(smem + 2 * STAGE);
  const int s_lo = t0 * FD_ROWS;
  if (!n_valid) {
    const uint8_t* mrow = mask + (size_t)b * S;
    for (int s = s_lo + tid; s < min(t1 * FD_ROWS, read_ctx); s += FD_THREADS)
      msk[s - s_lo] = mrow[s];
  }
  const auto counted = [&](int s) {
    return s < read_ctx && (n_valid ? s < nv : msk[s - s_lo] != 0);
  };
  const auto needed = [&](int t) {                    // uniform in the CTA
    const int s0 = t * FD_ROWS, e = s0 + FD_ROWS;
    if (n_valid) return s0 < nv;
    if (!lo) return true;
    return s0 < prefill_len ||
           (wlo > whi ? (s0 < whi || e > wlo) : (s0 < whi && e > wlo));
  };
  const auto next = [&](int t) {
    while (t < t1 && !needed(t)) ++t;
    return t;
  };
  const size_t row0 = (size_t)(b * n_kv + h) * S;    // cache row of slot 0
  const char* kb = static_cast<const char*>(k) + row0 * RB;
  const char* vb = static_cast<const char*>(v) + row0 * RB;
  const auto issue = [&](int t, int stage) {
    char* base = smem + stage * STAGE;
    copy_kv_tile<RB, FD_THREADS>(base, base + TILE, kb, vb, t * FD_ROWS,
                                 counted);
    if (INT8 && tid < 2 * FD_ROWS) {                  // [K scales | V scales]
      const int s = t * FD_ROWS + (tid & (FD_ROWS - 1));
      float* dst = reinterpret_cast<float*>(base + 2 * TILE) + tid;
      if (counted(s))
        cp_async4(dst, (tid < FD_ROWS ? k_scale : v_scale) + row0 + s);
      else
        *dst = 0.f;
    }
    cp_async_commit();
  };

  float acc[PAIRS];
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) acc[i] = 0.f;
  const int r = tid >> 2, qd = tid & 3;               // scores: (slot, quarter)
  const int sub = tid / P0;                           // P.V: slot range
  int cur = next(t0), stage = 0;
  __syncthreads();                                    // qs, sm_m, sm_l, msk
  if (cur < t1) issue(cur, 0);
  while (cur < t1) {
    const int nx = next(cur + 1);
    if (nx < t1) {
      issue(nx, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const char* kt = smem + stage * STAGE;
    const char* vt = kt + TILE;
    const float* sct = reinterpret_cast<const float*>(kt + 2 * TILE);
    // scores: 4 threads a slot; thread qd takes 16-byte chunks qd, qd + 4,
    // .. from chunk 4 on in odd slots, so that the two slots a group of 8
    // threads reads sit in other banks
    const bool valid = counted(cur * FD_ROWS + r);
    float d[G];
#pragma unroll
    for (int g = 0; g < G; ++g) d[g] = 0.f;
    constexpr int CH = INT8 ? 2 : 4, PER = INT8 ? 16 : 8;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int j = (qd + 4 * c + ((r & 1) << 2)) & (RB / 16 - 1);
      const uint4 raw =
          *reinterpret_cast<const uint4*>(kt + r * RB + j * 16);
      float kv[PER];
      if constexpr (INT8) {
        const int8_t* k8 = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
        for (int i = 0; i < PER; ++i) kv[i] = (float)k8[i];
      } else {
        unpack8(raw, kv);
      }
#pragma unroll
      for (int i = 0; i < PER; ++i)
#pragma unroll
        for (int g = 0; g < G; ++g) d[g] = fmaf(qs[g][j * PER + i], kv[i], d[g]);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      d[g] += __shfl_xor_sync(0xffffffffu, d[g], 1);
      d[g] += __shfl_xor_sync(0xffffffffu, d[g], 2);
    }
    if (qd == 0) {
      const float ks = INT8 ? sct[r] : 1.f;
#pragma unroll
      for (int g = 0; g < G; ++g) sc[g][r] = valid ? d[g] * ks : -CUDART_INF_F;
    }
    __syncthreads();
    if (warp < G) {                       // one softmax update a tile and head
      const float s0 = sc[warp][lane], s1 = sc[warp][lane + 32];
      const float m_old = sm_m[warp];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = s0 == -CUDART_INF_F ? 0.f : expf(s0 - m_new);
      const float p1 = s1 == -CUDART_INF_F ? 0.f : expf(s1 - m_new);
      const float alpha = m_old == -CUDART_INF_F ? 0.f : expf(m_old - m_new);
      const float psum = warp_sum(p0 + p1);
      const float v0 = INT8 ? sct[FD_ROWS + lane] : 1.f;
      const float v1 = INT8 ? sct[FD_ROWS + lane + 32] : 1.f;
      pw[warp][lane] = p0 * v0;
      pw[warp][lane + 32] = p1 * v1;
      if (lane == 0) {
        sm_l[warp] = sm_l[warp] * alpha + psum;
        sm_m[warp] = m_new;
        sm_a[warp] = alpha;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {     // P.V: rows that do not count are 0
      const int pr = tid % P0 + i * P0, g = pr / FD_D, dd = pr % FD_D;
      float a = acc[i] * sm_a[g];
#pragma unroll 8
      for (int j = sub * SPAN; j < (sub + 1) * SPAN; ++j)
        a = fmaf(pw[g][j], tile_value<INT8>(vt, j * FD_D + dd), a);
      acc[i] = a;
    }
    __syncthreads();                      // this stage may be refilled
    cur = nx;
    stage ^= 1;
  }

  if (SUBS == 2) {                        // the second half of the tile
    if (tid >= P0) red[tid - P0] = acc[0];
    __syncthreads();
  }
  if (tid < P0) {
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      const int pr = tid + i * P0, g = pr / FD_D, dd = pr % FD_D;
      const float a = SUBS == 2 ? acc[i] + red[tid] : acc[i];
      const size_t prow = (head0 + g) * n_split + split;
      part_acc[prow * FD_D + dd] = a;
      if (dd == 0) {
        part_ml[prow * 2] = sm_m[g];
        part_ml[prow * 2 + 1] = sm_l[g];
      }
    }
  }
}

// grid (B * n_heads), FD_D threads: merge the splits of one query head.
__global__ void __launch_bounds__(FD_D)
fd_combine_kernel(const float* __restrict__ part_ml,
                  const float* __restrict__ part_acc, int n_split,
                  float* __restrict__ out) {
  const size_t row = blockIdx.x;
  const int d = threadIdx.x;
  const float* ml = part_ml + row * n_split * 2;
  float M = -CUDART_INF_F;
  for (int i = 0; i < n_split; ++i) M = fmaxf(M, ml[2 * i]);
  float o = 0.f;                                      // no valid slot: 0
  if (M != -CUDART_INF_F) {
    float L = 0.f, A = 0.f;
    for (int i = 0; i < n_split; ++i) {
      const float c = expf(ml[2 * i] - M);
      L += ml[2 * i + 1] * c;
      A += part_acc[(row * n_split + i) * FD_D + d] * c;
    }
    o = A / L;
  }
  out[row * FD_D + d] = o;
}

template <int G, bool INT8>
cudaError_t launch_split(dim3 grid, cudaStream_t st, const void* q,
                         const void* k, const void* v, const float* ks,
                         const float* vs, const int* n_valid,
                         const uint8_t* mask, const int* lo, const int* hi,
                         int hi_stride, int prefill_len, int S, int read_ctx,
                         int tiles_per_split, float scale, float* part_ml,
                         float* part_acc, int* wrapped) {
  // two stages, then the split's mask bytes
  const int SMEM = FdGeom<G, INT8>::SMEM + ((tiles_per_split * FD_ROWS + 15) &
                                            ~15);
  static int sized = 0;                   // the > 48 KB opt-in, as it grows
  if (SMEM > sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        fd_split_kernel<G, INT8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM);
    if (e != cudaSuccess) return e;
    sized = SMEM;
  }
  fd_split_kernel<G, INT8><<<grid, FD_THREADS, SMEM, st>>>(
      static_cast<const bf16*>(q), k, v, ks, vs, n_valid, mask, lo, hi,
      hi_stride, prefill_len, S, read_ctx, tiles_per_split, scale, part_ml,
      part_acc, wrapped);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B, n_kv*G, 128] bf16; k, v [B, n_kv, S, 128] bf16, or int8 with
// k_scale / v_scale [B, n_kv, S] f32 (k and v 16-byte aligned). Exactly
// one of n_valid [B] (prefix) and mask [B, S] (bitmask) is given; lo [B]
// with hi (hi_stride 0 for a scalar, 1 for [B]) adds the ring window.
// Split i covers the 64-slot tiles [i * tiles_per_split, (i + 1) *
// tiles_per_split). part_ml [B*n_heads, n_split, 2] and part_acc
// [B*n_heads, n_split, 128] f32 are scratch; out [B, n_heads*128] f32.
// wrapped, when given, gains one per stream served with lo > hi. Two
// launches; returns the first launch error.
int q3_flash_decode(const void* q, const void* k, const void* v,
                    const float* k_scale, const float* v_scale,
                    const int* n_valid, const uint8_t* mask, const int* lo,
                    const int* hi, int hi_stride, int prefill_len, int B,
                    int n_kv, int G, int S, int read_ctx, int tiles_per_split,
                    int n_split, float scale, int int8, float* part_ml,
                    float* part_acc, float* out, int* wrapped, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(n_split, n_kv, B);
#define FD_ARGS grid, st, q, k, v, k_scale, v_scale, n_valid, mask, lo, hi, \
    hi_stride, prefill_len, S, read_ctx, tiles_per_split, scale, part_ml,    \
    part_acc, wrapped
  cudaError_t err;
  if (G == 1 && !int8) err = launch_split<1, false>(FD_ARGS);
  else if (G == 1) err = launch_split<1, true>(FD_ARGS);
  else if (G == 2 && !int8) err = launch_split<2, false>(FD_ARGS);
  else if (G == 2) err = launch_split<2, true>(FD_ARGS);
  else if (G == 4 && !int8) err = launch_split<4, false>(FD_ARGS);
  else if (G == 4) err = launch_split<4, true>(FD_ARGS);
  else if (G == 8 && !int8) err = launch_split<8, false>(FD_ARGS);
  else if (G == 8) err = launch_split<8, true>(FD_ARGS);
  else return (int)cudaErrorInvalidValue;
#undef FD_ARGS
  if (err != cudaSuccess) return (int)err;
  fd_combine_kernel<<<B * n_kv * G, FD_D, 0, st>>>(part_ml, part_acc,
                                                     n_split, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
