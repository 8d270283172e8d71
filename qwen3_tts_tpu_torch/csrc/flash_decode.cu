// Single-token GQA decode attention over the kv-major KV cache, as
// flash-decoding: replaces the Pallas kernel
// qwen3_tts_tpu/ops/flash_decode.py::flash_decode / flash_decode_masked.
//
// What bounds it: bytes. A decode step reads each needed K/V row once
// (2 x 128 values per row and kv head) and does about 4G FLOPs per value
// read, far under the ~295 FLOPs per byte where the H100's tensor cores
// would become the limit. So the design spends nothing on tensor cores
// and everything on reading only what is needed, once:
// - one CTA per (S split, kv head, stream). At 8 streams x 8 kv heads
//   there are only 64 (stream, head) pairs for 132 SMs, so S is split and
//   a second kernel merges the splits' (m, l, acc);
// - the CTA keeps its kv head's G query heads in registers and reads each
//   K/V row once for all G (GQA);
// - the CTA decides in the kernel which blocks of `bs` slots it needs, from
//   device-resident n_valid / lo / hi: the prefix j*bs < n_valid, or the
//   ring window [0, prefill_len) U [lo, hi) (U of both ends when lo > hi),
//   never past read_ctx. The TPU kernel's argsorted, scalar-prefetched
//   (stream, block) schedule and its seq-major transpose are not needed:
//   K/V are read in place from the [B, kv, S, D] views of the cache;
// - inside a needed block each slot is masked exactly (prefix or bitmask);
// - int8 rows are dequantized in the load (value x row scale, f32).
// Online softmax in f32; a stream with no valid slot outputs 0.
//
// Simple by intent: one warp per cache row (plain FMA, a warp reduction
// per query head), no cp.async, no TMA.

#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int FD_D = 128;      // head dim served
constexpr int FD_WARPS = 4;    // one thread per head-dim element at merge
static_assert(FD_WARPS * 32 == FD_D, "merge maps one thread to one dim");

template <bool INT8>
__device__ __forceinline__ void load_row4(const void* base, size_t off,
                                          float scale, float* r) {
  if constexpr (INT8) {
    const char4 c = *reinterpret_cast<const char4*>(
        static_cast<const int8_t*>(base) + off);
    r[0] = c.x * scale;
    r[1] = c.y * scale;
    r[2] = c.z * scale;
    r[3] = c.w * scale;
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>(
        static_cast<const bf16*>(base) + off);
    r[0] = __uint_as_float(raw.x << 16);
    r[1] = __uint_as_float(raw.x & 0xffff0000u);
    r[2] = __uint_as_float(raw.y << 16);
    r[3] = __uint_as_float(raw.y & 0xffff0000u);
  }
}

// grid (n_split, n_kv, B), FD_WARPS warps. Writes this split's merged
// (m, l) to part_ml[row, split] and acc to part_acc[row, split, :], row =
// (b * n_kv + h) * G + g; m = -inf and l = acc = 0 when it saw no slot.
template <int G, bool INT8>
__global__ void __launch_bounds__(FD_WARPS * 32)
fd_split_kernel(const bf16* __restrict__ q, const void* __restrict__ k,
                const void* __restrict__ v,
                const float* __restrict__ k_scale,
                const float* __restrict__ v_scale,
                const int* __restrict__ n_valid,
                const uint8_t* __restrict__ mask,
                const int* __restrict__ lo, const int* __restrict__ hi,
                int hi_stride, int prefill_len, int S, int read_ctx, int bs,
                int blocks_per_split, float scale,
                float* __restrict__ part_ml, float* __restrict__ part_acc,
                int* __restrict__ wrapped) {
  __shared__ float sm_m[FD_WARPS][G], sm_l[FD_WARPS][G];
  __shared__ float sm_acc[FD_WARPS][G][FD_D];
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x, n_kv = gridDim.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d0 = lane * 4;
  const size_t head0 = (size_t)(b * n_kv + h) * G;   // first query row

  float qr[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load_row4<false>(q, (head0 + g) * FD_D + d0, 1.f, qr[g]);
#pragma unroll
    for (int i = 0; i < 4; ++i) qr[g][i] *= scale;
  }

  const int nv = n_valid ? n_valid[b] : 0;
  const int wlo = lo ? lo[b] : 0;
  const int whi = lo ? hi[b * hi_stride] : 0;
  if (wrapped && lo && wlo > whi && split == 0 && h == 0 && threadIdx.x == 0)
    atomicAdd(wrapped, 1);

  const size_t row0 = (size_t)(b * n_kv + h) * S;    // cache row of slot 0
  float m[G], l[G], acc[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -CUDART_INF_F;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[g][i] = 0.f;
  }

  const int j0 = split * blocks_per_split;
  for (int j = j0; j < j0 + blocks_per_split; ++j) {
    const int s0 = j * bs;
    if (s0 >= read_ctx) break;
    bool need = true;
    if (n_valid) {
      need = s0 < nv;
    } else if (lo) {
      const int e = s0 + bs;
      need = s0 < prefill_len ||
             (wlo > whi ? (s0 < whi || e > wlo) : (s0 < whi && e > wlo));
    }
    if (!need) continue;                              // uniform in the CTA
    const int s1 = min(s0 + bs, read_ctx);
    for (int s = s0 + warp; s < s1; s += FD_WARPS) {
      if (n_valid ? s >= nv : !mask[(size_t)b * S + s]) continue;
      const size_t row = row0 + s;
      float kr[4], vr[4];
      load_row4<INT8>(k, row * FD_D + d0, INT8 ? k_scale[row] : 1.f, kr);
      load_row4<INT8>(v, row * FD_D + d0, INT8 ? v_scale[row] : 1.f, vr);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float sc = warp_sum(qr[g][0] * kr[0] + qr[g][1] * kr[1] +
                                  qr[g][2] * kr[2] + qr[g][3] * kr[3]);
        const float m_new = fmaxf(m[g], sc);
        const float alpha = expf(m[g] - m_new);       // 0 while m = -inf
        const float p = expf(sc - m_new);
        l[g] = l[g] * alpha + p;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[g][i] = acc[g][i] * alpha + p * vr[i];
        m[g] = m_new;
      }
    }
  }

  // merge the warps' states; thread t owns head dim t
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) sm_acc[warp][g][d0 + i] = acc[g][i];
  }
  __syncthreads();
  const int d = threadIdx.x;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float M = -CUDART_INF_F;
#pragma unroll
    for (int w = 0; w < FD_WARPS; ++w) M = fmaxf(M, sm_m[w][g]);
    float L = 0.f, A = 0.f;
    if (M != -CUDART_INF_F) {
#pragma unroll
      for (int w = 0; w < FD_WARPS; ++w) {
        const float c = expf(sm_m[w][g] - M);
        L += sm_l[w][g] * c;
        A += sm_acc[w][g][d] * c;
      }
    }
    const size_t prow = (head0 + g) * n_split + split;
    part_acc[prow * FD_D + d] = A;
    if (d == 0) {
      part_ml[prow * 2] = M;
      part_ml[prow * 2 + 1] = L;
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
void launch_split(dim3 grid, cudaStream_t st, const void* q, const void* k,
                  const void* v, const float* ks, const float* vs,
                  const int* n_valid, const uint8_t* mask, const int* lo,
                  const int* hi, int hi_stride, int prefill_len, int S,
                  int read_ctx, int bs, int blocks_per_split, float scale,
                  float* part_ml, float* part_acc, int* wrapped) {
  fd_split_kernel<G, INT8><<<grid, FD_WARPS * 32, 0, st>>>(
      static_cast<const bf16*>(q), k, v, ks, vs, n_valid, mask, lo, hi,
      hi_stride, prefill_len, S, read_ctx, bs, blocks_per_split, scale,
      part_ml, part_acc, wrapped);
}

}  // namespace

extern "C" {

// q [B, n_kv*G, 128] bf16; k, v [B, n_kv, S, 128] bf16, or int8 with
// k_scale / v_scale [B, n_kv, S] f32. Exactly one of n_valid [B] (prefix)
// and mask [B, S] (bitmask) is given; lo [B] with hi (hi_stride 0 for a
// scalar, 1 for [B]) adds the ring window. part_ml [B*n_heads, n_split, 2]
// and part_acc [B*n_heads, n_split, 128] f32 are scratch; out [B,
// n_heads*128] f32. wrapped, when given, gains one per stream served with
// lo > hi. Two launches; returns the first launch error.
int q3_flash_decode(const void* q, const void* k, const void* v,
                    const float* k_scale, const float* v_scale,
                    const int* n_valid, const uint8_t* mask, const int* lo,
                    const int* hi, int hi_stride, int prefill_len, int B,
                    int n_kv, int G, int S, int read_ctx, int bs,
                    int blocks_per_split, int n_split, float scale, int int8,
                    float* part_ml, float* part_acc, float* out, int* wrapped,
                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(n_split, n_kv, B);
#define FD_ARGS grid, st, q, k, v, k_scale, v_scale, n_valid, mask, lo, hi, \
    hi_stride, prefill_len, S, read_ctx, bs, blocks_per_split, scale,        \
    part_ml, part_acc, wrapped
  if (G == 1 && !int8) launch_split<1, false>(FD_ARGS);
  else if (G == 1) launch_split<1, true>(FD_ARGS);
  else if (G == 2 && !int8) launch_split<2, false>(FD_ARGS);
  else if (G == 2) launch_split<2, true>(FD_ARGS);
  else if (G == 4 && !int8) launch_split<4, false>(FD_ARGS);
  else if (G == 4) launch_split<4, true>(FD_ARGS);
  else return (int)cudaErrorInvalidValue;
#undef FD_ARGS
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fd_combine_kernel<<<B * n_kv * G, FD_D, 0, st>>>(part_ml, part_acc,
                                                     n_split, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
