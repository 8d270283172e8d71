// Attention tiles shared by the decode-attention kernel (flash_decode.cu)
// and the talker megakernel (talker_fused.cu): cp.async copies of 64-slot
// K/V tiles into shared memory, and warp reductions.
#pragma once

#include "mma_ring.cuh"

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum of v over the 4 warps of this thread's half of a 256-thread CTA
// (threads 0-127 or 128-255); max when MAX. `red` holds 8 floats of
// shared memory. Contains __syncthreads.
template <bool MAX>
__device__ __forceinline__ float half_reduce(float v, float* red) {
  v = MAX ? warp_max(v) : warp_sum(v);
  const int warp = threadIdx.x >> 5, h4 = (threadIdx.x >> 7) * 4;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  return MAX ? fmaxf(fmaxf(red[h4], red[h4 + 1]),
                     fmaxf(red[h4 + 2], red[h4 + 3]))
             : red[h4] + red[h4 + 1] + red[h4 + 2] + red[h4 + 3];
}

constexpr int ATTN_TILE_ROWS = 64;  // cache slots per attention tile

// Issue the copies of rows [s0, s0 + 64) of K and V (RB bytes a row, rows
// contiguous from kb / vb) into kdst / vdst; a row for which ok(s) is
// false is zero-filled and never read. Does not commit.
template <int RB, int THREADS, typename Ok>
__device__ __forceinline__ void copy_kv_tile(char* kdst, char* vdst,
                                             const char* kb, const char* vb,
                                             int s0, Ok ok) {
  constexpr int CPR = RB / 16;                      // 16-byte chunks a row
  for (int c = threadIdx.x; c < ATTN_TILE_ROWS * CPR; c += THREADS) {
    const int r = c / CPR, ch = c % CPR, s = s0 + r;
    char* kd = kdst + r * RB + ch * 16;
    char* vd = vdst + r * RB + ch * 16;
    if (ok(s)) {
      cp_async16(kd, kb + (size_t)s * RB + ch * 16);
      cp_async16(vd, vb + (size_t)s * RB + ch * 16);
    } else {
      *reinterpret_cast<uint4*>(kd) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(vd) = make_uint4(0, 0, 0, 0);
    }
  }
}
