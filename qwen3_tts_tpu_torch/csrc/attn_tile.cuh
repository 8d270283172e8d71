// Attention tiles shared by the decode-attention kernel (flash_decode.cu)
// and the talker megakernel (talker_fused.cu): cp.async copies of 64-slot
// K/V tiles into shared memory, and warp reductions.
#pragma once

#include "common.cuh"

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// bf16 written earlier in this launch, read through L2 (not L1)
__device__ __forceinline__ float ldcg_bf(const bf16* p) {
  return __uint_as_float(
      (uint32_t)__ldcg(reinterpret_cast<const unsigned short*>(p)) << 16);
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

// 16 bytes global -> shared through L2 (cp.async.cg: never a stale L1 line)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// 4 bytes global -> shared (any 4-byte aligned address)
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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
