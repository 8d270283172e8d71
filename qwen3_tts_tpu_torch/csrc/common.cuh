// Shared helpers for the port's Hopper kernels: bf16 <-> f32, the
// vocoder's snake activation (the JAX package's fast_sin2 polynomial or the
// accurate sine), and block-wide reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16_rn(v); }
// round an f32 to the nearest bf16 and back (the JAX `.astype(bf16)`)
__device__ __forceinline__ float round_bf(float v) { return bf2f(f2bf(v)); }

// Unpack 8 bf16 held in a 16-byte word.
__device__ __forceinline__ void unpack8(uint4 raw, float* w) {
  const uint32_t u[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[2 * i] = __uint_as_float(u[i] << 16);
    w[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// sin^2(z): qwen3_tts_tpu/ops/layers.py::fast_sin2, constant for constant
// (pi-periodic Cody-Waite reduction, odd polynomial, clamp to |z| <= 3e4,
// round half to even).
__device__ __forceinline__ float fast_sin2(float z) {
  const float pi_hi = 3.140625f;
  const float pi_lo = 0.0009676535897932f;
  const float inv_pi = (float)(1.0 / 3.14159265358979);
  z = fminf(fmaxf(z, -3e4f), 3e4f);
  const float n = rintf(z * inv_pi);
  const float r = z - n * pi_hi - n * pi_lo;
  const float r2 = r * r;
  const float s = r * (1.0f + r2 * (-0.16666662f + r2 * (0.0083331258f
                  + r2 * (-0.00019814119f + r2 * 2.6160287e-06f))));
  return s * s;
}

// x + exp(-beta) * sin^2(exp(alpha) * x) with a = exp(alpha), ib = exp(-beta);
// sin^2 is fast_sin2, or with EXACT the accurate sinf squared (the JAX
// package's set_snake_sin2_impl("exact"); built without fast math)
template <bool EXACT = false>
__device__ __forceinline__ float snake(float x, float a, float ib) {
  if constexpr (EXACT) {
    const float s = sinf(x * a);
    return x + ib * (s * s);
  } else {
    return x + ib * fast_sin2(x * a);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over a block of NW warps; every thread gets the result. `red` holds
// NW floats of shared memory. Contains __syncthreads.
template <int NW>
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NW; ++i) s += red[i];
  return s;
}
