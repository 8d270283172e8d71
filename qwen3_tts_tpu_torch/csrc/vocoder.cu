// Vocoder decoder-block kernels: the residual Snake chain and the
// Snake + transposed-conv head, driven from
// qwen3_tts_tpu_torch/ops/vocoder_fused.py.
//
// Replaces: qwen3_tts_tpu/ops/vocoder_fused.py::fused_residual_chain (body
// _kernel) and ::fused_snake_convt (body _convt_kernel).
//
// What bounds them on the H100: arithmetic. Each residual unit is a
// [rows, 7C] x [7C, C] product (dilated conv7 as an implicit im2col) and a
// [rows, C] x [C, C] product; at the 40-frame chunk's shapes one chain is
// ~80 GFLOP per stream and the weights (<= 9.5 MB) stay in L2, so these
// are compute kernels, not HBM kernels.
//
// Residual chain, per unit (d = 1, 3, 9):
//   out = x + conv1(bf16(snake2(conv7_d(s) + b1))) + b2,  s = bf16(snake1(x))
// - Tensor cores: both products are implicit GEMMs on mma.sync.m16n8k16
//   bf16 -> f32 (csrc/mma_ring.cuh). A CTA owns 128 time steps of one
//   stream x BN output columns (BN = 128, or 96 where C is not a multiple
//   of 128: C = 192 and 96, so no weight is padded); 8 warps as 2 (rows)
//   x 4 (columns), each 64 rows x BN/4 columns (4 m16 x BN/32 n8 tiles).
//   A and W tiles of 64 K rows (32 at C = 96) stream through a 3-stage
//   (4-stage) cp.async ring, the other stages in flight while the tensor
//   cores consume one; rows are padded by 16 bytes, which keeps every
//   ldmatrix conflict-free.
//   A fragments by ldmatrix.x4, B fragments by ldmatrix.x2.trans on the
//   [K, C] row-major weights that pack_block makes (w7 as (tap, in, out)).
// - conv7's A rows of tap k are rows t - (6 - k) d of s: plain cp.async
//   copies of shifted rows, zero-filled at negative time (causal) and past
//   T. The 128-row tile reads each W chunk once per 128 time steps.
// - Snake once per element: s = bf16(snake1(x)) is a bf16 [B, T, C]
//   buffer, written for the first unit by a light pre-pass and for each
//   later unit by the previous unit's conv1 epilogue, which holds `out` in
//   f32. conv7's epilogue adds b1, applies snake2 and rounds to bf16: the
//   conv1 operand y2, a bf16 [B, T, C] buffer in global memory (a CTA owns
//   all C columns of its rows only at C = 96; L2 holds y2 between the two
//   launches). conv1's epilogue adds b2 and the residual in f32.
// - One launch per product: 7 launches a chain (pre-pass + 3 x 2). No
//   atomics, sums in a fixed order: two calls on one input are bitwise
//   equal. Values as the twin (snake in f32, rounded to bf16, f32 sums);
//   only the order of the sums differs.
//
// Head: out[b, t, p*C2 + c] = s[t] . Whi[:, p*C2 + c] + s[t+1] . Wlo[:,
// p*C2 + c] + bias[c], s = bf16(snake(x)), s[T] = 0 (the causal trim's zero
// row): one GEMM with K = 2C over the packed [Whi; Wlo] matrix (pack_block),
// N = r * C2 output columns, f32 out. The same tensor-core implicit GEMM as
// the chain, in a mode of its own (kHead):
// - snake once per element: the chain's pre-pass, under a kernel name of
//   the head's own (so that a profile tells the two apart), writes s as a
//   bf16 [B, T, C] scratch;
// - K rows [0, C) read row t of s, rows [C, 2C) row t + 1: the chain's
//   tap-shift loader with 2 taps and shift -tap, zero-filled at a stream's
//   last row;
// - the streams fold into the rows (row b * T + t): block 0's T = 160 would
//   leave a stream's second 128-row tile three quarters empty, folded the
//   B * T rows fill ceil(B * T / 128) tiles;
// - column tiles of 128, or 96 where N is not a multiple of 128 (N = 288),
//   K stages of 64 (C is a multiple of 64 in every block);
// - the epilogue adds the bias and stores f32 pairs.
// Two launches a call (pre-pass + product), no atomics, sums in a fixed
// order: two calls on one input are bitwise equal. Bytes bound it at the
// main path's shapes (it reads x and writes r / 2 times as many f32
// values), but as built the tensor cores' 2C-deep product sets its time.
//
// Snake's sin^2: every kernel that applies snake (the pre-passes, conv7's
// and conv1's epilogues) takes a template flag EXACT, set by the C entry
// points' `exact` argument: false is fast_sin2 (the default, the code as it
// was before the flag), true the accurate sinf, as the TPU kernels honour
// the JAX package's set_snake_sin2_impl.
#include <algorithm>

#include "mma_ring.cuh"

namespace {

// ---- tensor-core implicit GEMMs: the chain's two products and the head ----
constexpr int RM = 128;              // output rows (time steps) a CTA
constexpr int RTHREADS = 256;

// BN output columns; RK_ K rows a ring stage (64 where C allows, so that
// each pair of CTA barriers frames 4 k16 steps; 32 at C = 96); RST stages
// (2 CTAs a SM either way)
template <int BN, int RK_>
struct Tile {
  static constexpr int RK = RK_;
  static constexpr int RST = RK == 64 ? 3 : 4;
  static constexpr int A_ROW = RK * 2 + 16;      // bytes of a padded A row
  static constexpr int A_STAGE = RM * A_ROW;
  static constexpr int W_ROW = BN * 2 + 16;      // bytes of a padded W row
  static constexpr int STAGE = A_STAGE + RK * W_ROW;
  static constexpr int SMEM = RST * STAGE;
  static constexpr int NT8 = BN / 32;            // n8 tiles a warp
  static constexpr int A_ITEMS = RM * (RK / 8) / RTHREADS;  // A copies a
                                                            // thread a stage
};

// conv7 (K = 7C, epilogue y2 = bf16(snake2(. + b1))), conv1 (K = C,
// epilogue x + . + b2 and the next unit's s) or the head (K = 2C over rows
// t and t + 1, epilogue . + bias)
enum GemmMode { kConv7, kConv1, kHead };

struct ResArgs {
  const bf16* a;        // A rows [B, T, C] bf16: s (conv7, head) or y2 (conv1)
  const bf16* w;        // [K, N] bf16: w7 as [7C, C], w1, or [Whi; Wlo]
  const float* bias;    // [N]: b1, b2 or the head's bias
  const float* sa;      // snake constants of the epilogue: a2 / ib2
  const float* sib;     //   (conv7), the next unit's a1 / ib1 (conv1)
  bf16* y2;             // conv7: bf16(snake2(acc + b1)) [B, T, C]
  const float* x;       // conv1: the unit's input [B, T, C] f32
  float* out;           // conv1: x + acc + b2; head: acc + bias [B, T, N]
  bf16* s_out;          // conv1: bf16(snake(out)) for the next unit, or null
  int T, C, N, d;       // the chain: N = C; the head: T = every stream's
  int t_stream;         //   rows (B * t_stream), one grid slice
};

// One product over a 128-row x BN-column tile of stream blockIdx.z: conv7
// (tap k reads rows t - (6 - k) d), conv1, or the head (tap k reads rows
// t + k, zero after each stream's last row)
template <int BN, int RK_, int MODE, bool EXACT>
__device__ __forceinline__ void gemm_tile(const ResArgs& p) {
  extern __shared__ __align__(16) char smem[];
  using TL = Tile<BN, RK_>;
  constexpr int RK = TL::RK, RST = TL::RST, A_ROW = TL::A_ROW;
  constexpr int A_STAGE = TL::A_STAGE, A_ITEMS = TL::A_ITEMS;
  constexpr int TAPS = MODE == kConv7 ? 7 : (MODE == kHead ? 2 : 1);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 1, wn = warp >> 1;
  const int n0 = blockIdx.x * BN, t0 = blockIdx.y * RM, b = blockIdx.z;
  const int C = p.C, T = p.T, N = p.N, per_tap = C / RK;
  const int n_chunks = TAPS * per_tap;
  const bf16* ab = p.a + (size_t)b * T * C;
  // the head: bit j set where this thread's j-th A row ends a stream (its
  // tap-1 row is the zero row)
  uint32_t last_row = 0;
  if constexpr (MODE == kHead) {
#pragma unroll
    for (int j = 0; j < A_ITEMS; ++j) {
      const int r = (tid + j * RTHREADS) / (RK / 8);
      last_row |= (uint32_t)((t0 + r + 1) % p.t_stream == 0) << j;
    }
  }

  // chunk c -> stage c % RST: its A rows (tap shift, zero outside
  // [0, T)), then its W rows
  const auto issue = [&](int c) {
    if (c < n_chunks) {
      char* sa = smem + (c % RST) * TL::STAGE;
      char* sw = sa + A_STAGE;
      const int tap = c / per_tap, c0 = (c % per_tap) * RK;
      if constexpr (MODE == kHead) {
#pragma unroll
        for (int j = 0; j < A_ITEMS; ++j) {
          const int i = tid + j * RTHREADS;
          const int r = i / (RK / 8), ch = i % (RK / 8);
          char* dst = sa + r * A_ROW + ch * 16;
          if (t0 + r < T && !(tap && (last_row >> j & 1)))
            cp_async16(dst, ab + (size_t)(t0 + r + tap) * C + c0 + ch * 8);
          else
            *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
        }
      } else {
        const int shift = MODE == kConv7 ? (6 - tap) * p.d : 0;
        for (int i = tid; i < RM * (RK / 8); i += RTHREADS) {
          const int r = i / (RK / 8), ch = i % (RK / 8);
          const int src = t0 + r - shift;
          char* dst = sa + r * A_ROW + ch * 16;
          if (src >= 0 && src < T)
            cp_async16(dst, ab + (size_t)src * C + c0 + ch * 8);
          else
            *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
        }
      }
      const bf16* wk = p.w + (size_t)(tap * C + c0) * N + n0;
      for (int i = tid; i < RK * (BN / 8); i += RTHREADS) {
        const int r = i / (BN / 8), ch = i % (BN / 8);
        cp_async16(sw + r * TL::W_ROW + ch * 16, wk + (size_t)r * N + ch * 8);
      }
    }
    cp_async_commit();                  // empty past the end: counts stay
  };

  float acc[4][TL::NT8][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int j = 0; j < TL::NT8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
#pragma unroll
  for (int s = 0; s < RST - 1; ++s) issue(s);
  for (int c = 0; c < n_chunks; ++c) {
    issue(c + RST - 1);
    cp_async_wait<RST - 1>();
    __syncthreads();
    const char* sa = smem + (c % RST) * TL::STAGE;
    const char* sw = sa + A_STAGE;
#pragma unroll
    for (int kk = 0; kk < RK / 16; ++kk) {
      uint32_t bfr[TL::NT8][2];
#pragma unroll
      for (int j = 0; j < TL::NT8; ++j)
        ldsm_x2_trans(bfr[j], sw + (kk * 16 + (lane & 15)) * TL::W_ROW +
                                  (wn * (BN / 4) + j * 8) * 2);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t afr[4];
        ldsm_x4(afr, sa + (wm * 64 + mt * 16 + (lane & 15)) * A_ROW +
                         (kk * 2 + (lane >> 4)) * 16);
#pragma unroll
        for (int j = 0; j < TL::NT8; ++j) mma_bf16(acc[mt][j], afr, bfr[j]);
      }
    }
    __syncthreads();                    // the stage may be refilled
  }

  const int r0 = lane >> 2, cq = (lane & 3) * 2;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int j = 0; j < TL::NT8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int t = t0 + wm * 64 + mt * 16 + r0 + hf * 8;
        const int col = n0 + wn * (BN / 4) + j * 8 + cq;
        if (t >= T) continue;
        const size_t o = ((size_t)b * T + t) * N + col;
        const float v0 = acc[mt][j][2 * hf] + p.bias[col];
        const float v1 = acc[mt][j][2 * hf + 1] + p.bias[col + 1];
        if constexpr (MODE == kHead) {
          *reinterpret_cast<float2*>(p.out + o) = make_float2(v0, v1);
        } else if constexpr (MODE == kConv7) {
          *reinterpret_cast<__nv_bfloat162*>(p.y2 + o) =
              __floats2bfloat162_rn(
                  snake<EXACT>(v0, p.sa[col], p.sib[col]),
                  snake<EXACT>(v1, p.sa[col + 1], p.sib[col + 1]));
        } else {
          const float2 xv = *reinterpret_cast<const float2*>(p.x + o);
          const float o0 = xv.x + v0, o1 = xv.y + v1;
          *reinterpret_cast<float2*>(p.out + o) = make_float2(o0, o1);
          if (p.s_out)
            *reinterpret_cast<__nv_bfloat162*>(p.s_out + o) =
                __floats2bfloat162_rn(
                    snake<EXACT>(o0, p.sa[col], p.sib[col]),
                    snake<EXACT>(o1, p.sa[col + 1], p.sib[col + 1]));
        }
      }
}

// The chain's products and the head's under names of their own, so that
// a profile tells them apart
template <int BN, int RK, bool CONV7, bool EXACT>
__global__ void __launch_bounds__(RTHREADS, 2) res_gemm_kernel(ResArgs p) {
  gemm_tile<BN, RK, CONV7 ? kConv7 : kConv1, EXACT>(p);
}

template <int BN>
__global__ void __launch_bounds__(RTHREADS, 2)
snake_convt_gemm_kernel(ResArgs p) {
  gemm_tile<BN, 64, kHead, false>(p);   // no snake in the head's epilogue
}

// s = bf16(snake(x)) over [rows, C], 4 values a thread
template <bool EXACT>
__device__ __forceinline__ void snake_rows(const float4* __restrict__ x,
                                           uint2* __restrict__ s, size_t n4,
                                           int C, const float* __restrict__ a,
                                           const float* __restrict__ ib) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const float4 v = x[i];
    const int c = (int)(i * 4 % C);
    const __nv_bfloat162 lo = __floats2bfloat162_rn(
        snake<EXACT>(v.x, a[c], ib[c]), snake<EXACT>(v.y, a[c + 1], ib[c + 1]));
    const __nv_bfloat162 hi = __floats2bfloat162_rn(
        snake<EXACT>(v.z, a[c + 2], ib[c + 2]),
        snake<EXACT>(v.w, a[c + 3], ib[c + 3]));
    s[i] = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                      *reinterpret_cast<const uint32_t*>(&hi));
  }
}

template <bool EXACT>
__global__ void snake_bf16_kernel(const float4* __restrict__ x,
                                  uint2* __restrict__ s, size_t n4, int C,
                                  const float* __restrict__ a,
                                  const float* __restrict__ ib) {
  snake_rows<EXACT>(x, s, n4, C, a, ib);
}

template <bool EXACT>
__global__ void snake_convt_snake_kernel(const float4* __restrict__ x,
                                         uint2* __restrict__ s, size_t n4,
                                         int C, const float* __restrict__ a,
                                         const float* __restrict__ ib) {
  snake_rows<EXACT>(x, s, n4, C, a, ib);
}

using SnakeKernel = void (*)(const float4*, uint2*, size_t, int, const float*,
                             const float*);

cudaError_t launch_snake(SnakeKernel kern, const float* x, void* s,
                         size_t n, int C, const float* a, const float* ib,
                         cudaStream_t st) {
  const size_t n4 = n / 4;
  const int blocks = (int)std::min<size_t>((n4 + 255) / 256, 4096);
  kern<<<blocks, 256, 0, st>>>(reinterpret_cast<const float4*>(x),
                               static_cast<uint2*>(s), n4, C, a, ib);
  return cudaGetLastError();
}

template <int BN, int RK, int MODE, bool EXACT = false>
cudaError_t launch_gemm(const ResArgs& p, int B, cudaStream_t st) {
  const int smem = Tile<BN, RK>::SMEM;
  void (*kern)(ResArgs);
  if constexpr (MODE == kHead) {
    static_assert(RK == 64, "the head takes 64-row K stages");
    kern = snake_convt_gemm_kernel<BN>;
  } else {
    kern = res_gemm_kernel<BN, RK, MODE == kConv7, EXACT>;
  }
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(p.N / BN, (p.T + RM - 1) / RM, B), RTHREADS, smem, st>>>(p);
  return cudaGetLastError();
}

// the column tile for n output columns: 128, else 96 (n = 96, 192, 288);
// 0 where neither fits
int tile_n(int n) { return n % 128 == 0 ? 128 : (n % 96 == 0 ? 96 : 0); }

template <int MODE, bool EXACT>
int launch_res_tiles(const ResArgs& p, int B, cudaStream_t st) {
  const bool deep = p.C % 64 == 0;
  switch (tile_n(p.C)) {
    case 128: return (int)launch_gemm<128, 64, MODE, EXACT>(p, B, st);
    case 96:
      return (int)(deep ? launch_gemm<96, 64, MODE, EXACT>(p, B, st)
                        : launch_gemm<96, 32, MODE, EXACT>(p, B, st));
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int MODE>
int launch_res_any(const ResArgs& p, int B, int exact, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  return exact ? launch_res_tiles<MODE, true>(p, B, st)
               : launch_res_tiles<MODE, false>(p, B, st);
}

}  // namespace

extern "C" {

// Every entry point's `exact` (0 or 1) picks snake's sin^2: fast_sin2 or
// the accurate sinf.

// s = bf16(snake(x; a, ib)), x [B, T, C] f32 -> s bf16
int q3_snake_bf16(const float* x, void* s, int B, int T, int C,
                  const float* a, const float* ib, int exact, void* stream) {
  return (int)launch_snake(
      exact ? snake_bf16_kernel<true> : snake_bf16_kernel<false>, x, s,
      (size_t)B * T * C, C, a, ib, (cudaStream_t)stream);
}

// y2 = bf16(snake(conv7_d(s) + b1; a2, ib2)); s, y2 [B, T, C] bf16,
// w7 [7, C, C] bf16 (tap, in, out)
int q3_res_conv7(const void* s, void* y2, int B, int T, int C, int d,
                 const void* w7, const float* b1, const float* a2,
                 const float* ib2, int exact, void* stream) {
  ResArgs p{};
  p.a = static_cast<const bf16*>(s);
  p.w = static_cast<const bf16*>(w7);
  p.bias = b1;
  p.sa = a2;
  p.sib = ib2;
  p.y2 = static_cast<bf16*>(y2);
  p.T = T;
  p.C = p.N = C;
  p.d = d;
  return launch_res_any<kConv7>(p, B, exact, stream);
}

// out = x + (y2 @ w1 + b2); s_out, when given, = bf16(snake(out; a, ib))
int q3_res_conv1(const void* y2, const float* x, float* out, void* s_out,
                 int B, int T, int C, const void* w1, const float* b2,
                 const float* a, const float* ib, int exact, void* stream) {
  ResArgs p{};
  p.a = static_cast<const bf16*>(y2);
  p.w = static_cast<const bf16*>(w1);
  p.bias = b2;
  p.sa = a;
  p.sib = ib;
  p.x = x;
  p.out = out;
  p.s_out = static_cast<bf16*>(s_out);
  p.T = T;
  p.C = p.N = C;
  return launch_res_any<kConv1>(p, B, exact, stream);
}

// The Snake + convT head: s = bf16(snake(x; a, ib)) into the scratch s
// [B, T, C] bf16, then out [B, T, N] f32 = [s[t] | s[t + 1]] @ W + bias
// per stream, s[T] = 0; W [2C, N] bf16 = [Whi; Wlo]. C a multiple of 64,
// N of 128 or 96. Two launches; returns the first launch error.
int q3_snake_convt(const float* x, void* s, float* out, int B, int T, int C,
                   int N, const void* W, const float* bias, const float* a,
                   const float* ib, int exact, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (C % 64 != 0 || tile_n(N) == 0) return (int)cudaErrorInvalidValue;
  const SnakeKernel pre = exact ? snake_convt_snake_kernel<true>
                                : snake_convt_snake_kernel<false>;
  const cudaError_t e = launch_snake(pre, x, s,
                                     (size_t)B * T * C, C, a, ib, st);
  if (e != cudaSuccess) return (int)e;
  ResArgs p{};
  p.a = static_cast<const bf16*>(s);
  p.w = static_cast<const bf16*>(W);
  p.bias = bias;
  p.out = out;
  p.T = B * T;
  p.t_stream = T;
  p.C = C;
  p.N = N;
  return (int)(tile_n(N) == 128 ? launch_gemm<128, 64, kHead>(p, 1, st)
                                : launch_gemm<96, 64, kHead>(p, 1, st));
}

}  // extern "C"
