// Single-token absorbed decode attention of multi-head latent attention
// (LongCat-Flash's MLA, DeepSeek-V3's) over the latent cache: ops/mla.py
// has the semantics and the torch twin. It replaces no TPU kernel: the
// JAX package has no latent-attention talker.
//
// Shapes served: 64 query heads, each a 576-wide latent query [q_nope
// W_uk | q_rot] (bf16), over cache rows [c (512) | k_rot (64)] (bf16)
// that are the keys of every head and whose first 512 values are the
// values: out [B, 64, 512] bf16.
//
// What bounds it: bytes, barely. A stream's rows are read once for all 64
// heads, so at B = 192 and ~139 positions a call reads ~31 MB of rows and
// 14 MB of queries and writes 13 MB, ~17 us at 3.35 TB/s, for ~3.7 GFLOP
// (~4 us on the tensor cores): the heads sharing one latent make it ~64x
// denser in operations than a per-head cache, so the design uses the
// tensor cores and spends its care on reading each row once:
// - one CTA of 8 warps a (stream, split of its 32-slot tiles); one CTA a
//   SM (its 64 x 576 query block, 72 KB, stays in shared memory, beside
//   two 36 KB stages of rows). A batch of at least one stream a SM takes
//   one split a stream and writes the normalised output itself; a smaller
//   one splits each stream's tiles (two or more a split) and a second
//   kernel merges the splits' (m, l, acc);
// - the rows of a tile are copied with cp.async, 16 bytes a thread, one
//   tile ahead; rows that do not count (past n_valid or read_ctx, or with
//   their mask bit clear) are zero-filled, not read;
// - scores S [64 heads x 32 slots] = Q K^T by mma.sync m16n8k16 (warp w:
//   heads 16 (w & 3).., slots 16 (w >> 2)..; K rows are the B operand as
//   they lie, ldmatrix without transpose), scaled, in f32 to shared
//   memory; an online softmax update a head (4 threads a head), the
//   probabilities rounded to bf16 for the second product and summed in
//   f32; O [64 x 512] += P V (warp w: heads 16 (w & 3).., values 256
//   (w >> 2)..; 128 f32 accumulators a thread), rescaled by the head's
//   alpha first.
// A stream with no counted slot gives 0.

#include <math_constants.h>

#include "attn_tile.cuh"

namespace {

constexpr int MH = 64;                 // query heads
constexpr int ML = 512;                // latent (value) width
constexpr int MW = 576;                // row width: latent + rope key
constexpr int RB = MW * 2;             // bytes a row
constexpr int CPR = RB / 16;           // 16-byte chunks a row
constexpr int TS = 32;                 // slots a tile
constexpr int THREADS = 256;
constexpr int Q_BYTES = MH * RB;       // 73,728
constexpr int K_BYTES = TS * RB;       // 36,864
constexpr int P_RB = 128;              // bytes a probability row (64 used)
constexpr int S_LD = TS + 4;           // floats a score row
constexpr int SMEM = Q_BYTES + 2 * K_BYTES + MH * P_RB + MH * S_LD * 4 +
                     3 * MH * 4;

// grid (n_split, B), 256 threads, SMEM bytes of dynamic shared memory
__global__ void __launch_bounds__(THREADS, 1)
mla_decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ rows,
                  const int* __restrict__ n_valid,
                  const bool* __restrict__ mask, int S, int ctx,
                  int per_split, int n_split, float scale,
                  float* __restrict__ part_ml, float* __restrict__ part_o,
                  bf16* __restrict__ out) {
  extern __shared__ __align__(128) char smem[];
  char* qs = smem;
  char* kst = smem + Q_BYTES;
  char* ps = kst + 2 * K_BYTES;
  float* ss = reinterpret_cast<float*>(ps + MH * P_RB);
  float* m_s = ss + MH * S_LD;
  float* l_s = m_s + MH;
  float* a_s = l_s + MH;
  const int split = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int lim = n_valid ? min(n_valid[b], ctx) : ctx;
  const int n_tiles = (max(lim, 0) + TS - 1) / TS;
  const int t0 = split * per_split;
  const int t1 = min(n_tiles, t0 + per_split);
  const char* rb = reinterpret_cast<const char*>(rows + (size_t)b * S * MW);
  const bool* mb = mask ? mask + (size_t)b * S : nullptr;
  const auto counted = [&](int s) {
    return s < lim && (mb == nullptr || mb[s]);
  };

  const char* qg = reinterpret_cast<const char*>(q + (size_t)b * MH * MW);
  for (int c = tid; c < MH * CPR; c += THREADS) {
    const int r = c / CPR, ch = c % CPR;
    cp_async16(qs + swz_row(r, ch, RB), qg + (size_t)r * RB + ch * 16);
  }
  const auto issue = [&](int t) {
    if (t < t1) {
      char* dst = kst + ((t - t0) & 1) * K_BYTES;
      for (int c = tid; c < TS * CPR; c += THREADS) {
        const int r = c / CPR, ch = c % CPR, s = t * TS + r;
        char* d = dst + swz_row(r, ch, RB);
        if (counted(s))
          cp_async16(d, rb + (size_t)s * RB + ch * 16);
        else
          *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
      }
    }
    cp_async_commit();
  };
  if (tid < MH) {
    m_s[tid] = -CUDART_INF_F;
    l_s[tid] = 0.f;
  }
  issue(t0);                            // one group: Q and the first tile

  float acc[32][4];
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  const int mt = warp & 3, g = lane >> 2, tg = lane & 3;

  for (int t = t0; t < t1; ++t) {
    issue(t + 1);
    cp_async_wait<1>();
    __syncthreads();
    const char* kt = kst + ((t - t0) & 1) * K_BYTES;
    {  // scores of heads 16 mt.., slots nb..nb + 15
      const int nb = (warp >> 2) * 16;
      float sacc[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) sacc[j][i] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < MW / 16; ++kk) {
        uint32_t a[4], bk[4];
        ldsm_x4(a, qs + swz_row(mt * 16 + (lane & 15), kk * 2 + (lane >> 4),
                                RB));
        ldsm_x4(bk, kt + swz_row(nb + ((lane >> 4) << 3) + (lane & 7),
                                 kk * 2 + ((lane >> 3) & 1), RB));
        mma_bf16(sacc[0], a, bk);
        mma_bf16(sacc[1], a, bk + 2);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = nb + j * 8 + tg * 2;
        float* r0 = ss + (mt * 16 + g) * S_LD + col;
        float* r1 = r0 + 8 * S_LD;
        r0[0] = sacc[j][0] * scale;
        r0[1] = sacc[j][1] * scale;
        r1[0] = sacc[j][2] * scale;
        r1[1] = sacc[j][3] * scale;
      }
    }
    __syncthreads();
    {  // online softmax: head r, slots 8 qd..8 qd + 7 of the tile
      const int r = tid >> 2, qd = tid & 3;
      float v[8];
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = qd * 8 + i;
        v[i] = counted(t * TS + c) ? ss[r * S_LD + c] : -CUDART_INF_F;
        mx = fmaxf(mx, v[i]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const bool none = m_new == -CUDART_INF_F;
      float sum = 0.f;
      uint32_t pk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p0 = none ? 0.f : expf(v[2 * i] - m_new);
        const float p1 = none ? 0.f : expf(v[2 * i + 1] - m_new);
        sum += p0 + p1;
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(p0, p1);
        pk[i] = *reinterpret_cast<const uint32_t*>(&h2);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      *reinterpret_cast<uint4*>(ps + swz_row(r, qd, P_RB)) =
          make_uint4(pk[0], pk[1], pk[2], pk[3]);
      __syncwarp();
      if (qd == 0) {
        const float alpha = none ? 1.f : expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    {  // O[16 mt.., 256 (warp >> 2)..] = alpha O + P V
      const int cb = (warp >> 2) * 256;
      const float al0 = a_s[mt * 16 + g], al1 = a_s[mt * 16 + g + 8];
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        acc[j][0] *= al0;
        acc[j][1] *= al0;
        acc[j][2] *= al1;
        acc[j][3] *= al1;
      }
#pragma unroll
      for (int kk = 0; kk < TS / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, ps + swz_row(mt * 16 + (lane & 15), kk * 2 + (lane >> 4),
                                P_RB));
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          uint32_t bv[2];
          ldsm_x2_trans(bv, kt + swz_row(kk * 16 + (lane & 15),
                                         (cb >> 3) + j, RB));
          mma_bf16(acc[j], a, bv);
        }
      }
    }
    __syncthreads();                    // the stage may be refilled
  }
  cp_async_wait<0>();
  __syncthreads();

  const int cb = (warp >> 2) * 256;
  const int r0 = mt * 16 + g, r1 = r0 + 8;
  if (n_split == 1) {
    const float l0 = l_s[r0], l1 = l_s[r1];
    const float i0 = l0 > 0.f ? 1.f / l0 : 0.f;
    const float i1 = l1 > 0.f ? 1.f / l1 : 0.f;
    bf16* ob = out + (size_t)b * MH * ML;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = cb + j * 8 + tg * 2;
      *reinterpret_cast<__nv_bfloat162*>(ob + r0 * ML + col) =
          __floats2bfloat162_rn(acc[j][0] * i0, acc[j][1] * i0);
      *reinterpret_cast<__nv_bfloat162*>(ob + r1 * ML + col) =
          __floats2bfloat162_rn(acc[j][2] * i1, acc[j][3] * i1);
    }
  } else {
    const size_t at = (size_t)b * n_split + split;
    float* po = part_o + at * MH * ML;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = cb + j * 8 + tg * 2;
      __stcg(reinterpret_cast<float2*>(po + r0 * ML + col),
             make_float2(acc[j][0], acc[j][1]));
      __stcg(reinterpret_cast<float2*>(po + r1 * ML + col),
             make_float2(acc[j][2], acc[j][3]));
    }
    if (tid < MH) {
      part_ml[(at * MH + tid) * 2] = m_s[tid];
      part_ml[(at * MH + tid) * 2 + 1] = l_s[tid];
    }
  }
}

// grid (MH, B), 128 threads: out = sum_s e^(m_s - M) acc_s / sum_s
// e^(m_s - M) l_s over the splits, in split order
__global__ void __launch_bounds__(128)
mla_combine_kernel(const float* __restrict__ part_ml,
                   const float* __restrict__ part_o, bf16* __restrict__ out,
                   int n_split) {
  const int h = blockIdx.x, b = blockIdx.y, c = threadIdx.x * 4;
  float M = -CUDART_INF_F;
  for (int s = 0; s < n_split; ++s)
    M = fmaxf(M, part_ml[(((size_t)b * n_split + s) * MH + h) * 2]);
  float L = 0.f;
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  if (M != -CUDART_INF_F) {
    for (int s = 0; s < n_split; ++s) {
      const size_t at = ((size_t)b * n_split + s) * MH + h;
      const float m = part_ml[at * 2];
      if (m == -CUDART_INF_F) continue;
      const float f = expf(m - M);
      L += part_ml[at * 2 + 1] * f;
      const float4 p =
          __ldcg(reinterpret_cast<const float4*>(part_o + at * ML + c));
      o.x = fmaf(f, p.x, o.x);
      o.y = fmaf(f, p.y, o.y);
      o.z = fmaf(f, p.z, o.z);
      o.w = fmaf(f, p.w, o.w);
    }
  }
  const float inv = L > 0.f ? 1.f / L : 0.f;
  bf16* ob = out + ((size_t)b * MH + h) * ML + c;
  *reinterpret_cast<__nv_bfloat162*>(ob) =
      __floats2bfloat162_rn(o.x * inv, o.y * inv);
  *reinterpret_cast<__nv_bfloat162*>(ob + 2) =
      __floats2bfloat162_rn(o.z * inv, o.w * inv);
}

}  // namespace

extern "C" {

// q [B, 64, 576] bf16; rows [B, S, 576] bf16 (one sublayer's view of the
// latent cache); n_valid [B] int (prefix mode) or mask [B, S] bool (ring
// mode), one of them; slots at or past ctx are never read. part_ml [B,
// n_split, 64, 2] and part_o [B, n_split, 64, 512] f32 when n_split > 1
// (else unused). out [B, 64, 512] bf16. One launch, two when split;
// returns the first launch error.
int q3_mla_decode(const bf16* q, const bf16* rows, const int* n_valid,
                  const bool* mask, float* part_ml, float* part_o, bf16* out,
                  int B, int S, int ctx, int per_split, int n_split,
                  float scale, void* stream) {
  if (B < 1 || S < 1 || ctx < 1 || ctx > S || per_split < 1 ||
      n_split < 1 || (n_valid == nullptr) == (mask == nullptr) ||
      (n_split > 1 && (part_ml == nullptr || part_o == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  static bool sized = false;             // the > 48 KB opt-in, once
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        mla_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  mla_decode_kernel<<<dim3(n_split, B), THREADS, SMEM, st>>>(
      q, rows, n_valid, mask, S, ctx, per_split, n_split, scale, part_ml,
      part_o, out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return (int)err;
  mla_combine_kernel<<<dim3(MH, B), 128, 0, st>>>(part_ml, part_o, out,
                                                  n_split);
  return (int)cudaGetLastError();
}

}  // extern "C"
