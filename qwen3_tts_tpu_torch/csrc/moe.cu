// The sparse mixture-of-experts FFN of Qwen3-Omni's talker: router,
// grouped experts and gated shared expert (ops/moe.py has the semantics
// and the torch twin). It replaces no TPU kernel: the JAX package has no
// MoE talker.
//
// What bounds it: the experts' bytes. At B = 192 decode rows, top-6 of
// 128 experts, the 1,152 (token, expert) pairs touch nearly every expert
// with ~9 rows each: a layer streams ~302 MB of expert weights for ~3.7
// GFLOP, ~25x under the tensor cores' rate. So the design reads each
// expert's weights once, for all the rows routed to it, and keeps enough
// bytes in flight to cover HBM latency:
// - moe_route_kernel: CTAs of 4 tokens; a thread owns 8 expert columns of
//   the router over every 16th row of H (16-byte loads: each router weight
//   read once a CTA, a warp's loads two whole rows), then a warp a token
//   does softmax, top-k, the weights and (other warps) the shared gate.
//   The last CTA to finish, by an atomic ticket, counts the pairs per
//   expert in shared memory, scans them (a thread an expert), places every
//   pair in `order` by expert and writes the work list: chunks of 64 rows
//   of one expert (the shared expert's rows are the tokens, in order). The
//   list's length stays on the card: the next kernels' grids have a fixed
//   size and a CTA past the list returns, so a CUDA graph holds the op.
// - moe_gemm_kernel<GATED>: one CTA of 4 warps a (chunk, column block).
//   The chunk's rows are gathered once into a 64-row A tile a K stage; the
//   weights stream through a 3-stage cp.async ring of [64 K][128 N] bf16
//   tiles (swizzled 16-byte chunks, ldmatrix.trans reads them as the mma's
//   B operand, nothing packed); mma.sync m16n8k16 for the chunk's m16
//   tiles only. GATED: the 128 columns are 64 of gate and the same 64 of
//   up, a warp holding matching gate and up fragments, so silu(g) * u is
//   formed in registers and stored as bf16 `act`. Down: 128 output columns
//   over the expert's width, f32 into `out` at the pair's row.
// - moe_combine_kernel: y_t = sum_j w_tj out_tj (in j order) + s_t out_ts.
//   No atomics on values: a replay is bitwise the eager call (the order of
//   pairs inside an expert's rows may differ, which changes no value).
//
// The expert-parallel path (LongCat-Flash's block, no shared expert; the
// entry q3_moe_ffn_ep) keeps the two grouped products as they are, with
// its own router and combine around them:
// - the router logits [N, E + Z] come from cuBLAS (ops/moe.py): at 768
//   outputs over a hidden of 6,144 the router is a 9.4 MB product that
//   the per-warp partial sums of moe_route_kernel (a [8][4][128] block
//   of shared memory) cannot hold;
// - moe_route_ep_kernel: a warp a token holds its row of logits (32 a
//   lane, up to 1,024), softmax, the top-k of p + bias (ties: lower id)
//   carrying p along, the weights p (renormalised if asked) times the
//   scaling. The last CTA classifies every pair (an identity expert, a
//   held expert, one held elsewhere), counts, and lists only the held
//   experts' pairs and chunks, by local index: the products read only the
//   held experts' weights;
// - moe_combine_ep_kernel: y_t = sum_j in order of w_tj o_tj, o the held
//   expert's row of out, bf16(h_t) for an identity expert, a pair held
//   elsewhere skipped. No atomics on values, as above.

#include <math_constants.h>

#include "attn_tile.cuh"

namespace {

constexpr int RT_TOKENS = 4;      // tokens a router CTA
constexpr int RT_THREADS = 256;
constexpr int RT_MAX_E = 128;     // experts (4 a lane in top-k)
constexpr int MAX_K = 8;
constexpr int CH_ROWS = 64;       // rows a work chunk (4 m16 tiles)
constexpr int M_TILE = 16;
constexpr int G_THREADS = 128;    // 4 warps
constexpr int G_KT = 64;          // K rows a stage
constexpr int G_NT = 128;         // weight columns a stage
constexpr int G_STAGES = 3;
constexpr int A_BYTES = CH_ROWS * G_KT * 2;   // 8 KB
constexpr int B_BYTES = G_KT * G_NT * 2;      // 16 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int G_SMEM = G_STAGES * STAGE_BYTES;

// 16 bytes global -> shared; zero-filled (src not read) when !valid
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n)
               : "memory");
}

// grid ceil(N / 4), 256 threads; shared: x [4][H] f32 + partial logits
__global__ void __launch_bounds__(RT_THREADS)
moe_route_kernel(const float* __restrict__ h, const bf16* __restrict__ wr,
                 const bf16* __restrict__ wsg, bf16* __restrict__ x_out,
                 int* __restrict__ experts, float* __restrict__ weights,
                 float* __restrict__ sgate, int* __restrict__ order,
                 int* __restrict__ chunks, int* __restrict__ n_chunks,
                 int* __restrict__ ticket, int* __restrict__ counters, int N,
                 int H, int E, int k, int norm) {
  extern __shared__ float xs[];                      // [4][H]
  __shared__ float part[RT_THREADS / 32][RT_TOKENS][RT_MAX_E];
  __shared__ int cnt[RT_MAX_E], cur[RT_MAX_E];
  __shared__ int wch[RT_THREADS / 32], wrow[RT_THREADS / 32];
  __shared__ int rows_s, most_s;
  __shared__ bool last;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t0 = blockIdx.x * RT_TOKENS;
  const int nt = min(RT_TOKENS, N - t0);
#pragma unroll 4
  for (int i = tid * 4; i < RT_TOKENS * H; i += RT_THREADS * 4) {
    const int t = i / H, c = i % H;           // 4 values: H % 4 == 0
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < nt) {
      const size_t at = (size_t)(t0 + t) * H + c;
      const float4 f = *reinterpret_cast<const float4*>(h + at);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(f.x, f.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(f.z, f.w);
      *reinterpret_cast<__nv_bfloat162*>(x_out + at) = lo;
      *reinterpret_cast<__nv_bfloat162*>(x_out + at + 2) = hi;
      v = make_float4(__low2float(lo), __high2float(lo), __low2float(hi),
                      __high2float(hi));
    }
    *reinterpret_cast<float4*>(xs + i) = v;
  }
  __syncthreads();
  {  // router logits: thread (8 experts eg, rows c = s mod 16 of H); a
     // warp's two slices read two whole router rows, 16 bytes a thread
    const int eg = tid & 15, sl = tid >> 4;
    float acc[RT_TOKENS][8];
#pragma unroll
    for (int t = 0; t < RT_TOKENS; ++t)
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[t][i] = 0.f;
    if (eg * 8 < E) {
#pragma unroll 16
      for (int c = sl; c < H; c += RT_THREADS / 16) {
        float wv[8];
        unpack8(__ldg(reinterpret_cast<const uint4*>(wr + (size_t)c * E +
                                                     eg * 8)), wv);
#pragma unroll
        for (int t = 0; t < RT_TOKENS; ++t) {
          const float xv = xs[t * H + c];
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[t][i] = fmaf(xv, wv[i], acc[t][i]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < RT_TOKENS; ++t)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[t][i] += __shfl_xor_sync(0xffffffffu, acc[t][i], 16);
        if (lane < 16 && eg * 8 < E) part[warp][t][eg * 8 + i] = acc[t][i];
      }
  }
  __syncthreads();
  if (warp < RT_TOKENS && warp < nt) {  // softmax + top-k of token `warp`
    const int t = warp;
    float l[RT_MAX_E / 32];
    float m = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < RT_MAX_E / 32; ++i) {
      const int e = lane + 32 * i;
      float v = -CUDART_INF_F;
      if (e < E) {
        v = part[0][t][e];
#pragma unroll
        for (int w = 1; w < RT_THREADS / 32; ++w) v += part[w][t][e];
      }
      l[i] = v;
      m = fmaxf(m, l[i]);
    }
    m = warp_max(m);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < RT_MAX_E / 32; ++i)
      if (lane + 32 * i < E) s += expf(l[i] - m);
    s = warp_sum(s);
    float pw[MAX_K];
    int pe[MAX_K];
    float psum = 0.f;
    for (int j = 0; j < k; ++j) {   // the largest left; ties: lower expert
      float bv = -CUDART_INF_F;
      int be = 0x7fffffff;
#pragma unroll
      for (int i = 0; i < RT_MAX_E / 32; ++i) {
        const int e = lane + 32 * i;
        if (e < E && (l[i] > bv || (l[i] == bv && e < be))) {
          bv = l[i];
          be = e;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const int oe = __shfl_xor_sync(0xffffffffu, be, o);
        if (ov > bv || (ov == bv && oe < be)) {
          bv = ov;
          be = oe;
        }
      }
#pragma unroll
      for (int i = 0; i < RT_MAX_E / 32; ++i)
        if (be == lane + 32 * i) l[i] = -CUDART_INF_F;
      pe[j] = be;
      pw[j] = expf(bv - m) / s;
      psum += pw[j];
    }
    if (lane == 0) {
      for (int j = 0; j < k; ++j) {
        const float w = norm ? pw[j] / psum : pw[j];
        experts[(t0 + t) * k + j] = pe[j];
        weights[(t0 + t) * k + j] = round_bf(w);
      }
    }
  } else if (warp >= RT_TOKENS && warp - RT_TOKENS < nt) {  // shared gate
    const int t = warp - RT_TOKENS;
    float z = 0.f;
    for (int c = lane; c < H; c += 32) z = fmaf(xs[t * H + c], bf2f(wsg[c]), z);
    z = warp_sum(z);
    if (lane == 0) sgate[t0 + t] = 1.f / (1.f + expf(-z));
  }

  // the last CTA lays the pairs out by expert and lists the chunks
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int P = N * k;
  if (tid < RT_MAX_E) cnt[tid] = 0;
  if (tid == 0) rows_s = most_s = 0;
  __syncthreads();
#pragma unroll 4
  for (int p = tid; p < P; p += RT_THREADS)
    atomicAdd(&cnt[__ldcg(experts + p)], 1);
  __syncthreads();
  // expert e = tid: its rows c at offset `off`, its chunks at `coff`
  // (exclusive scans: within the warp by shuffles, then over warps)
  const int c = tid < E ? cnt[tid] : 0;
  const int nch = (c + CH_ROWS - 1) / CH_ROWS;
  int sc = c, sch = nch;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int a = __shfl_up_sync(0xffffffffu, sc, o);
    const int b = __shfl_up_sync(0xffffffffu, sch, o);
    if (lane >= o) {
      sc += a;
      sch += b;
    }
  }
  if (lane == 31) {
    wrow[warp] = sc;
    wch[warp] = sch;
  }
  if (tid < E) {
    atomicAdd(&rows_s, (c + M_TILE - 1) / M_TILE * M_TILE);
    atomicMax(&most_s, c);
  }
  __syncthreads();
  int off = sc - c, coff = sch - nch, nc = 0;
  for (int w = 0; w < RT_THREADS / 32; ++w) {
    if (w < warp) {
      off += wrow[w];
      coff += wch[w];
    }
    nc += wch[w];
  }
  if (tid < E) {
    cur[tid] = off;
    for (int r = 0, i = coff; r < c; r += CH_ROWS, ++i) {
      chunks[3 * i] = tid;
      chunks[3 * i + 1] = off + r;
      chunks[3 * i + 2] = min(CH_ROWS, c - r);
    }
  }
  for (int r = tid * CH_ROWS; r < N; r += RT_THREADS * CH_ROWS) {
    const int i = nc + r / CH_ROWS;            // the shared expert: tokens
    chunks[3 * i] = E;
    chunks[3 * i + 1] = r;
    chunks[3 * i + 2] = min(CH_ROWS, N - r);
  }
  if (tid == 0) {
    *n_chunks = nc + (N + CH_ROWS - 1) / CH_ROWS;
    if (counters) {
      atomicAdd(counters, P);
      atomicAdd(counters + 1, rows_s);
      atomicMax(counters + 2, most_s);
    }
    *ticket = 0;
  }
  __syncthreads();
#pragma unroll 4
  for (int p = tid; p < P; p += RT_THREADS)
    order[atomicAdd(&cur[__ldcg(experts + p)], 1)] = p;
}

// grid (max chunks, column blocks), 128 threads; see the file comment.
// GATED: a = X (lda H), W = [gate | up] of width 2 Wd (Wd = Ie routed, Is
// shared), K = H, block nb = gate/up columns [64 nb, 64 nb + 64); writes
// act[rho, 64 nb ..] (bf16, row stride ld). Down: a = act (lda ld), W =
// [Wd, H], K = Wd, block nb = output columns [128 nb, +128); writes out.
template <bool GATED>
__global__ void __launch_bounds__(G_THREADS, 3)
moe_gemm_kernel(const int* __restrict__ chunks,
                const int* __restrict__ n_chunks,
                const int* __restrict__ order, const bf16* __restrict__ a,
                int lda, const bf16* __restrict__ w_e,
                const bf16* __restrict__ w_s, int N, int H, int E, int k,
                int Ie, int Is, bf16* __restrict__ act, int ld,
                float* __restrict__ out) {
  extern __shared__ __align__(128) char smem[];
  __shared__ const bf16* arow[CH_ROWS];
  __shared__ int rho[CH_ROWS];
  const int c = blockIdx.x, nb = blockIdx.y;
  if (c >= *n_chunks) return;
  const int e = chunks[3 * c], start = chunks[3 * c + 1];
  const int nrows = chunks[3 * c + 2];
  const bool shared = e == E;
  const int Wd = shared ? Is : Ie;
  if (GATED ? nb * 64 >= Wd : nb * G_NT >= H) return;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int K = GATED ? H : Wd;
  const bf16* wb;
  int ldw;
  if (GATED) {
    wb = shared ? w_s : w_e + (size_t)e * H * 2 * Ie;
    ldw = 2 * Wd;
  } else {
    wb = shared ? w_s : w_e + (size_t)e * Ie * H;
    ldw = H;
  }
  if (tid < CH_ROWS) {
    int r = 0;
    const bf16* src = a;
    if (tid < nrows) {
      r = shared ? N * k + start + tid : order[start + tid];
      const int row = GATED ? (shared ? start + tid : r / k) : r;
      src = a + (size_t)row * lda;
    }
    rho[tid] = r;
    arow[tid] = src;
  }
  __syncthreads();
  const int n_mt = (nrows + M_TILE - 1) / M_TILE;
  const int n_kt = K / G_KT;
  const int gcol = nb * 64, ucol = Wd + nb * 64, dcol = nb * G_NT;

  const auto issue = [&](int kt) {
    if (kt < n_kt) {
      char* st = smem + (kt % G_STAGES) * STAGE_BYTES;
      const int k0 = kt * G_KT;
      for (int i = tid; i < n_mt * M_TILE * 8; i += G_THREADS) {
        const int r = i >> 3, ch = i & 7;
        cp_async16_zfill(st + swz_row(r, ch, 128), arow[r] + k0 + ch * 8,
                         r < nrows);
      }
      char* bs = st + A_BYTES;
      for (int i = tid; i < G_KT * 16; i += G_THREADS) {
        const int kr = i >> 4, ch = i & 15;
        const int col = GATED ? (ch < 8 ? gcol + ch * 8 : ucol + (ch - 8) * 8)
                              : dcol + ch * 8;
        cp_async16(bs + swz_row(kr, ch, 256),
                   wb + (size_t)(k0 + kr) * ldw + col);
      }
    }
    cp_async_commit();
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
  // the warp's four n8 tiles: GATED gate 2w, 2w+1 and up 8+2w, 8+2w+1;
  // down 4w .. 4w+3 (16-byte chunks of a 256-byte stage row)
  int bch[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    bch[j] = GATED ? (j < 2 ? 2 * warp + j : 8 + 2 * warp + j - 2)
                   : 4 * warp + j;

#pragma unroll
  for (int s = 0; s < G_STAGES - 1; ++s) issue(s);
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<G_STAGES - 2>();
    __syncthreads();
    issue(kt + G_STAGES - 1);
    const char* st = smem + (kt % G_STAGES) * STAGE_BYTES;
    const char* bs = st + A_BYTES;
#pragma unroll
    for (int kk = 0; kk < G_KT / 16; ++kk) {
      uint32_t b[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ldsm_x2_trans(b[j], bs + swz_row(kk * 16 + (lane & 15), bch[j], 256));
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if (mt < n_mt) {
          uint32_t af[4];
          ldsm_x4(af, st + swz_row(mt * 16 + (lane & 15),
                                   kk * 2 + (lane >> 4), 128));
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16(acc[mt][j], af, b[j]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    if (mt >= n_mt) continue;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = mt * 16 + g + hf * 8;
      if (r >= nrows) continue;
      const size_t row = (size_t)rho[r];
      if (GATED) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float v[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float gv = acc[mt][j][2 * hf + q];
            const float uv = acc[mt][j + 2][2 * hf + q];
            v[q] = gv / (1.f + expf(-gv)) * uv;
          }
          const int col = nb * 64 + (2 * warp + j) * 8 + tg * 2;
          *reinterpret_cast<__nv_bfloat162*>(act + row * ld + col) =
              __floats2bfloat162_rn(v[0], v[1]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = dcol + (4 * warp + j) * 8 + tg * 2;
          __stcg(reinterpret_cast<float2*>(out + row * H + col),
                 make_float2(acc[mt][j][2 * hf], acc[mt][j][2 * hf + 1]));
        }
      }
    }
  }
}

// grid N, 256 threads: y_t = sum_j w_tj out[t k + j] + s_t out[N k + t]
__global__ void __launch_bounds__(256)
moe_combine_kernel(const float* __restrict__ out,
                   const float* __restrict__ weights,
                   const float* __restrict__ sgate, float* __restrict__ y,
                   int N, int H, int k) {
  const int t = blockIdx.x;
  for (int c = threadIdx.x * 4; c < H; c += 256 * 4) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < k; ++j) {
      const float w = weights[t * k + j];
      const float4 o = __ldcg(reinterpret_cast<const float4*>(
          out + ((size_t)t * k + j) * H + c));
      if (j == 0) {
        s = make_float4(w * o.x, w * o.y, w * o.z, w * o.w);
      } else {
        s.x = fmaf(w, o.x, s.x);
        s.y = fmaf(w, o.y, s.y);
        s.z = fmaf(w, o.z, s.z);
        s.w = fmaf(w, o.w, s.w);
      }
    }
    const float g = sgate[t];
    const float4 o = __ldcg(reinterpret_cast<const float4*>(
        out + ((size_t)N * k + t) * H + c));
    s.x = fmaf(g, o.x, s.x);
    s.y = fmaf(g, o.y, s.y);
    s.z = fmaf(g, o.z, s.z);
    s.w = fmaf(g, o.w, s.w);
    *reinterpret_cast<float4*>(y + (size_t)t * H + c) = s;
  }
}

template <bool GATED>
cudaError_t launch_gemm(dim3 grid, cudaStream_t st, const int* chunks,
                        const int* n_chunks, const int* order, const bf16* a,
                        int lda, const bf16* w_e, const bf16* w_s, int N,
                        int H, int E, int k, int Ie, int Is, bf16* act,
                        int ld, float* out) {
  static bool sized = false;             // the > 48 KB opt-in, once
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        moe_gemm_kernel<GATED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        G_SMEM);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  moe_gemm_kernel<GATED><<<grid, G_THREADS, G_SMEM, st>>>(
      chunks, n_chunks, order, a, lda, w_e, w_s, N, H, E, k, Ie, Is, act, ld,
      out);
  return cudaGetLastError();
}

constexpr int EP_THREADS = 256;
constexpr int EP_TOKENS = EP_THREADS / 32;   // a warp a token
constexpr int EP_MAX_ROUTER = 1024;          // router outputs, 32 a lane
constexpr int EP_MAX_HELD = EP_THREADS;      // a thread a held expert
constexpr int EP_MAX_K = 16;

// grid ceil(N / 8), 256 threads; see the file comment
__global__ void __launch_bounds__(EP_THREADS)
moe_route_ep_kernel(const float* __restrict__ logits,
                    const float* __restrict__ bias, int* __restrict__ experts,
                    float* __restrict__ weights, int* __restrict__ order,
                    int* __restrict__ chunks, int* __restrict__ n_chunks,
                    int* __restrict__ ticket, int* __restrict__ counters,
                    int N, int Et, int E, int e0, int held, int k, int norm,
                    float scale) {
  __shared__ int cnt[EP_MAX_HELD], cur[EP_MAX_HELD];
  __shared__ int wch[EP_THREADS / 32], wrow[EP_THREADS / 32];
  __shared__ int rows_s, most_s, zero_s, remote_s;
  __shared__ bool last;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t = blockIdx.x * EP_TOKENS + warp;
  if (t < N) {
    const float* lg = logits + (size_t)t * Et;
    float p[EP_MAX_ROUTER / 32], c[EP_MAX_ROUTER / 32];
    float m = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < EP_MAX_ROUTER / 32; ++i) {
      const int e = lane + 32 * i;
      p[i] = e < Et ? lg[e] : -CUDART_INF_F;
      m = fmaxf(m, p[i]);
    }
    m = warp_max(m);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < EP_MAX_ROUTER / 32; ++i) {
      p[i] = lane + 32 * i < Et ? expf(p[i] - m) : 0.f;
      s += p[i];
    }
    s = warp_sum(s);
#pragma unroll
    for (int i = 0; i < EP_MAX_ROUTER / 32; ++i) {
      const int e = lane + 32 * i;
      p[i] /= s;
      c[i] = e < Et ? p[i] + (bias ? bias[e] : 0.f) : -CUDART_INF_F;
    }
    float pw[EP_MAX_K];
    int pe[EP_MAX_K];
    float psum = 0.f;
    for (int j = 0; j < k; ++j) {   // the largest choice left; ties: lower id
      float bv = -CUDART_INF_F, bp = 0.f;
      int be = 0x7fffffff;
#pragma unroll
      for (int i = 0; i < EP_MAX_ROUTER / 32; ++i) {
        const int e = lane + 32 * i;
        if (e < Et && (c[i] > bv || (c[i] == bv && e < be))) {
          bv = c[i];
          be = e;
          bp = p[i];
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const int oe = __shfl_xor_sync(0xffffffffu, be, o);
        const float op = __shfl_xor_sync(0xffffffffu, bp, o);
        if (ov > bv || (ov == bv && oe < be)) {
          bv = ov;
          be = oe;
          bp = op;
        }
      }
#pragma unroll
      for (int i = 0; i < EP_MAX_ROUTER / 32; ++i)
        if (be == lane + 32 * i) c[i] = -CUDART_INF_F;
      pe[j] = be;
      pw[j] = bp;
      psum += bp;
    }
    if (lane == 0) {
      for (int j = 0; j < k; ++j) {
        experts[t * k + j] = pe[j];
        weights[t * k + j] = (norm ? pw[j] / psum : pw[j]) * scale;
      }
    }
  }

  // the last CTA lays the held experts' pairs out and lists the chunks
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int P = N * k;
  cnt[tid] = 0;
  if (tid == 0) rows_s = most_s = zero_s = remote_s = 0;
  __syncthreads();
#pragma unroll 4
  for (int q = tid; q < P; q += EP_THREADS) {
    const int e = __ldcg(experts + q), le = e - e0;
    if (e >= E)
      atomicAdd(&zero_s, 1);
    else if (le >= 0 && le < held)
      atomicAdd(&cnt[le], 1);
    else
      atomicAdd(&remote_s, 1);
  }
  __syncthreads();
  // held expert tid: its rows c at offset `off`, its chunks at `coff`
  const int c = tid < held ? cnt[tid] : 0;
  const int nch = (c + CH_ROWS - 1) / CH_ROWS;
  int sc = c, sch = nch;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int a = __shfl_up_sync(0xffffffffu, sc, o);
    const int b = __shfl_up_sync(0xffffffffu, sch, o);
    if (lane >= o) {
      sc += a;
      sch += b;
    }
  }
  if (lane == 31) {
    wrow[warp] = sc;
    wch[warp] = sch;
  }
  if (tid < held) {
    atomicAdd(&rows_s, (c + M_TILE - 1) / M_TILE * M_TILE);
    atomicMax(&most_s, c);
  }
  __syncthreads();
  int off = sc - c, coff = sch - nch, nc = 0;
  for (int w = 0; w < EP_THREADS / 32; ++w) {
    if (w < warp) {
      off += wrow[w];
      coff += wch[w];
    }
    nc += wch[w];
  }
  if (tid < held) {
    cur[tid] = off;
    for (int r = 0, i = coff; r < c; r += CH_ROWS, ++i) {
      chunks[3 * i] = tid;
      chunks[3 * i + 1] = off + r;
      chunks[3 * i + 2] = min(CH_ROWS, c - r);
    }
  }
  if (tid == 0) {
    *n_chunks = nc;
    if (counters) {
      atomicAdd(counters, P - zero_s - remote_s);
      atomicAdd(counters + 1, rows_s);
      atomicMax(counters + 2, most_s);
      atomicAdd(counters + 3, zero_s);
      atomicAdd(counters + 4, remote_s);
    }
    *ticket = 0;
  }
  __syncthreads();
#pragma unroll 4
  for (int q = tid; q < P; q += EP_THREADS) {
    const int le = __ldcg(experts + q) - e0;
    if (le >= 0 && le < held)
      order[atomicAdd(&cur[le], 1)] = q;
  }
}

// grid N, 256 threads: y_t = sum_j in order of w_tj o_tj (file comment)
__global__ void __launch_bounds__(256)
moe_combine_ep_kernel(const float* __restrict__ out,
                      const float* __restrict__ weights,
                      const int* __restrict__ experts,
                      const bf16* __restrict__ x, float* __restrict__ y,
                      int N, int H, int k, int E, int e0, int held) {
  const int t = blockIdx.x;
  for (int c = threadIdx.x * 4; c < H; c += 256 * 4) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < k; ++j) {
      const int e = experts[t * k + j], le = e - e0;
      float4 o;
      if (e >= E) {
        const uint2 raw =
            *reinterpret_cast<const uint2*>(x + (size_t)t * H + c);
        const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(
            &raw.x);
        const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(
            &raw.y);
        o = make_float4(__low2float(lo), __high2float(lo), __low2float(hi),
                        __high2float(hi));
      } else if (le >= 0 && le < held) {
        o = __ldcg(reinterpret_cast<const float4*>(
            out + ((size_t)t * k + j) * H + c));
      } else {
        continue;
      }
      const float w = weights[t * k + j];
      s.x = fmaf(w, o.x, s.x);
      s.y = fmaf(w, o.y, s.y);
      s.z = fmaf(w, o.z, s.z);
      s.w = fmaf(w, o.w, s.w);
    }
    *reinterpret_cast<float4*>(y + (size_t)t * H + c) = s;
  }
}

}  // namespace

extern "C" {

// h [N, H] f32; w_router [H, E], w_sgate [H], w_gu_e [E, H, 2 Ie],
// w_down_e [E, Ie, H], w_gu_s [H, 2 Is], w_down_s [Is, H] bf16. Scratch:
// x [N, H] bf16, experts [N, k] int, weights [N, k] f32, sgate [N] f32,
// order [N k] int, chunks [max_chunks, 3] int, n_chunks [1], ticket [1]
// (0 on entry, left 0), act [N (k + 1), max(Ie, Is)] bf16, out [N (k + 1),
// H] f32. y [N, H] f32; counters [3] int, when given, gain (pairs, padded
// rows) and max rows an expert. Requires H % 128 == 0, Ie % 64 == 0, Is % 64 == 0,
// E <= 128 and E % 8 == 0, 1 <= k <= 8. Four launches; returns the first
// launch error.
int q3_moe_ffn(const float* h, const bf16* w_router, const bf16* w_sgate,
               const bf16* w_gu_e, const bf16* w_down_e, const bf16* w_gu_s,
               const bf16* w_down_s, bf16* x, int* experts, float* weights,
               float* sgate, int* order, int* chunks, int* n_chunks,
               int* ticket, bf16* act, float* out, float* y, int* counters,
               int N, int H, int E, int k, int Ie, int Is, int max_chunks,
               int norm, void* stream) {
  if (H % G_NT || Ie % 64 || Is % 64 || E > RT_MAX_E || E % 8 || k < 1 ||
      k > MAX_K || N < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int rt_smem = RT_TOKENS * H * (int)sizeof(float);
  static int rt_sized = 0;
  if (rt_smem > rt_sized && rt_smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        moe_route_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        rt_smem);
    if (err != cudaSuccess) return (int)err;
    rt_sized = rt_smem;
  }
  moe_route_kernel<<<(N + RT_TOKENS - 1) / RT_TOKENS, RT_THREADS, rt_smem,
                     st>>>(h, w_router, w_sgate, x, experts, weights, sgate,
                           order, chunks, n_chunks, ticket, counters, N, H,
                           E, k, norm);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int ld = Ie > Is ? Ie : Is;
  err = launch_gemm<true>(dim3(max_chunks, ld / 64), st, chunks, n_chunks,
                          order, x, H, w_gu_e, w_gu_s, N, H, E, k, Ie, Is,
                          act, ld, out);
  if (err != cudaSuccess) return (int)err;
  err = launch_gemm<false>(dim3(max_chunks, H / G_NT), st, chunks, n_chunks,
                           order, act, ld, w_down_e, w_down_s, N, H, E, k, Ie,
                           Is, act, ld, out);
  if (err != cudaSuccess) return (int)err;
  moe_combine_kernel<<<N, 256, 0, st>>>(out, weights, sgate, y, N, H, k);
  return (int)cudaGetLastError();
}

// The expert-parallel path (file comment). logits [N, Et] f32 (Et = E
// real + zero experts), bias [Et] f32 or null, x [N, H] bf16 (bf16(h));
// the held experts' w_gu_e [held, H, 2 Ie], w_down_e [held, Ie, H] bf16.
// Scratch: experts [N, k] int (router ids), weights [N, k] f32, order
// [N k] int, chunks [max_chunks, 3] int, n_chunks [1], ticket [1] (0 on
// entry, left 0), act [N k, Ie] bf16, out [N k, H] f32. y [N, H] f32;
// counters [5] int, when given, gain (held pairs, padded rows), the max
// rows an expert, the identity pairs and the pairs held elsewhere.
// Requires H % 128 == 0, Ie % 64 == 0, E <= Et <= 1024, 1 <= k <= min(16,
// Et), 1 <= held <= 256, [e0, e0 + held) inside [0, E). Four launches;
// returns the first launch error.
int q3_moe_ffn_ep(const float* logits, const float* bias, const bf16* x,
                  const bf16* w_gu_e, const bf16* w_down_e, int* experts,
                  float* weights, int* order, int* chunks, int* n_chunks,
                  int* ticket, bf16* act, float* out, float* y, int* counters,
                  int N, int H, int Et, int E, int e0, int held, int k,
                  int Ie, int max_chunks, int norm, float scale,
                  void* stream) {
  if (H % G_NT || Ie % 64 || Et > EP_MAX_ROUTER || E > Et || held < 1 ||
      held > EP_MAX_HELD || e0 < 0 || e0 + held > E || k < 1 ||
      k > EP_MAX_K || k > Et || N < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  moe_route_ep_kernel<<<(N + EP_TOKENS - 1) / EP_TOKENS, EP_THREADS, 0,
                        st>>>(logits, bias, experts, weights, order, chunks,
                              n_chunks, ticket, counters, N, Et, E, e0, held,
                              k, norm, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = launch_gemm<true>(dim3(max_chunks, Ie / 64), st, chunks, n_chunks,
                          order, x, H, w_gu_e, nullptr, N, H, held, k, Ie,
                          Ie, act, Ie, out);
  if (err != cudaSuccess) return (int)err;
  err = launch_gemm<false>(dim3(max_chunks, H / G_NT), st, chunks, n_chunks,
                           order, act, Ie, w_down_e, nullptr, N, H, held, k,
                           Ie, Ie, act, Ie, out);
  if (err != cudaSuccess) return (int)err;
  moe_combine_ep_kernel<<<N, 256, 0, st>>>(out, weights, experts, x, y, N, H,
                                           k, E, e0, held);
  return (int)cudaGetLastError();
}

}  // extern "C"
