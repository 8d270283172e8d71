// Tensor-core product helpers shared by the code predictor (codepred.cu),
// the talker megakernel (talker_fused.cu), the residual chain (vocoder.cu)
// and, for the cp.async copies, decode attention (attn_tile.cuh):
// - cp.async copies global -> shared through L2, committed in groups, so
//   that a multi-stage ring keeps copies in flight while the tensor cores
//   consume the stage that has landed (cp_async_wait<N>: at most N groups
//   of this thread still in flight);
// - ldmatrix fragments: x4 for a 16x16 bf16 A tile (row-major [m][k]),
//   x2.trans for a 16x8 B tile read from the [K, N] row-major weights as
//   they are (the JAX layout, nothing packed);
// - mma.sync.aligned.m16n8k16 bf16 x bf16 -> f32;
// - the XOR swizzle of 16-byte chunks in tiles of 128-byte rows (or rows
//   of a multiple of 128 bytes), which keeps the 8 row reads of an
//   ldmatrix on 8 different bank groups;
// - the globaltimer read of the kernels' optional phase clocks;
// - the split-K product of the code predictor and the talker: the item
//   walk, the ring's main loop, the tensor-core work of a chunk and the
//   partial-sum epilogue (below; the two kernels differ only in how a
//   chunk's A operand reaches shared memory).
#pragma once

#include "common.cuh"

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

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(s));
}

// c[16x8] += a[16x16] b[16x8], bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// byte offset of 16-byte chunk ch of row r in a [rows][128 B] swizzled tile
__device__ __forceinline__ int swz(int r, int ch) {
  return r * 128 + ((ch ^ (r & 7)) << 4);
}

// the same in a tile of rows of rb bytes (a multiple of 128)
__device__ __forceinline__ int swz_row(int r, int ch, int rb) {
  return r * rb + ((ch ^ (r & 7)) << 4);
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}

// ---- split-K products on a 256-thread CTA ----
// part[ks][m][n] = the sum over the K rows of split ks of A[m][k] W[k][n]
// (W [K, N] bf16 row-major) is cut into items of PROD_NT output columns
// (an n8 slice for each of 8 warps) x `span` K rows. Item it belongs to
// CTA it % gridDim.x; a CTA walks its items in order, per item its row
// groups of up to PROD_MG streams (4 m16 tiles, zero past B: any B >= 1;
// a further group streams the item's weights again, from L2), per group
// its span / PROD_KC chunks of K rows. Each group ends with its partial
// sums; the consuming phase adds the K splits in a fixed order: no
// atomics, deterministic.
constexpr int PROD_NT = 64;   // item columns: 8 warps x n8
constexpr int PROD_KC = 64;   // K rows a ring stage
constexpr int PROD_MG = 64;   // stream rows a pass (4 m16 tiles)

// Chunk c of a CTA's share of a product: its item's column tile and K
// split, its row group (first row, m16 tiles) and its K chunk.
struct Chunk { int tile, ks, m0, n_mt, kc; };

// (SPAN is a constant, so that a chunk's decode divides by constants)
template <int SPAN>
struct ItemWalk {
  static constexpr int n_kc = SPAN / PROD_KC;
  static_assert(SPAN % PROD_KC == 0, "an item spans whole chunks");
  int B, n_tiles, per_item, total;
  __device__ ItemWalk(int N, int K, int B_) : B(B_) {
    n_tiles = N / PROD_NT;
    const int n_items = n_tiles * (K / SPAN);
    const int mine = (int)blockIdx.x < n_items
        ? (n_items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
    per_item = (B + PROD_MG - 1) / PROD_MG * n_kc;
    total = mine * per_item;
  }
  __device__ Chunk at(int c) const {
    Chunk ch;
    const int it = blockIdx.x + (c / per_item) * gridDim.x;
    const int rem = c % per_item;
    ch.tile = it % n_tiles;
    ch.ks = it / n_tiles;
    ch.m0 = (rem / n_kc) * PROD_MG;
    ch.n_mt = min(PROD_MG / 16, (B - ch.m0 + 15) / 16);
    ch.kc = rem % n_kc;
    return ch;
  }
};

// A chunk's operands in shared memory: the A tile (rows of a_rb bytes,
// swizzled 16-byte chunks; the chunk's K rows start at 16-byte chunk
// a_ch0) and its W stage ([PROD_KC][PROD_NT], swizzled 128-byte rows).
struct Operands {
  const char* a;
  int a_rb, a_ch0;
  const char* w;
};

// acc[mt] += the chunk's A rows of m16 tile mt x this warp's n8 slice of W
__device__ __forceinline__ void mma_chunk(float (*acc)[4], int n_mt,
                                          const Operands& o) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int kk = 0; kk < PROD_KC / 16; ++kk) {
    uint32_t b[2];
    ldsm_x2_trans(b, o.w + swz(kk * 16 + (lane & 15), warp));
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      if (mt < n_mt) {
        uint32_t a[4];
        ldsm_x4(a, o.a + swz_row(mt * 16 + (lane & 15),
                                 o.a_ch0 + kk * 2 + (lane >> 4), o.a_rb));
        mma_bf16(acc[mt], a, b);
      }
    }
  }
}

// A row group's sums to part[ch.ks][m][...] (rows m < B of the warp's n8
// slice of column tile ch.tile, N columns a row); acc is zeroed. The
// stores are explicit 8-byte st.global.cg (__stcg of a float2): a plain
// float2 store was split into two 4-byte stores wherever the compiler
// could not prove the alignment (in four of the code predictor's five
// products, or all five, as the inlining fell); on an H100 the explicit
// store took its frame at B = 64 and 192 4-5% under the first case and
// 6-10% under the second.
__device__ __forceinline__ void store_partials(float (*acc)[4],
                                               const Chunk& ch, float* part,
                                               int N, int B) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = lane >> 2;
  float* out = part + (size_t)ch.ks * B * N + ch.tile * PROD_NT + warp * 8 +
               (lane & 3) * 2;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = ch.m0 + mt * 16 + r0 + hf * 8;
      if (mt < ch.n_mt && m < B)
        __stcg(reinterpret_cast<float2*>(out + (size_t)m * N),
               make_float2(acc[mt][2 * hf], acc[mt][2 * hf + 1]));
      acc[mt][2 * hf] = acc[mt][2 * hf + 1] = 0.f;
    }
  }
}

// The ring's main loop over a CTA's chunks c = 0 .. wk.total - 1 through
// NST stages, the first NST - 1 already issued (one commit group each).
// Per chunk: issue(c + NST - 1) issues a later chunk's copies and commits
// one group (an empty one past the end, so that the counts hold);
// prepare(c) may fill shared memory beside the ring that chunk c reads
// (the talker builds its A tile there while the copies fly); then the
// chunk's stage is waited for, operands(c, ch) places it and the tensor
// cores run; a row group's last chunk stores its partial sums to part
// ([splits, B, N]).
template <int NST, int SPAN, class Issue, class Prepare, class Place>
__device__ __forceinline__ void ring_product(const ItemWalk<SPAN>& wk,
                                             float* part,
                                             int N, Issue issue,
                                             Prepare prepare,
                                             Place operands) {
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int c = 0; c < wk.total; ++c) {
    issue(c + NST - 1);
    prepare(c);
    cp_async_wait<NST - 1>();
    __syncthreads();
    const Chunk ch = wk.at(c);
    mma_chunk(acc, ch.n_mt, operands(c, ch));
    if (ch.kc == wk.n_kc - 1) store_partials(acc, ch, part, N, wk.B);
    __syncthreads();                    // the stage (and A) may be refilled
  }
}
