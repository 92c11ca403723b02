// Warp-level building blocks of the tensor-core attention kernels
// (flash_attention_mma.cu), on the instructions of ptx_sm90.cuh: swizzled
// 64-row bf16 tiles in shared memory, the tile products and the staged store.
//
// Fragment layouts of mma.sync.aligned.m16n8k16.row.col (g = lane / 4,
// t = lane % 4; every register holds two bf16, the lower column or k first):
//   A (16 x 16): a0 (row g, k 2t..2t+1), a1 (row g + 8, same k),
//                a2 (row g, k 2t + 8..), a3 (row g + 8, k 2t + 8..)
//   B (16 x 8):  b0 (k 2t..2t+1, column g), b1 (k 2t + 8.., column g)
//   C (16 x 8):  c0, c1 (row g, columns 2t, 2t + 1), c2, c3 (row g + 8)
// ldmatrix.x4 reads four 8 x 8 matrices whose row addresses lanes 8i..8i+7
// give; register i of a lane holds matrix i's (row g, columns 2t..2t+1), or
// with .trans its (rows 2t..2t+1, column g).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "ptx_sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TILE_ROWS = 64;    // query rows and keys per tile
constexpr int MMA_THREADS = 128; // four warps, 16 tile rows each

// Two floats rounded to bf16 in one register, `lo` in the lower half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Max and sum over the four lanes that share an accumulator row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// A tile is 64 rows of D bf16, D / 8 chunks of 16 bytes a row, in rows of
// tile_width(D) elements. Chunk c of row r sits at chunk c ^ (r % 8) of its
// row, so the eight rows that one ldmatrix phase reads at a fixed c fall into
// eight different bank groups. The swizzle needs rows of a multiple of eight
// chunks: at D = 48 a row is 64 wide, its six chunks take six of the eight
// swizzled places and the other two are never written or read (at D = 96 a
// row is 128 wide and twelve of its sixteen places are used; products run
// over D / 16 k slices and D / 8 n tiles, stores over D / 8 chunks), so HBM
// is neither padded nor read beyond D.
__host__ __device__ constexpr int tile_width(int D) { return (D + 63) / 64 * 64; }

template <int D>
__device__ __forceinline__ bf16* chunk_ptr(bf16* tile, int row, int chunk) {
  return tile + (row * (tile_width(D) / 8) + (chunk ^ (row & 7))) * 8;
}

template <int D>
__device__ __forceinline__ const bf16* chunk_ptr(const bf16* tile, int row, int chunk) {
  return tile + (row * (tile_width(D) / 8) + (chunk ^ (row & 7))) * 8;
}

// Starts the copy, by the block's THREADS threads, of rows [l0, l0 + ROWS) of
// a (L, D) matrix whose rows are `row_stride` elements apart into `tile`;
// rows at or past L become zeros.
template <int D, int ROWS = TILE_ROWS, int THREADS = MMA_THREADS>
__device__ __forceinline__ void load_tile_async(bf16* tile, const bf16* __restrict__ src,
                                                int l0, int L, int64_t row_stride) {
  constexpr int CH = D / 8;
#pragma unroll
  for (int c = threadIdx.x; c < ROWS * CH; c += THREADS) {
    const int row = c / CH, ch = c % CH;
    const bool valid = l0 + row < L;
    cp_async_16(chunk_ptr<D>(tile, row, ch),
                src + (valid ? (int64_t)(l0 + row) * row_stride + ch * 8 : 0), valid);
  }
}

// The A fragment of rows [m0, m0 + 16), columns [16 kk, 16 kk + 16) of a tile.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int m0, int kk,
                                       int lane) {
  ldmatrix_x4(a, chunk_ptr<D>(tile, m0 + (lane & 15), 2 * kk + (lane >> 4)));
}

// acc (16 x 16 N16) += A Bᵀ with A rows [m0, m0 + 16) of tile `a` and B rows
// [row0, row0 + 16 N16) of tile `b`, both 64 x D: acc[n] is the m16n8 tile of
// b's rows row0 + 8n..+7 (S = Q Kᵀ, dP = dO Vᵀ and their transposes).
template <int D, int N16>
__device__ __forceinline__ void mma_tile_a_bT(float (&acc)[2 * N16][4], const bf16* a,
                                              int m0, const bf16* b, int row0, int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    load_a<D>(af, a, m0, kk, lane);
#pragma unroll
    for (int np = 0; np < N16; ++np) {
      uint32_t f[4];  // b0, b1 of rows 16 np..+7, then of rows 16 np + 8..+15
      ldmatrix_x4(f, chunk_ptr<D>(b, row0 + 16 * np + (lane & 7) + ((lane >> 4) << 3),
                                  2 * kk + ((lane >> 3) & 1)));
      mma_bf16(acc[2 * np], af, f[0], f[1]);
      mma_bf16(acc[2 * np + 1], af, f[2], f[3]);
    }
  }
}

// acc (16 x D) += P B with P (16 x 16 N16) as A fragments and B rows
// [row0, row0 + 16 N16) of the 64 x D tile `b`, read transposed (O += P V,
// dQ += dS K, dV += Pᵀ dO, dK += dSᵀ Q).
template <int D, int N16>
__device__ __forceinline__ void mma_p_b(float (&acc)[D / 8][4], const uint32_t (&p)[N16][4],
                                        const bf16* b, int row0, int lane) {
#pragma unroll
  for (int kk = 0; kk < N16; ++kk)
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t f[4];  // b0, b1 of columns 16 dp..+7, then of 16 dp + 8..+15
      ldmatrix_x4_trans(f, chunk_ptr<D>(b, row0 + 16 * kk + (lane & 15),
                                        2 * dp + (lane >> 4)));
      mma_bf16(acc[2 * dp], p[kk], f[0], f[1]);
      mma_bf16(acc[2 * dp + 1], p[kk], f[2], f[3]);
    }
}

// A 16 x 16 N16 accumulator as the A operand of the next product:
// accumulator tiles 2 kk and 2 kk + 1 are the two halves of A's k slice kk.
template <int N16>
__device__ __forceinline__ void pack_a(uint32_t (&p)[N16][4], const float (&c)[2 * N16][4]) {
#pragma unroll
  for (int kk = 0; kk < N16; ++kk) {
    p[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    p[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    p[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    p[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// Writes the warp's 16 x D accumulator, rows g and g + 8 scaled by f0 and
// f1, as bf16 to rows [l0 + m0, l0 + m0 + 16) below L of `dst`. It goes
// through the warp's own rows [m0, m0 + 16) of `stage`, which no other warp
// touches, so that global memory is written 16 bytes a lane.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4], float f0, float f1,
                                           bf16* stage, int m0, bf16* __restrict__ dst,
                                           int l0, int L, int64_t row_stride, int lane) {
  constexpr int CH = D / 8;
  const int g = lane >> 2, t = lane & 3;
  __syncwarp();
#pragma unroll
  for (int n = 0; n < CH; ++n) {
    *reinterpret_cast<uint32_t*>(chunk_ptr<D>(stage, m0 + g, n) + 2 * t) =
        pack_bf16(acc[n][0] * f0, acc[n][1] * f0);
    *reinterpret_cast<uint32_t*>(chunk_ptr<D>(stage, m0 + g + 8, n) + 2 * t) =
        pack_bf16(acc[n][2] * f1, acc[n][3] * f1);
  }
  __syncwarp();
  for (int c = lane; c < 16 * CH; c += 32) {
    const int row = m0 + c / CH, ch = c % CH;
    if (l0 + row < L)
      *reinterpret_cast<uint4*>(dst + (int64_t)(l0 + row) * row_stride + ch * 8) =
          *reinterpret_cast<const uint4*>(chunk_ptr<D>(stage, row, ch));
  }
}

}  // namespace
