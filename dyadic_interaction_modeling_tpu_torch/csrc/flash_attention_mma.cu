// Flash attention in bf16 on Hopper's tensor cores: forward (K2) and backward
// (K3) for sm_90a. fp32 inputs keep the exact CUDA-core kernels of
// flash_attention.cu; the binding picks by dtype.
//
// Replaces the TPU kernels of dyadic_interaction_modeling_tpu/ops/pallas/
// attention.py: `_fwd` (:111, body `_fwd_kernel` :47) and `_bwd` (:152, body
// `_bwd_kernel` :70), the custom VJP of `flash_attention` (:194-210).
//
// What it computes is flash_attention.cu's: rows r = batch x head of
// (R, L, D) q, k, v, D in {48, 64, 128}; o = softmax(q k^T * scale) v under an
// optional causal mask and a key mask (uint8, row r reads mask row
// r / mask_div); the row log-sum-exp in fp32, natural log, +inf for a query
// row whose keys are all masked, which gets o = 0 and exactly 0 gradients.
// Row block r starts at (r / heads) * batch_stride + (r % heads) *
// head_stride elements and its rows are row_stride apart, in every bf16
// tensor of a call; lse and delta are contiguous (R, L).
//
// Bound on the H100: at the training step's shapes (L = 255-512, D = 64) the
// bytes of q, k, v, o bound the forward and, by a little, the backward (see
// chip_smoke.py for the numbers); the kernels sit well above that bound. A
// block's loop is only 1 to 8 tiles long there, so what holds them is latency:
// the wait for q and the first tile, and the chain product, softmax, product
// of each tile, which only the other warps resident on the SM hide. Register
// use is therefore capped for residency (16 warps an SM in the forward, 12 in
// the backward passes): a forward whose warps took 32 query rows, to load
// every K and V fragment once for two products, ran slower at 8 warps an SM.
// What the design does:
//
// * Instructions. Every product is warp-level mma.sync.m16n8k16 (bf16
//   operands, fp32 accumulators) fed by ldmatrix, FlashAttention-2's
//   instruction. wgmma was not taken: its 64-row warpgroup tile wants the
//   accumulators of a whole 64 x D output in one warpgroup and B operands
//   under TMA's swizzle, a second rewrite of the tile loads, while mma.sync
//   already comes within 10-30% of a library attention at these lengths.
// * Tiles are 64 query rows by 64 keys; a block is four warps and a warp owns
//   16 rows of its block's tile (the forward at D <= 64 without a causal mask
//   takes eight warps, 128 query rows, on one stream of key tiles). Tiles sit
//   in shared memory as bf16 with the 16-byte chunks of a row swizzled
//   (mma_tile.cuh; at D = 48 in rows 64 wide, two chunks a row unused), so
//   no ldmatrix has a bank conflict, and the tiles a loop walks over are
//   double-buffered with cp.async: tile j + 1 is in flight while tile j is
//   multiplied, one __syncthreads a tile. Rows past L are zero-filled by the
//   copy itself.
// * S, P and dS never touch shared memory. The accumulator of S = Q K^T is
//   masked, scaled and exponentiated in registers (exp2f with scale * log2 e
//   folded into the scores; row max and row sum by shuffles over the four
//   lanes that share a row) and repacked as the A operand of P V (pack_a).
//   The denominator sums the unrounded fp32 p; P is rounded to bf16 only as
//   an operand. The backward rounds P and dS to bf16 the same way before
//   P^T dO, dS K and dS^T Q, where the fp32 kernels keep them in fp32.
// * Backward: two deterministic passes, no atomics. The dq pass, one block a
//   query tile, first computes delta = rowsum(dO * O) from fragments, writes
//   it out, and loops over key tiles. The dk/dv pass, one block a key tile,
//   computes the transposes S^T = K Q^T and dP^T = V dO^T, so that P^T and
//   dS^T come out as A operands of dV += P^T dO and dK += dS^T Q, with lse
//   and delta indexed by the fragment's column. S and dP are computed in
//   both passes: 7 tile products for the 5 the gradient needs.
// * Work that cannot count is skipped: key tiles above the diagonal (forward
//   and dq pass), query tiles below it (dk/dv pass), and key tiles whose 64
//   keys are all masked. Only the diagonal tile, the tail tile and tiles of
//   a key-masked row pay for the element mask.

#include <cuda_bf16.h>
#include <math.h>

#include "kernels.h"
#include "mma_tile.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// The backward passes walk a staged 64-wide tile in sub-tiles of 16 SUB16
// columns, which bounds the S and dP registers alive at once, so that
// BWD_MINB blocks fit an SM's registers at D = 64.
constexpr int SUB16 = 2, BWD_MINB = 3;
constexpr int STAGES = 2;  // key tiles of the forward in shared memory at once

// Where the row blocks of a call's bf16 tensors lie (elements).
struct RowBlocks {
  int64_t batch_stride, head_stride, row_stride;
  int heads;
  __device__ __forceinline__ int64_t offset(int r) const {
    return (int64_t)(r / heads) * batch_stride + (int64_t)(r % heads) * head_stride;
  }
};

// Whether key `kj` of the row may be attended at all: inside L and not
// masked. `tid` loads it for key k0 + tid of a tile.
__device__ __forceinline__ int key_live(const uint8_t* __restrict__ mr, int kj, int L) {
  return kj < L && (mr == nullptr || mr[kj] != 0);
}

// The scores of one 16 x 16 N16 accumulator in log2 units, with -inf where
// the staged flags `ms` of its keys (when `use_ms`) or the diagonal (when
// `diag`; `row0` and `col0` are the absolute positions of the accumulator's
// first row and column) forbid.
template <int N16>
__device__ __forceinline__ void scale_and_mask(float (&s)[2 * N16][4], float scale_log2,
                                               const uint8_t* ms, bool use_ms, bool diag,
                                               int row0, int col0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < 2 * N16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * n + 2 * t + (e & 1), r = g + 8 * (e >> 1);
      const bool keep = (!use_ms || ms[c] != 0) && (!diag || col0 + c <= row0 + r);
      s[n][e] = keep ? s[n][e] * scale_log2 : -INFINITY;
    }
}

// K2. Grid (query tiles, rows). A block is NW warps and takes 16 NW query
// rows, which share the K and V tiles the block streams through. At D = 48
// and 64 an SM holds 16 warps of it, at 128 registers a thread.
template <int D, bool CAUSAL, int NW>
__global__ void __launch_bounds__(32 * NW, D <= 64 ? 16 / NW : 1)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                     bf16* __restrict__ o, float* __restrict__ lse, int L, int mask_div,
                     float scale_log2, RowBlocks lay) {
  constexpr int TILE = TILE_ROWS * tile_width(D), Q_ROWS = 16 * NW, THREADS = 32 * NW;
  extern __shared__ uint4 smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // the query tile, then o's staging
  bf16* Ks = Qs + Q_ROWS * tile_width(D);        // STAGES buffers
  bf16* Vs = Ks + STAGES * TILE;                 // STAGES buffers
  uint8_t* Ms = reinterpret_cast<uint8_t*>(Vs + STAGES * TILE);  // STAGES x 64 key flags

  const int r = blockIdx.y;
  // causal: the tiles with the most keys start first
  const int q0 = (CAUSAL ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * Q_ROWS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, m0 = 16 * warp;
  const int64_t base = lay.offset(r);
  const uint8_t* mr = mask ? mask + (size_t)(r / mask_div) * L : nullptr;
  const int k_end = CAUSAL ? min(L, q0 + Q_ROWS) : L;
  const int n_tiles = (k_end + TILE_ROWS - 1) / TILE_ROWS;

  // key tile t goes to buffer t % STAGES, in a copy group of its own (the
  // first with q); STAGES - 1 tiles are in flight ahead of the products
  auto load_keys = [&](int t) {
    load_tile_async<D, TILE_ROWS, THREADS>(Ks + (t % STAGES) * TILE, k + base, t * TILE_ROWS,
                                           L, lay.row_stride);
    load_tile_async<D, TILE_ROWS, THREADS>(Vs + (t % STAGES) * TILE, v + base, t * TILE_ROWS,
                                           L, lay.row_stride);
  };
  load_tile_async<D, Q_ROWS, THREADS>(Qs, q + base, q0, L, lay.row_stride);
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_tiles) {
      load_keys(t);
      if (tid < TILE_ROWS) Ms[t * TILE_ROWS + tid] = (uint8_t)key_live(mr, t * TILE_ROWS + tid, L);
    }
    cp_async_commit();
  }

  float acc[D / 8][4] = {};
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};  // rows g, g + 8

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j % STAGES, k0 = j * TILE_ROWS, ahead = j + STAGES - 1;
    const int mine = tid < TILE_ROWS ? Ms[buf * TILE_ROWS + tid] : 0;  // this thread wrote it
    cp_async_wait<STAGES - 2>();
    // tile j has landed, and tile j - 1 is consumed by every warp
    const int live = __syncthreads_count(mine);  // keys of the tile that can be attended
    int flag = 0;  // of tile `ahead`, which takes tile j - 1's buffer
    if (ahead < n_tiles) {
      load_keys(ahead);
      if (tid < TILE_ROWS) flag = key_live(mr, ahead * TILE_ROWS + tid, L);
    }
    cp_async_commit();
    // unless no key of the tile can be attended, or none by this warp's rows
    if (live && !(CAUSAL && k0 > q0 + m0 + 15)) {
      // the query fragments are read again for every tile: holding them would
      // cost registers, and with them a resident block
      float s[8][4] = {};
      mma_tile_a_bT<D, 4>(s, Qs, m0, Ks + buf * TILE, 0, lane);
      scale_and_mask<4>(s, scale_log2, Ms + buf * TILE_ROWS, live < TILE_ROWS,
                        CAUSAL && k0 + TILE_ROWS - 1 > q0 + m0, q0 + m0, k0, lane);

      // online softmax of rows g (h = 0) and g + 8 (h = 1)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
        const float m_new = fmaxf(m_run[h], quad_max(mx));
        // -inf - -inf is NaN: a row with no key yet exponentiates against 0
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float a = fast_exp2(m_run[h] - m_use);
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          s[n][2 * h] = fast_exp2(s[n][2 * h] - m_use);
          s[n][2 * h + 1] = fast_exp2(s[n][2 * h + 1] - m_use);
          sum += s[n][2 * h] + s[n][2 * h + 1];
        }
        l_run[h] = l_run[h] * a + sum;  // this lane's share; the quad sums at the end
        m_run[h] = m_new;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          acc[n][2 * h] *= a;
          acc[n][2 * h + 1] *= a;
        }
      }
      uint32_t p[4][4];
      pack_a<4>(p, s);
      mma_p_b<D, 4>(acc, p, Vs + buf * TILE, 0, lane);
    }
    // stored only now, so that the flag's load had the products' time to land
    if (tid < TILE_ROWS) Ms[(ahead % STAGES) * TILE_ROWS + tid] = (uint8_t)flag;
  }

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float l = quad_sum(l_run[h]);
    inv[h] = l > 0.f ? 1.f / l : 0.f;
    const int row = q0 + m0 + g + 8 * h;
    if ((lane & 3) == 0 && row < L)
      lse[(size_t)r * L + row] = l > 0.f ? m_run[h] * LN2 + logf(l) : INFINITY;
  }
  store_rows<D>(acc, inv[0], inv[1], Qs, m0, o + base, q0, L, lay.row_stride, lane);
}

// K3, first pass: dq and delta. Grid (query tiles, rows).
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(MMA_THREADS, D <= 64 ? BWD_MINB : 1)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ o,
                        const bf16* __restrict__ dout, const float* __restrict__ lse,
                        const uint8_t* __restrict__ mask, float* __restrict__ delta,
                        bf16* __restrict__ dq, int L, int mask_div, float scale,
                        RowBlocks lay) {
  constexpr int TILE = TILE_ROWS * tile_width(D);
  extern __shared__ uint4 smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // then dq's staging
  bf16* dOs = Qs + TILE;
  bf16* Ks = dOs + TILE;     // 2 buffers
  bf16* Vs = Ks + 2 * TILE;  // 2 buffers; the second holds o until delta is taken
  uint8_t* Ms = reinterpret_cast<uint8_t*>(Vs + 2 * TILE);

  const int r = blockIdx.y;
  const int q0 = (CAUSAL ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * TILE_ROWS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, m0 = 16 * warp;
  const int64_t base = lay.offset(r);
  const uint8_t* mr = mask ? mask + (size_t)(r / mask_div) * L : nullptr;
  const int k_end = CAUSAL ? min(L, q0 + TILE_ROWS) : L;
  const int n_tiles = (k_end + TILE_ROWS - 1) / TILE_ROWS;
  const float scale_log2 = scale * LOG2E;

  load_tile_async<D>(Qs, q + base, q0, L, lay.row_stride);
  load_tile_async<D>(dOs, dout + base, q0, L, lay.row_stride);
  load_tile_async<D>(Vs + TILE, o + base, q0, L, lay.row_stride);
  cp_async_commit();
  load_tile_async<D>(Ks, k + base, 0, L, lay.row_stride);
  load_tile_async<D>(Vs, v + base, 0, L, lay.row_stride);
  cp_async_commit();
  int flag = tid < TILE_ROWS ? key_live(mr, tid, L) : 0;

  // lse in log2 units and delta of rows g and g + 8; rows past L take +inf
  // and 0, so that their p is 0
  float lse2[2], dl[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + m0 + g + 8 * h;
    lse2[h] = row < L ? lse[(size_t)r * L + row] * LOG2E : INFINITY;
  }
  cp_async_wait<1>();  // q, do and o
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4], b[4];
    load_a<D>(a, dOs, m0, kk, lane);
    load_a<D>(b, Vs + TILE, m0, kk, lane);
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // registers 0, 2 are row g, 1, 3 row g + 8
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a[i]));
      const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&b[i]));
      dl[i & 1] += x.x * y.x + x.y * y.y;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    dl[h] = quad_sum(dl[h]);
    const int row = q0 + m0 + g + 8 * h;
    if ((lane & 3) == 0 && row < L) delta[(size_t)r * L + row] = dl[h];
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1, k0 = j * TILE_ROWS;
    if (tid < TILE_ROWS) Ms[buf * TILE_ROWS + tid] = (uint8_t)flag;
    cp_async_wait<0>();
    // tile j has landed; tile j - 1 (or o, at j = 0) is consumed
    const int live = __syncthreads_count(flag);
    flag = 0;
    if (j + 1 < n_tiles) {
      load_tile_async<D>(Ks + (buf ^ 1) * TILE, k + base, k0 + TILE_ROWS, L, lay.row_stride);
      load_tile_async<D>(Vs + (buf ^ 1) * TILE, v + base, k0 + TILE_ROWS, L, lay.row_stride);
      if (tid < TILE_ROWS) flag = key_live(mr, k0 + TILE_ROWS + tid, L);
    }
    cp_async_commit();
    if (!live) continue;

    const bool use_ms = live < TILE_ROWS, diag = CAUSAL && k0 == q0;
#pragma unroll
    for (int c0 = 0; c0 < TILE_ROWS; c0 += 16 * SUB16) {  // keys c0..c0 + 16 SUB16
      float s[2 * SUB16][4] = {}, dp[2 * SUB16][4] = {};
      mma_tile_a_bT<D, SUB16>(s, Qs, m0, Ks + buf * TILE, c0, lane);
      mma_tile_a_bT<D, SUB16>(dp, dOs, m0, Vs + buf * TILE, c0, lane);
      scale_and_mask<SUB16>(s, scale_log2, Ms + buf * TILE_ROWS + c0, use_ms, diag, q0 + m0,
                            k0 + c0, lane);
      // p = exp2(s - lse), 0 where masked (s = -inf) or lse = +inf; dS in place
#pragma unroll
      for (int n = 0; n < 2 * SUB16; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          s[n][e] = fast_exp2(s[n][e] - lse2[h]) * (dp[n][e] - dl[h]) * scale;
        }
      uint32_t ds[SUB16][4];
      pack_a<SUB16>(ds, s);
      mma_p_b<D, SUB16>(acc, ds, Ks + buf * TILE, c0, lane);
    }
  }
  store_rows<D>(acc, 1.f, 1.f, Qs, m0, dq + base, q0, L, lay.row_stride, lane);
}

// K3, second pass: dk and dv, from the first pass's delta. Grid (key tiles,
// rows). Accumulator rows are keys and columns queries here.
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(MMA_THREADS, D <= 64 ? BWD_MINB : 1)
flash_bwd_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const uint8_t* __restrict__ mask, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, int L, int mask_div, float scale,
                          RowBlocks lay) {
  constexpr int TILE = TILE_ROWS * tile_width(D);
  extern __shared__ uint4 smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // then dk's staging
  bf16* Vs = Ks + TILE;                          // then dv's staging
  bf16* Qs = Vs + TILE;                          // 2 buffers
  bf16* dOs = Qs + 2 * TILE;                     // 2 buffers
  float* Ls = reinterpret_cast<float*>(dOs + 2 * TILE);  // 2 x 64 lse of the query tile
  float* Ds = Ls + 2 * TILE_ROWS;                        // 2 x 64 delta

  const int r = blockIdx.y, k0 = blockIdx.x * TILE_ROWS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, m0 = 16 * warp;
  const int64_t base = lay.offset(r);
  const uint8_t* mr = mask ? mask + (size_t)(r / mask_div) * L : nullptr;
  const float scale_log2 = scale * LOG2E;
  const float* lse_r = lse + (size_t)r * L;
  const float* delta_r = delta + (size_t)r * L;
  // causal: queries below k0 attend none of these keys
  const int q_begin = CAUSAL ? k0 : 0;
  const int n_tiles = (L - q_begin + TILE_ROWS - 1) / TILE_ROWS;

  auto load_queries = [&](int buf, int q0) {
    load_tile_async<D>(Qs + buf * TILE, q + base, q0, L, lay.row_stride);
    load_tile_async<D>(dOs + buf * TILE, dout + base, q0, L, lay.row_stride);
    if (tid < TILE_ROWS) {
      const bool valid = q0 + tid < L;
      cp_async_4(Ls + buf * TILE_ROWS + tid, lse_r + (valid ? q0 + tid : 0), valid);
      cp_async_4(Ds + buf * TILE_ROWS + tid, delta_r + (valid ? q0 + tid : 0), valid);
    }
  };
  load_tile_async<D>(Ks, k + base, k0, L, lay.row_stride);
  load_tile_async<D>(Vs, v + base, k0, L, lay.row_stride);
  load_queries(0, q_begin);
  cp_async_commit();

  // the two keys of this lane's accumulator rows
  const bool key_ok[2] = {key_live(mr, k0 + m0 + g, L) != 0,
                          key_live(mr, k0 + m0 + g + 8, L) != 0};
  // a tile whose keys are all masked takes no gradient
  const int live = __syncthreads_or(key_ok[0] || key_ok[1]);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int j = 0; j < (live ? n_tiles : 0); ++j) {
    const int buf = j & 1, q0 = q_begin + j * TILE_ROWS;
    cp_async_wait<0>();
    __syncthreads();  // tile j has landed; tile j - 1 is consumed
    if (j + 1 < n_tiles) load_queries(buf ^ 1, q0 + TILE_ROWS);
    cp_async_commit();

    // only the diagonal tile and the tail tile hold pairs to exclude
    const bool diag = CAUSAL && q0 == k0, tail = q0 + TILE_ROWS > L;
#pragma unroll
    for (int c0 = 0; c0 < TILE_ROWS; c0 += 16 * SUB16) {  // queries c0..c0 + 16 SUB16
      const float* ls = Ls + buf * TILE_ROWS + c0;
      const float* dls = Ds + buf * TILE_ROWS + c0;
      float s[2 * SUB16][4] = {};
      mma_tile_a_bT<D, SUB16>(s, Ks, m0, Qs + buf * TILE, c0, lane);  // S^T: keys x queries
      float2 lse_c[2 * SUB16];  // of this lane's columns 8 n + 2 t, + 1
#pragma unroll
      for (int n = 0; n < 2 * SUB16; ++n)
        lse_c[n] = *reinterpret_cast<const float2*>(ls + 8 * n + 2 * t);
#pragma unroll
      for (int n = 0; n < 2 * SUB16; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * n + 2 * t + (e & 1), h = e >> 1;
          const bool keep = key_ok[h] && (!diag || m0 + g + 8 * h <= c0 + c) &&
                            (!tail || q0 + c0 + c < L);
          // fmaf(s, scale, -lse): -inf, so p = 0, where lse = +inf
          const float lse2 = (e & 1 ? lse_c[n].y : lse_c[n].x) * LOG2E;
          s[n][e] = keep ? fast_exp2(fmaf(s[n][e], scale_log2, -lse2)) : 0.f;
        }
      uint32_t pt[SUB16][4];
      pack_a<SUB16>(pt, s);
      mma_p_b<D, SUB16>(dv_acc, pt, dOs + buf * TILE, c0, lane);  // dV += P^T dO

      float dp[2 * SUB16][4] = {};
      mma_tile_a_bT<D, SUB16>(dp, Vs, m0, dOs + buf * TILE, c0, lane);  // dP^T
#pragma unroll
      for (int n = 0; n < 2 * SUB16; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 dl = *reinterpret_cast<const float2*>(dls + 8 * n + 2 * t);
          s[n][e] *= (dp[n][e] - (e & 1 ? dl.y : dl.x)) * scale;
        }
      pack_a<SUB16>(pt, s);
      mma_p_b<D, SUB16>(dk_acc, pt, Qs + buf * TILE, c0, lane);  // dK += dS^T Q
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // k and v are consumed (or, for a dead tile, have landed)
  store_rows<D>(dk_acc, 1.f, 1.f, Ks, m0, dk + base, k0, L, lay.row_stride, lane);
  store_rows<D>(dv_acc, 1.f, 1.f, Vs, m0, dv + base, k0, L, lay.row_stride, lane);
}

constexpr size_t tile_bytes(int D) { return (size_t)TILE_ROWS * tile_width(D) * sizeof(bf16); }

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int D, bool CAUSAL>
cudaError_t fwd(const void* q, const void* k, const void* v, const uint8_t* mask, void* o,
                float* lse, int rows, int L, int mask_div, float scale, RowBlocks lay,
                cudaStream_t stream) {
  // eight warps on one stream of key tiles halve the tile reads of four; under
  // a causal mask half of them would idle on the diagonal tiles, and four are
  // faster
  constexpr int NW = D <= 64 && !CAUSAL ? 8 : 4, Q_ROWS = 16 * NW, THREADS = 32 * NW;
  const size_t smem = (Q_ROWS / TILE_ROWS + 2 * STAGES) * tile_bytes(D) + STAGES * TILE_ROWS;
  const cudaError_t err = allow_smem(flash_fwd_mma_kernel<D, CAUSAL, NW>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + Q_ROWS - 1) / Q_ROWS, rows);
  flash_fwd_mma_kernel<D, CAUSAL, NW><<<grid, THREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, mask, (bf16*)o, lse, L, mask_div,
      scale * LOG2E, lay);
  return cudaSuccess;
}

template <int D, bool CAUSAL>
cudaError_t bwd(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, const uint8_t* mask, float* delta,
                void* dq, void* dk, void* dv, int rows, int L, int mask_div, float scale,
                RowBlocks lay, cudaStream_t stream) {
  const size_t smem_dq = 6 * tile_bytes(D) + 2 * TILE_ROWS;
  const size_t smem_dkdv = 6 * tile_bytes(D) + 4 * TILE_ROWS * sizeof(float);
  cudaError_t err = allow_smem(flash_bwd_dq_mma_kernel<D, CAUSAL>, smem_dq);
  if (err == cudaSuccess) err = allow_smem(flash_bwd_dkdv_mma_kernel<D, CAUSAL>, smem_dkdv);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + TILE_ROWS - 1) / TILE_ROWS, rows);
  flash_bwd_dq_mma_kernel<D, CAUSAL><<<grid, MMA_THREADS, smem_dq, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o, (const bf16*)dout,
      lse, mask, delta, (bf16*)dq, L, mask_div, scale, lay);
  // reads the delta the dq pass wrote: same stream, so it runs after it
  flash_bwd_dkdv_mma_kernel<D, CAUSAL><<<grid, MMA_THREADS, smem_dkdv, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse, delta, mask,
      (bf16*)dk, (bf16*)dv, L, mask_div, scale, lay);
  return cudaSuccess;
}

bool strides_ok(int heads, int64_t batch_stride, int64_t head_stride, int64_t row_stride) {
  // every 16-byte chunk of a row must be aligned
  return heads > 0 && batch_stride % 8 == 0 && head_stride % 8 == 0 && row_stride % 8 == 0;
}

}  // namespace

cudaError_t flash_attention_mma_fwd_launch(const void* q, const void* k, const void* v,
                                           const uint8_t* mask, void* o, float* lse,
                                           int rows, int L, int D, int mask_div,
                                           bool causal, float scale, int heads,
                                           int64_t batch_stride, int64_t head_stride,
                                           int64_t row_stride, cudaStream_t stream) {
  if (rows == 0 || L == 0) return cudaSuccess;
  if (!strides_ok(heads, batch_stride, head_stride, row_stride)) return cudaErrorInvalidValue;
  const RowBlocks lay{batch_stride, head_stride, row_stride, heads};
#define FLASH_FWD(D_, C_) \
  return fwd<D_, C_>(q, k, v, mask, o, lse, rows, L, mask_div, scale, lay, stream)
  if (D == 48) {
    if (causal) FLASH_FWD(48, true);
    FLASH_FWD(48, false);
  }
  if (D == 64) {
    if (causal) FLASH_FWD(64, true);
    FLASH_FWD(64, false);
  }
  if (D == 128) {
    if (causal) FLASH_FWD(128, true);
    FLASH_FWD(128, false);
  }
#undef FLASH_FWD
  return cudaErrorInvalidValue;
}

cudaError_t flash_attention_mma_bwd_launch(const void* q, const void* k, const void* v,
                                           const void* o, const void* dout,
                                           const float* lse, const uint8_t* mask,
                                           float* delta, void* dq, void* dk, void* dv,
                                           int rows, int L, int D, int mask_div,
                                           bool causal, float scale, int heads,
                                           int64_t batch_stride, int64_t head_stride,
                                           int64_t row_stride, cudaStream_t stream) {
  if (rows == 0 || L == 0) return cudaSuccess;
  if (!strides_ok(heads, batch_stride, head_stride, row_stride)) return cudaErrorInvalidValue;
  const RowBlocks lay{batch_stride, head_stride, row_stride, heads};
#define FLASH_BWD(D_, C_)                                                             \
  return bwd<D_, C_>(q, k, v, o, dout, lse, mask, delta, dq, dk, dv, rows, L, mask_div, \
                     scale, lay, stream)
  if (D == 48) {
    if (causal) FLASH_BWD(48, true);
    FLASH_BWD(48, false);
  }
  if (D == 64) {
    if (causal) FLASH_BWD(64, true);
    FLASH_BWD(64, false);
  }
  if (D == 128) {
    if (causal) FLASH_BWD(128, true);
    FLASH_BWD(128, false);
  }
#undef FLASH_BWD
  return cudaErrorInvalidValue;
}
