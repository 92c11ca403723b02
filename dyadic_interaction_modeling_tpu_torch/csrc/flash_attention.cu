// Flash attention in fp32 on Hopper's tensor cores, in 3xTF32: forward (K2)
// and backward (K3) for sm_90a. bf16 inputs take the kernels of
// flash_attention_mma.cu; the binding picks by dtype.
//
// Replaces the TPU kernels of dyadic_interaction_modeling_tpu/ops/pallas/
// attention.py: `_fwd` (:111, body `_fwd_kernel` :47) and `_bwd` (:152, body
// `_bwd_kernel` :70), the custom VJP of `flash_attention` (:194-210).
//
// Rows r = batch x head of (R, L, D) q, k, v, D in {48, 64, 96, 128}, fp32,
// contiguous. The forward computes o = softmax(q k^T * scale) v under an
// optional causal mask and a key mask (uint8, row r reads mask row
// r / mask_div) and saves the row log-sum-exp in fp32. A query row whose keys
// are all masked gets o = 0 and lse = +inf, so the backward turns its
// probabilities into exactly 0 and its gradients are 0 (the dense path's
// rule; the Pallas kernel's finite -1e30 mask returns the mean of v there
// instead).
//
// Bound on the H100: operations. Every fp32 multiply-add of the five tile
// products is three TF32 ones on the tensor cores (below), so the bound is
// 3 x operations / 495 TFLOP/s, 165 TFLOP/s of fp32 work: at (8, 1024, 96)
// 19.5 us forward and 48.8 us backward, at (8, 1024, 48) 9.8 and 24.4 us
// (chip_smoke.py computes it from each shape it times).
//
// Design:
//
// * 3xTF32. One TF32 product keeps 10 mantissa bits, about three decimal
//   digits: far from the 1e-5 agreement with the plain fp32 version that this
//   path exists for. So each fp32 operand x is split into big = tf32(x) and
//   small = tf32(x - big) (cvt.rna, to nearest), and each product is three
//   mma.sync.m16n8k8 TF32 products, small.big + big.small + big.big, summed
//   in fp32 accumulators. The dropped small.small term and small's own
//   rounding are 2^-22 of a product, within a few fp32 roundings of an FMA.
//   mma.sync and not wgmma: the backward's operands come from registers (P,
//   dS) and from 32-bit loads of tiles read both ways, which wgmma's
//   shared-memory B operand would need staged twice.
// * Blocks. A block takes 64 rows of one dimension (queries in the forward
//   and the dq pass, keys in the dk/dv pass) and streams 64-row tiles of the
//   other through shared memory. Its eight warps are four strips of 16 rows
//   times two halves of each streamed tile: warp w owns rows 16 (w % 4) ..+15
//   and columns 32 (w / 4) ..+31 of every tile, and the two halves' partial
//   results (running max, sum and O; dq; dk and dv) are merged through shared
//   memory at the end, half 1's into half 0's. At the VQ-VAEs' shapes,
//   (8, 1024, D), the grid is 128 blocks for 132 SMs; 16-row strips alone
//   would give each SM four warps, one a scheduler, to hide the latency of
//   every load and product chain, and the halves make it eight. A 32-row
//   query tile would give 256 blocks but the same warps an SM, each block
//   streaming every K and V tile for half the rows. Four halves would hold
//   sixteen warps to 128 registers a thread, of which O's accumulator alone
//   takes 64 at D = 128.
// * Shared memory. Tiles are fp32 rows padded to D + 4 floats, read with
//   32-bit loads: ldmatrix moves 16-bit elements and cannot transpose fp32.
//   With that stride the fragments of A Bᵀ (row g, column t) and the B
//   fragments of P V, dS K, Pᵀ dO and dSᵀ Q (rows 2t and 2t + 1, column g)
//   fall in 32 different banks. The streamed tiles are double-buffered with
//   cp.async: tile j + 1 is in flight while tile j is multiplied, one
//   __syncthreads a tile. Rows past L are zero-filled by the copy; the inputs
//   are never padded. The forward splits its query tile once, in shared
//   memory (split_tile), where every warp would split its A fragments again
//   for each key tile; the backward's A operands
//   would need two more tiles, which D = 128 does not have room for.
// * Registers. S, P, dP and dS stay in the accumulators. The online softmax
//   runs there in log2 units (scale x log2 e folded in, ex2.approx), row max
//   and sum over the four lanes of a row by shuffles. An m16n8k8 accumulator
//   holds columns 2t and 2t + 1 of its rows where the A operand takes
//   columns t and t + 4; a sum over keys does not care about their order, so
//   the accumulator is fed as A unchanged, slot t standing for column 2t and
//   slot t + 4 for 2t + 1, and the B fragment is read from rows 2t and 2t + 1
//   to match (mma_pb).
// * Backward: two deterministic passes, no atomics, both recomputing
//   P = exp(s - lse) from the saved lse. The TPU kernel carried dk/dv across
//   a sequential grid; Hopper's blocks run in parallel with nothing carried.
//   - dq: one block a query tile sweeps the key tiles twice. The first
//     sweep computes S and dP and sums P and P dP of each row: delta =
//     sum(P dP) / sum(P), written out. The second computes them again, in
//     the same order, and dS = P (dP - delta), dQ += dS K. A row's dS then
//     sums to 0 to rounding, as autograd's softmax backward gives it; the
//     usual delta = rowsum(dO * O) (the Pallas body's) differs from
//     sum(P dP) by the forward's rounding, which dq multiplies by the row's
//     mean key: where a row's keys are nearly alike (an encoder over frames
//     that share a few VQ codes) that is several times fp32's error in the
//     query and key gradients. The first sweep costs two of the backward's
//     seven tile products more;
//   - dk/dv: one block a key tile loops over the query tiles at or below the
//     diagonal, reading that delta, with Sᵀ = K Qᵀ and dPᵀ = V dOᵀ computed
//     so that Pᵀ and dSᵀ come out as A operands of dV += Pᵀ dO and
//     dK += dSᵀ Q.
// * Work that cannot count is skipped: key tiles above the diagonal, query
//   tiles below it, a warp's half tile wholly on the wrong side of it, and
//   key tiles whose 64 keys are all masked. Only the diagonal tile, the tail
//   tile and tiles of a key-masked row pay for the element mask.

#include <math.h>
#include <stdint.h>

#include "kernels.h"
#include "mma_tile.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

constexpr int STRIPS = 4;  // 16-row strips of a block's own 64 rows
constexpr int HALVES = 2;  // parts of each streamed tile, one per warp of a strip
constexpr int WARPS = STRIPS * HALVES, THREADS = 32 * WARPS;
constexpr int HALF = TILE_ROWS / HALVES;  // streamed columns a warp takes a tile
constexpr int HT = HALF / 8;              // their m16n8 accumulator tiles
constexpr int SLOTS = 32 * STRIPS;        // lanes of one half, in the merge area

// Row stride of a staged tile in floats: 4 past D, so that 2 x stride is 8
// banks modulo 32 and stride / 4 is odd (bank-conflict-free fragments).
__host__ __device__ constexpr int row_floats(int D) { return D + 4; }
__host__ __device__ constexpr int tile_floats(int D) { return TILE_ROWS * row_floats(D); }

// x = big + small to 2^-22 of x, both TF32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = cvt_tf32(x);
  small = cvt_tf32(x - __uint_as_float(big));
}

// c += a b in 3xTF32, a already split, b = (b0, b1) in fp32.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4], float b0, float b1) {
  uint32_t bb[2], bs[2];
  split_tf32(b0, bb[0], bs[0]);
  split_tf32(b1, bb[1], bs[1]);
  mma_tf32(c, a_small, bb[0], bb[1]);
  mma_tf32(c, a_big, bs[0], bs[1]);
  mma_tf32(c, a_big, bb[0], bb[1]);
}

// Starts the copy of rows [l0, l0 + 64) of a (L, D) fp32 matrix into `tile`;
// rows at or past L become zeros.
template <int D>
__device__ __forceinline__ void load_tile(float* tile, const float* __restrict__ src, int l0,
                                          int L) {
  constexpr int CH = D / 4;  // 16-byte chunks a row
#pragma unroll
  for (int c = threadIdx.x; c < TILE_ROWS * CH; c += THREADS) {
    const int row = c / CH, ch = c % CH;
    const bool valid = l0 + row < L;
    cp_async_16(tile + row * row_floats(D) + 4 * ch,
                src + (valid ? (size_t)(l0 + row) * D + 4 * ch : 0), valid);
  }
}

// Splits the 16-byte chunks that this thread copied into `tile` (load_tile's
// loop) in place into their TF32 big parts, and writes the small parts to
// the same places of `small`: a tile that every warp reads as A operands is
// then split once, not once a warp and a streamed tile.
template <int D>
__device__ __forceinline__ void split_tile(float* tile, float* small) {
  constexpr int CH = D / 4;
#pragma unroll
  for (int c = threadIdx.x; c < TILE_ROWS * CH; c += THREADS) {
    const int at = (c / CH) * row_floats(D) + 4 * (c % CH);
    float x[4], y[4];
    *reinterpret_cast<float4*>(x) = *reinterpret_cast<const float4*>(tile + at);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t big, sm;
      split_tf32(x[i], big, sm);
      x[i] = __uint_as_float(big);
      y[i] = __uint_as_float(sm);
    }
    *reinterpret_cast<float4*>(tile + at) = *reinterpret_cast<const float4*>(x);
    *reinterpret_cast<float4*>(small + at) = *reinterpret_cast<const float4*>(y);
  }
}

// acc (16 x 8 NT) += A Bᵀ over D: A rows [m0, m0 + 16) of tile `a`, B rows
// [n0, n0 + 8 NT) of tile `b` (S = Q Kᵀ, dP = dO Vᵀ and their transposes).
// With PRESPLIT, `a` and `a_small` are split_tile's two parts of A.
template <int D, int NT, bool PRESPLIT = false>
__device__ __forceinline__ void mma_abT(float (&acc)[NT][4], const float* a, int m0,
                                        const float* b, int n0, int lane,
                                        const float* a_small = nullptr) {
  constexpr int LD = row_floats(D);
  const int a0 = (m0 + (lane >> 2)) * LD + (lane & 3);
  const float* br = b + (n0 + (lane >> 2)) * LD + (lane & 3);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const int at[4] = {a0 + 8 * kk, a0 + 8 * LD + 8 * kk, a0 + 8 * kk + 4,
                       a0 + 8 * LD + 8 * kk + 4};
    uint32_t ab[4], as[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (PRESPLIT) {
        ab[i] = __float_as_uint(a[at[i]]);
        as[i] = __float_as_uint(a_small[at[i]]);
      } else {
        split_tf32(a[at[i]], ab[i], as[i]);
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
      mma_3xtf32(acc[n], ab, as, br[8 * n * LD + 8 * kk], br[8 * n * LD + 8 * kk + 4]);
  }
}

// acc (16 x D) += P B: P (16 x 8 NT) an accumulator, B rows [k0, k0 + 8 NT)
// of tile `b` (O += P V, dQ += dS K, dV += Pᵀ dO, dK += dSᵀ Q). Accumulator
// tile kk is A's k slice kk with slot t standing for its column 2t and slot
// t + 4 for 2t + 1, so B's slots t and t + 4 are rows 8 kk + 2t and + 1.
template <int D, int NT>
__device__ __forceinline__ void mma_pb(float (&acc)[D / 8][4], const float (&p)[NT][4],
                                       const float* b, int k0, int lane) {
  constexpr int LD = row_floats(D);
  const float* br = b + (k0 + 2 * (lane & 3)) * LD + (lane >> 2);
#pragma unroll
  for (int kk = 0; kk < NT; ++kk) {
    const float x[4] = {p[kk][0], p[kk][2], p[kk][1], p[kk][3]};
    uint32_t ab[4], as[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(x[i], ab[i], as[i]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      mma_3xtf32(acc[n], ab, as, br[8 * kk * LD + 8 * n], br[(8 * kk + 1) * LD + 8 * n]);
  }
}

// Whether key `kj` of the row may be attended at all: inside L and not masked.
__device__ __forceinline__ int key_live(const uint8_t* __restrict__ mr, int kj, int L) {
  return kj < L && (mr == nullptr || mr[kj] != 0);
}

// The scores of a warp's 16 x 8 NT accumulator in log2 units, -inf where the
// staged flags `ms` of its keys (when `use_ms`) or the diagonal (when `diag`;
// `row0` and `col0` are the absolute positions of its first row and column)
// forbid.
template <int NT>
__device__ __forceinline__ void scale_and_mask(float (&s)[NT][4], float scale_log2,
                                               const uint8_t* ms, bool use_ms, bool diag,
                                               int row0, int col0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * n + 2 * t + (e & 1), r = g + 8 * (e >> 1);
      const bool keep = (!use_ms || ms[c] != 0) && (!diag || col0 + c <= row0 + r);
      s[n][e] = keep ? s[n][e] * scale_log2 : -INFINITY;
    }
}

// Writes rows g and g + 8 of a warp's 16 x D accumulator, scaled by f[0] and
// f[1], to rows [l0, l0 + 16) below L of a (L, D) matrix.
template <int D>
__device__ __forceinline__ void store_acc(const float (&acc)[D / 8][4], const float (&f)[2],
                                          float* __restrict__ dst, int l0, int L, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (l0 + g + 8 * h >= L) continue;
    float* row = dst + (size_t)(l0 + g + 8 * h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(row + 8 * n) =
          make_float2(acc[n][2 * h] * f[h], acc[n][2 * h + 1] * f[h]);
  }
}

// The merge area holds a half's accumulators lane by lane: value i of the
// lane in slot `slot` at x[i * SLOTS + slot], so a warp's access is 32
// consecutive floats.
template <int N>
__device__ __forceinline__ void stash(float* x, const float (&acc)[N][4], int slot) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[(4 * n + e) * SLOTS + slot] = acc[n][e];
}

template <int N>
__device__ __forceinline__ void add_stashed(float (&acc)[N][4], const float* x, int slot) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += x[(4 * n + e) * SLOTS + slot];
}

// Joins the partial results of a strip's two warps into half 0's through
// the area at `x`: `put(x)` stashes half 1's results, `take(x)` adds them to
// half 0's. Every thread of the block calls it.
static_assert(HALVES == 2, "join_halves merges one pair");
template <typename Put, typename Take>
__device__ __forceinline__ void join_halves(float* x, int half, Put put, Take take) {
  __syncthreads();  // the buffers the area takes are free
  if (half) put(x);
  __syncthreads();
  if (!half) take(x);
}

// K2. Grid (query tiles, rows).
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const uint8_t* __restrict__ mask,
                 float* __restrict__ o, float* __restrict__ lse, int L, int mask_div,
                 float scale_log2) {
  constexpr int TILE = tile_floats(D);
  extern __shared__ float4 smem_f4[];
  float* Qs = reinterpret_cast<float*>(smem_f4);  // the query tile's big parts
  float* Qsm = Qs + TILE;                          // and its small parts
  float* Ks = Qsm + TILE;     // 2 buffers, then the merge area
  float* Vs = Ks + 2 * TILE;  // 2 buffers
  uint8_t* Ms = reinterpret_cast<uint8_t*>(Vs + 2 * TILE);  // 2 x 64 key flags

  const int r = blockIdx.y;
  // causal: the tiles with the most keys start first
  const int q0 = (CAUSAL ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * TILE_ROWS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, m0 = 16 * (warp % STRIPS), c0 = HALF * (warp / STRIPS);
  const size_t base = (size_t)r * L * D;
  const uint8_t* mr = mask ? mask + (size_t)(r / mask_div) * L : nullptr;
  const int k_end = CAUSAL ? min(L, q0 + TILE_ROWS) : L;
  const int n_tiles = (k_end + TILE_ROWS - 1) / TILE_ROWS;

  load_tile<D>(Qs, q + base, q0, L);
  load_tile<D>(Ks, k + base, 0, L);
  load_tile<D>(Vs, v + base, 0, L);
  cp_async_commit();
  int flag = tid < TILE_ROWS ? key_live(mr, tid, L) : 0;

  float acc[D / 8][4] = {};
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};  // rows g, g + 8
  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1, k0 = j * TILE_ROWS;
    if (tid < TILE_ROWS) Ms[buf * TILE_ROWS + tid] = (uint8_t)flag;
    cp_async_wait<0>();
    if (j == 0) split_tile<D>(Qs, Qsm);  // q landed with tile 0
    // tile j has landed; tile j - 1 is consumed by every warp
    const int live = __syncthreads_count(flag);  // keys of the tile that can be attended
    flag = 0;
    if (j + 1 < n_tiles) {
      load_tile<D>(Ks + (buf ^ 1) * TILE, k + base, k0 + TILE_ROWS, L);
      load_tile<D>(Vs + (buf ^ 1) * TILE, v + base, k0 + TILE_ROWS, L);
      if (tid < TILE_ROWS) flag = key_live(mr, k0 + TILE_ROWS + tid, L);
    }
    cp_async_commit();
    // unless no key of the tile can be attended, or none of this warp's by its rows
    if (!live || (CAUSAL && k0 + c0 > q0 + m0 + 15)) continue;
    float s[HT][4] = {};
    mma_abT<D, HT, true>(s, Qs, m0, Ks + buf * TILE, c0, lane, Qsm);
    scale_and_mask<HT>(s, scale_log2, Ms + buf * TILE_ROWS + c0, live < TILE_ROWS,
                       CAUSAL && k0 + c0 + HALF - 1 > q0 + m0, q0 + m0, k0 + c0, lane);
    // online softmax of rows g (h = 0) and g + 8 (h = 1)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < HT; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
      const float m_new = fmaxf(m_run[h], quad_max(mx));
      // -inf - -inf is NaN: a row with no key yet exponentiates against 0
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float a = fast_exp2(m_run[h] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < HT; ++n) {
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
    mma_pb<D, HT>(acc, s, Vs + buf * TILE, c0, lane);
  }

  // the halves' running max, sum and O join, in the K and V buffers
  cp_async_wait<0>();
  const int half = warp / STRIPS, slot = (warp % STRIPS) * 32 + lane;
#pragma unroll
  for (int h = 0; h < 2; ++h) l_run[h] = quad_sum(l_run[h]);
  join_halves(
      Ks, half,
      [&](float* x) {
        stash(x, acc, slot);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          x[(D / 2 + h) * SLOTS + slot] = m_run[h];
          x[(D / 2 + 2 + h) * SLOTS + slot] = l_run[h];
        }
      },
      [&](const float* x) {
        float a0[2], a1[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float m1 = x[(D / 2 + h) * SLOTS + slot], l1 = x[(D / 2 + 2 + h) * SLOTS + slot];
          const float m = fmaxf(m_run[h], m1);
          a0[h] = m_run[h] == -INFINITY ? 0.f : fast_exp2(m_run[h] - m);
          a1[h] = m1 == -INFINITY ? 0.f : fast_exp2(m1 - m);
          l_run[h] = l_run[h] * a0[h] + l1 * a1[h];
          m_run[h] = m;
        }
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[n][e] = acc[n][e] * a0[e >> 1] + x[(4 * n + e) * SLOTS + slot] * a1[e >> 1];
      });
  if (half) return;
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float l = l_run[h];
    inv[h] = l > 0.f ? 1.f / l : 0.f;
    const int row = q0 + m0 + g + 8 * h;
    if ((lane & 3) == 0 && row < L)
      lse[(size_t)r * L + row] = l > 0.f ? m_run[h] * LN2 + logf(l) : INFINITY;
  }
  store_acc<D>(acc, inv, o + base, q0 + m0, L, lane);
}

// K3, first pass: delta, then dq. Grid (query tiles, rows).
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const uint8_t* __restrict__ mask,
                    float* __restrict__ delta, float* __restrict__ dq, int L, int mask_div,
                    float scale) {
  constexpr int TILE = tile_floats(D);
  extern __shared__ float4 smem_f4[];
  float* Qs = reinterpret_cast<float*>(smem_f4);
  float* dOs = Qs + TILE;
  float* Ks = dOs + TILE;     // 2 buffers, then the merge area
  float* Vs = Ks + 2 * TILE;  // 2 buffers
  float* Dl = Vs + 2 * TILE;  // delta of the 64 query rows
  uint8_t* Ms = reinterpret_cast<uint8_t*>(Dl + TILE_ROWS);  // 2 x 64 key flags

  const int r = blockIdx.y;
  const int q0 = (CAUSAL ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * TILE_ROWS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, m0 = 16 * (warp % STRIPS), c0 = HALF * (warp / STRIPS);
  const int half = warp / STRIPS, slot = (warp % STRIPS) * 32 + lane;
  const size_t base = (size_t)r * L * D;
  const uint8_t* mr = mask ? mask + (size_t)(r / mask_div) * L : nullptr;
  const int k_end = CAUSAL ? min(L, q0 + TILE_ROWS) : L;
  const int n_tiles = (k_end + TILE_ROWS - 1) / TILE_ROWS;
  const float scale_log2 = scale * LOG2E;

  load_tile<D>(Qs, q + base, q0, L);
  load_tile<D>(dOs, dout + base, q0, L);

  // lse of rows g and g + 8 in log2 units; rows past L take +inf, so p = 0
  float lse2[2], dl[2] = {}, psum[2] = {}, dsum[2] = {};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + m0 + g + 8 * h;
    lse2[h] = row < L ? lse[(size_t)r * L + row] * LOG2E : INFINITY;
  }

  // Two sweeps over the key tiles, the same products in the same order: the
  // first sums p and p dp of each row, the second takes dS = p (dp - delta)
  // with delta = sum(p dp) / sum(p), so that sum_j dS_ij is 0 to rounding.
  // delta = rowsum(dO o), the usual choice, differs from sum(p dp) by the
  // forward's rounding, which the backward then multiplies by sum_j p_ij k_j
  // (the mean key): where a row's keys are nearly alike, that error is many
  // times dq itself.
  float acc[D / 8][4] = {};
  for (int sweep = 0; sweep < 2; ++sweep) {
    load_tile<D>(Ks, k + base, 0, L);
    load_tile<D>(Vs, v + base, 0, L);
    cp_async_commit();
    int flag = tid < TILE_ROWS ? key_live(mr, tid, L) : 0;
    for (int j = 0; j < n_tiles; ++j) {
      const int buf = j & 1, k0 = j * TILE_ROWS;
      if (tid < TILE_ROWS) Ms[buf * TILE_ROWS + tid] = (uint8_t)flag;
      cp_async_wait<0>();
      // tile j has landed; tile j - 1 is consumed
      const int live = __syncthreads_count(flag);
      flag = 0;
      if (j + 1 < n_tiles) {
        load_tile<D>(Ks + (buf ^ 1) * TILE, k + base, k0 + TILE_ROWS, L);
        load_tile<D>(Vs + (buf ^ 1) * TILE, v + base, k0 + TILE_ROWS, L);
        if (tid < TILE_ROWS) flag = key_live(mr, k0 + TILE_ROWS + tid, L);
      }
      cp_async_commit();
      if (!live || (CAUSAL && k0 + c0 > q0 + m0 + 15)) continue;
      float s[HT][4] = {}, dp[HT][4] = {};
      mma_abT<D, HT>(s, Qs, m0, Ks + buf * TILE, c0, lane);
      mma_abT<D, HT>(dp, dOs, m0, Vs + buf * TILE, c0, lane);
      scale_and_mask<HT>(s, scale_log2, Ms + buf * TILE_ROWS + c0, live < TILE_ROWS,
                         CAUSAL && k0 + c0 + HALF - 1 > q0 + m0, q0 + m0, k0 + c0, lane);
      // p = exp2(s - lse), 0 where masked (s = -inf) or lse = +inf
#pragma unroll
      for (int n = 0; n < HT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const float p = fast_exp2(s[n][e] - lse2[h]);
          if (sweep == 0) {
            psum[h] += p;
            dsum[h] = fmaf(p, dp[n][e], dsum[h]);
          } else {
            s[n][e] = p * (dp[n][e] - dl[h]) * scale;  // dS in place
          }
        }
      if (sweep == 1) mma_pb<D, HT>(acc, s, Ks + buf * TILE, c0, lane);  // dQ += dS K
    }
    cp_async_wait<0>();
    __syncthreads();  // every tile read: the K buffers are free
    if (sweep == 1) break;
    // delta of rows g and g + 8: the four lanes of a row, then the halves,
    // through the K buffers
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int m = 1; m < 4; m *= 2) {
        psum[h] += __shfl_xor_sync(0xffffffffu, psum[h], m);
        dsum[h] += __shfl_xor_sync(0xffffffffu, dsum[h], m);
      }
    const bool writer = (lane & 3) == 0;
    if (half && writer)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        Ks[2 * (m0 + g + 8 * h)] = psum[h];
        Ks[2 * (m0 + g + 8 * h) + 1] = dsum[h];
      }
    __syncthreads();  // after the next one the K buffers are free for the second sweep
    if (!half && writer)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + g + 8 * h;
        const float ps = psum[h] + Ks[2 * row], ds = dsum[h] + Ks[2 * row + 1];
        const float d = ps > 0.f ? ds / ps : 0.f;  // 0 for a row that attends nothing
        Dl[row] = d;
        if (q0 + row < L) delta[(size_t)r * L + q0 + row] = d;
      }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h) dl[h] = Dl[m0 + g + 8 * h];
  }

  // the halves' dq join, in the K and V buffers
  join_halves(
      Ks, half, [&](float* x) { stash(x, acc, slot); },
      [&](const float* x) { add_stashed(acc, x, slot); });
  if (half) return;
  store_acc<D>(acc, {1.f, 1.f}, dq + base, q0 + m0, L, lane);
}

// K3, second pass: dk and dv, from the first pass's delta. Grid (key tiles,
// rows). Accumulator rows are keys and columns queries here.
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      const uint8_t* __restrict__ mask, float* __restrict__ dk,
                      float* __restrict__ dv, int L, int mask_div, float scale) {
  constexpr int TILE = tile_floats(D);
  extern __shared__ float4 smem_f4[];
  float* Ks = reinterpret_cast<float*>(smem_f4);
  float* Vs = Ks + TILE;
  float* Qs = Vs + TILE;       // 2 buffers, then the merge area
  float* dOs = Qs + 2 * TILE;  // 2 buffers
  float* Ls = dOs + 2 * TILE;  // 2 x 64 lse of the query tile
  float* Ds = Ls + 2 * TILE_ROWS;  // 2 x 64 delta

  const int r = blockIdx.y, k0 = blockIdx.x * TILE_ROWS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, m0 = 16 * (warp % STRIPS), c0 = HALF * (warp / STRIPS);
  const size_t base = (size_t)r * L * D;
  const uint8_t* mr = mask ? mask + (size_t)(r / mask_div) * L : nullptr;
  const float scale_log2 = scale * LOG2E;
  const float* lse_r = lse + (size_t)r * L;
  const float* delta_r = delta + (size_t)r * L;
  // causal: queries below k0 attend none of these keys
  const int q_begin = CAUSAL ? k0 : 0;
  const int n_tiles = (L - q_begin + TILE_ROWS - 1) / TILE_ROWS;

  auto load_queries = [&](int buf, int q0) {
    load_tile<D>(Qs + buf * TILE, q + base, q0, L);
    load_tile<D>(dOs + buf * TILE, dout + base, q0, L);
    if (tid < TILE_ROWS) {
      const bool valid = q0 + tid < L;
      cp_async_4(Ls + buf * TILE_ROWS + tid, lse_r + (valid ? q0 + tid : 0), valid);
      cp_async_4(Ds + buf * TILE_ROWS + tid, delta_r + (valid ? q0 + tid : 0), valid);
    }
  };
  load_tile<D>(Ks, k + base, k0, L);
  load_tile<D>(Vs, v + base, k0, L);
  load_queries(0, q_begin);
  cp_async_commit();

  // the two keys of this lane's accumulator rows
  const bool key_ok[2] = {key_live(mr, k0 + m0 + g, L) != 0,
                          key_live(mr, k0 + m0 + g + 8, L) != 0};
  // a tile whose keys are all masked takes no gradient
  const int live = __syncthreads_or(key_ok[0] || key_ok[1]);

  float dk_acc[D / 8][4] = {}, dv_acc[D / 8][4] = {};
  for (int j = 0; j < (live ? n_tiles : 0); ++j) {
    const int buf = j & 1, q0 = q_begin + j * TILE_ROWS;
    cp_async_wait<0>();
    __syncthreads();  // tile j has landed; tile j - 1 is consumed
    if (j + 1 < n_tiles) load_queries(buf ^ 1, q0 + TILE_ROWS);
    cp_async_commit();
    // causal: this warp's queries all precede its keys
    if (CAUSAL && q0 + c0 + HALF - 1 < k0 + m0) continue;

    // only the diagonal tile and the tail tile hold pairs to exclude
    const bool diag = CAUSAL && q0 == k0, tail = q0 + TILE_ROWS > L;
    const float* ls = Ls + buf * TILE_ROWS + c0;
    const float* dls = Ds + buf * TILE_ROWS + c0;
    float s[HT][4] = {};
    mma_abT<D, HT>(s, Ks, m0, Qs + buf * TILE, c0, lane);  // Sᵀ: keys x queries
#pragma unroll
    for (int n = 0; n < HT; ++n) {
      // lse of this lane's columns 8 n + 2 t and + 1
      const float2 lse_c = *reinterpret_cast<const float2*>(ls + 8 * n + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + 2 * t + (e & 1), h = e >> 1;
        const bool keep = key_ok[h] && (!diag || m0 + g + 8 * h <= c0 + c) &&
                          (!tail || q0 + c0 + c < L);
        // fmaf(s, scale, -lse): -inf, so p = 0, where lse = +inf
        const float lse2 = (e & 1 ? lse_c.y : lse_c.x) * LOG2E;
        s[n][e] = keep ? fast_exp2(fmaf(s[n][e], scale_log2, -lse2)) : 0.f;
      }
    }
    mma_pb<D, HT>(dv_acc, s, dOs + buf * TILE, c0, lane);  // dV += Pᵀ dO

    float dp[HT][4] = {};
    mma_abT<D, HT>(dp, Vs, m0, dOs + buf * TILE, c0, lane);  // dPᵀ
#pragma unroll
    for (int n = 0; n < HT; ++n) {
      const float2 dl = *reinterpret_cast<const float2*>(dls + 8 * n + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= (dp[n][e] - (e & 1 ? dl.y : dl.x)) * scale;
    }
    mma_pb<D, HT>(dk_acc, s, Qs + buf * TILE, c0, lane);  // dK += dSᵀ Q
  }

  // the halves' dk and dv join, in the query buffers
  cp_async_wait<0>();
  const int half = warp / STRIPS, slot = (warp % STRIPS) * 32 + lane;
  join_halves(
      Qs, half,
      [&](float* x) {
        stash(x, dk_acc, slot);
        stash(x + (D / 2) * SLOTS, dv_acc, slot);
      },
      [&](const float* x) {
        add_stashed(dk_acc, x, slot);
        add_stashed(dv_acc, x + (D / 2) * SLOTS, slot);
      });
  if (half) return;
  store_acc<D>(dk_acc, {1.f, 1.f}, dk + base, k0 + m0, L, lane);
  store_acc<D>(dv_acc, {1.f, 1.f}, dv + base, k0 + m0, L, lane);
}

constexpr size_t tile_bytes(int D) { return sizeof(float) * tile_floats(D); }

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int D, bool CAUSAL>
cudaError_t fwd(const void* q, const void* k, const void* v, const uint8_t* mask, void* o,
                float* lse, int rows, int L, int mask_div, float scale, cudaStream_t stream) {
  const size_t smem = 6 * tile_bytes(D) + 2 * TILE_ROWS;
  const cudaError_t err = allow_smem(flash_fwd_kernel<D, CAUSAL>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + TILE_ROWS - 1) / TILE_ROWS, rows);
  flash_fwd_kernel<D, CAUSAL><<<grid, THREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, mask, (float*)o, lse, L, mask_div,
      scale * LOG2E);
  return cudaSuccess;
}

template <int D, bool CAUSAL>
cudaError_t bwd(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, const uint8_t* mask, float* delta,
                void* dq, void* dk, void* dv, int rows, int L, int mask_div, float scale,
                cudaStream_t stream) {
  const size_t smem_dq = 6 * tile_bytes(D) + sizeof(float) * TILE_ROWS + 2 * TILE_ROWS;
  const size_t smem_dkdv = 6 * tile_bytes(D) + 4 * sizeof(float) * TILE_ROWS;
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<D, CAUSAL>, smem_dq);
  if (err == cudaSuccess) err = allow_smem(flash_bwd_dkdv_kernel<D, CAUSAL>, smem_dkdv);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + TILE_ROWS - 1) / TILE_ROWS, rows);
  flash_bwd_dq_kernel<D, CAUSAL><<<grid, THREADS, smem_dq, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, lse, mask,
      delta, (float*)dq, L, mask_div, scale);
  // reads the delta the dq pass wrote: same stream, so it runs after it
  flash_bwd_dkdv_kernel<D, CAUSAL><<<grid, THREADS, smem_dkdv, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, lse, delta, mask,
      (float*)dk, (float*)dv, L, mask_div, scale);
  return cudaSuccess;
}

}  // namespace

cudaError_t flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                                       const uint8_t* mask, void* o, float* lse,
                                       int rows, int L, int D, int mask_div,
                                       bool causal, float scale, cudaStream_t stream) {
  if (rows == 0 || L == 0) return cudaSuccess;
#define FLASH_FWD(D_, C_) \
  return fwd<D_, C_>(q, k, v, mask, o, lse, rows, L, mask_div, scale, stream)
  if (D == 48) {
    if (causal) FLASH_FWD(48, true);
    FLASH_FWD(48, false);
  }
  if (D == 64) {
    if (causal) FLASH_FWD(64, true);
    FLASH_FWD(64, false);
  }
  if (D == 96) {
    if (causal) FLASH_FWD(96, true);
    FLASH_FWD(96, false);
  }
  if (D == 128) {
    if (causal) FLASH_FWD(128, true);
    FLASH_FWD(128, false);
  }
#undef FLASH_FWD
  return cudaErrorInvalidValue;
}

cudaError_t flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                       const void* o, const void* dout,
                                       const float* lse, const uint8_t* mask,
                                       float* delta, void* dq, void* dk, void* dv,
                                       int rows, int L, int D, int mask_div,
                                       bool causal, float scale, cudaStream_t stream) {
  if (rows == 0 || L == 0) return cudaSuccess;
#define FLASH_BWD(D_, C_)                                                             \
  return bwd<D_, C_>(q, k, v, o, dout, lse, mask, delta, dq, dk, dv, rows, L, mask_div, \
                     scale, stream)
  if (D == 48) {
    if (causal) FLASH_BWD(48, true);
    FLASH_BWD(48, false);
  }
  if (D == 64) {
    if (causal) FLASH_BWD(64, true);
    FLASH_BWD(64, false);
  }
  if (D == 96) {
    if (causal) FLASH_BWD(96, true);
    FLASH_BWD(96, false);
  }
  if (D == 128) {
    if (causal) FLASH_BWD(128, true);
    FLASH_BWD(128, false);
  }
#undef FLASH_BWD
  return cudaErrorInvalidValue;
}
