// Latent (MLA) decode attention against a latent cache (CUDA, sm_90a).
//
// Replaces no TPU kernel: the JAX package has no latent attention. It is the
// absorbed decode step of DeepSeek-V2's multi-head latent attention
// (models/deepseek_v2.py): W_UK folded into the queries, W_UV applied after
// attention over the latent. For each cache row r (a sequence), its 16 query
// rows (one a head) q[r] of 576 (512 latent || 64 rope) attend over the
// cache rows c[r, j], j <= t, of the same 576, and return
// softmax(q c^T * scale) c[:, :512], fp32 accumulated, in bf16: an MQA step
// whose values are the first 512 of each key. Keys past t are never read.
//
// Bound on the H100: bytes. A launch reads each live cache row once, 1152
// bytes, and does 4 x 16 x 544 ~ 35 kFLOP on it, 30 FLOP a byte: under the
// 295 of the tensor cores' ridge, over the 20 of the CUDA cores' 67
// TFLOP/s. At the dsv2_lite cell's shapes (512 rows, 512-767 live keys)
// a launch moves 0.30-0.45 GB -> 90-135 us at 3.35 TB/s.
//
// Design. A block of four warps takes a cache row and a chunk of its keys:
// - the keys stream through shared memory in 64-key tiles (73.7 KB, 72
//   swizzled 16-byte chunks a row, mma_tile.cuh) in a two-stage cp.async
//   ring, so one tile lands while the last is used;
// - S = Q K^T on the tensor cores (mma.sync.m16n8k16, bf16 operands, fp32
//   accumulator): the 16 query rows are one m16 tile, read from shared
//   memory at each k slice; warp w scores keys 16w..16w+15 of the tile over
//   all 576 and writes them, scaled and masked, to a 16 x 64 fp32 tile;
// - every warp then reads the whole 16 x 64 score tile back as A fragments,
//   keeps the online softmax of all 16 rows (the four warps compute the same
//   maxima and sums), rounds P to bf16 and runs O += P V for its own 128 of
//   the 512 value columns, V read transposed out of the same key tile: the
//   fp32 output is 64 registers a thread;
// - the key axis is cut into `splits` chunks (at most 16), chosen on the
//   host from the cache length (and from t when t is an int), so that rows x
//   splits reach the 132 SMs; a block whose chunk starts past t reads no
//   key. With one split a block writes its rows normalised; else it writes
//   its unnormalised partial (and max, sum) to fp32 scratch and a second
//   launch folds the splits in split order, so the bits do not depend on
//   which block ends first.

#include <cuda_bf16.h>
#include <math.h>

#include <algorithm>

#include "kernels.h"
#include "mma_tile.cuh"

namespace {

constexpr int H = LATENT_HEADS;    // query rows a cache row
constexpr int DK = LATENT_DK;      // key width: latent || rope
constexpr int DV = LATENT_DV;      // value width: the key's first DV
constexpr int KT = 64;             // keys a tile
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int CPW = DV / WARPS;    // value columns a warp
constexpr int STAGES = 2;
constexpr int TARGET_BLOCKS = 132;
constexpr int MAX_SPLITS = 16;
constexpr int SPAD = KT + 4;       // floats a row of the score tile
constexpr int PART = DV + 2;       // floats a query row's partial: output, max, sum
constexpr float LOG2E = 1.4426950408889634f;

constexpr size_t SMEM_BYTES = sizeof(bf16) * (size_t)(H + STAGES * KT) * DK
                              + sizeof(float) * (size_t)H * SPAD;

static_assert(DK % 64 == 0 && DV % (16 * WARPS) == 0 && KT == 16 * WARPS, "tile shapes");

__global__ void __launch_bounds__(THREADS)
latent_decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ cache,
                     const int32_t* __restrict__ t_ptr, int t_val, bf16* __restrict__ out,
                     float* __restrict__ part, int L, float scale_log2, int splits,
                     int chunk) {
  extern __shared__ uint4 smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);               // 16 query rows
  bf16* ring = qs + H * DK;                                // [stage] 64 keys
  float* sc = reinterpret_cast<float*>(ring + STAGES * KT * DK);  // 16 x 64 scores
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int r = blockIdx.x / splits, split = blockIdx.x % splits;
  const int t = t_ptr ? *t_ptr : t_val;
  const int live = max(0, min(L, t + 1));  // keys [0, live) are attended
  const int k0 = split * chunk, k1 = min(live, k0 + chunk);
  const int tiles = k1 > k0 ? (k1 - k0 + KT - 1) / KT : 0;
  const bf16* rows = cache + (size_t)r * L * DK;

  load_tile_async<DK, H, THREADS>(qs, q + (size_t)r * H * DK, 0, H, DK);
  cp_async_commit();
  if (tiles > 0) load_tile_async<DK, KT, THREADS>(ring, rows, k0, k1, DK);
  cp_async_commit();

  float acc[CPW / 8][4] = {};
  float mrow[2] = {-INFINITY, -INFINITY}, lsum[2] = {0.f, 0.f};
  for (int i = 0; i < tiles; ++i) {
    const int j0 = k0 + i * KT;
    if (i + 1 < tiles)
      load_tile_async<DK, KT, THREADS>(ring + ((i + 1) % STAGES) * KT * DK, rows, j0 + KT, k1,
                                       DK);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* kt = ring + (i % STAGES) * KT * DK;

    // this warp's 16 keys of the tile against the 16 query rows
    float s[2][4] = {};
#pragma unroll 4
    for (int kk = 0; kk < DK / 16; ++kk) {
      uint32_t a[4], f[4];
      load_a<DK>(a, qs, 0, kk, lane);
      ldmatrix_x4(f, chunk_ptr<DK>(kt, 16 * warp + (lane & 7) + ((lane >> 4) << 3),
                                   2 * kk + ((lane >> 3) & 1)));
      mma_bf16(s[0], a, f[0], f[1]);
      mma_bf16(s[1], a, f[2], f[3]);
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 16 * warp + 8 * n + 2 * tq + (e & 1);
        sc[(g + 8 * (e >> 1)) * SPAD + col] =
            j0 + col < k1 ? s[n][e] * scale_log2 : -INFINITY;
      }
    __syncthreads();

    // the whole tile's scores as A fragments: slice kk holds keys 16kk..+15;
    // p[kk][0..1] row g at keys 16kk + 2tq, +1; [2..3] row g + 8 there;
    // [4..5] row g at keys 16kk + 2tq + 8, +9; [6..7] row g + 8 there
    float p[KT / 16][8], mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int row = g + 8 * ((e >> 1) & 1);
        const int col = 16 * kk + 2 * tq + (e & 1) + 8 * (e >> 2);
        p[kk][e] = sc[row * SPAD + col];
        mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], p[kk][e]);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mn = fmaxf(mrow[h], quad_max(mx[h]));
      alpha[h] = mn == -INFINITY ? 1.f : exp2f(mrow[h] - mn);
      mrow[h] = mn;
      lsum[h] *= alpha[h];
    }
    uint32_t pa[KT / 16][4];
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float mh = mrow[(e >> 1) & 1];
        p[kk][e] = mh == -INFINITY ? 0.f : exp2f(p[kk][e] - mh);
        lsum[(e >> 1) & 1] += p[kk][e];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) pa[kk][j] = pack_bf16(p[kk][2 * j], p[kk][2 * j + 1]);
    }
#pragma unroll
    for (int n = 0; n < CPW / 8; ++n) {
      acc[n][0] *= alpha[0], acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1], acc[n][3] *= alpha[1];
    }
    // O[:, this warp's columns] += P V, V the tile's first DV columns
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
      for (int dp = 0; dp < CPW / 16; ++dp) {
        uint32_t f[4];
        ldmatrix_x4_trans(f, chunk_ptr<DK>(kt, 16 * kk + (lane & 15),
                                           2 * (warp * CPW / 16 + dp) + (lane >> 4)));
        mma_bf16(acc[2 * dp], pa[kk], f[0], f[1]);
        mma_bf16(acc[2 * dp + 1], pa[kk], f[2], f[3]);
      }
    __syncthreads();  // the stage and the score tile are read before they are refilled
  }
  cp_async_wait<0>();

  const float l0 = quad_sum(lsum[0]), l1 = quad_sum(lsum[1]);
  const int c0 = warp * CPW + 2 * tq;
  if (splits == 1) {
    const float f0 = l0 > 0.f ? 1.f / l0 : 0.f, f1 = l1 > 0.f ? 1.f / l1 : 0.f;
    bf16* o = out + (size_t)r * H * DV;
#pragma unroll
    for (int n = 0; n < CPW / 8; ++n) {
      *reinterpret_cast<uint32_t*>(o + g * DV + c0 + 8 * n) =
          pack_bf16(acc[n][0] * f0, acc[n][1] * f0);
      *reinterpret_cast<uint32_t*>(o + (g + 8) * DV + c0 + 8 * n) =
          pack_bf16(acc[n][2] * f1, acc[n][3] * f1);
    }
    return;
  }
  float* slot = part + ((size_t)r * splits + split) * H * PART;
#pragma unroll
  for (int n = 0; n < CPW / 8; ++n) {
    slot[g * PART + c0 + 8 * n] = acc[n][0];
    slot[g * PART + c0 + 8 * n + 1] = acc[n][1];
    slot[(g + 8) * PART + c0 + 8 * n] = acc[n][2];
    slot[(g + 8) * PART + c0 + 8 * n + 1] = acc[n][3];
  }
  if (warp == 0 && tq == 0) {
    slot[g * PART + DV] = mrow[0], slot[g * PART + DV + 1] = l0;
    slot[(g + 8) * PART + DV] = mrow[1], slot[(g + 8) * PART + DV + 1] = l1;
  }
}

// Folds the splits of each cache row in split order: a block a cache row,
// a thread a (query row, column) at a time.
__global__ void __launch_bounds__(THREADS)
latent_combine_kernel(const float* __restrict__ part, bf16* __restrict__ out, int splits) {
  const int r = blockIdx.x;
  const float* slots = part + (size_t)r * splits * H * PART;
  for (int i = threadIdx.x; i < H * DV; i += THREADS) {
    const int row = i / DV, c = i % DV;
    float mx = -INFINITY;
    for (int s = 0; s < splits; ++s) mx = fmaxf(mx, slots[((size_t)s * H + row) * PART + DV]);
    float l = 0.f, a = 0.f;
    if (mx != -INFINITY)
      for (int s = 0; s < splits; ++s) {
        const float* sl = slots + ((size_t)s * H + row) * PART;
        const float f = exp2f(sl[DV] - mx);
        l = fmaf(f, sl[DV + 1], l);
        a = fmaf(f, sl[c], a);
      }
    out[((size_t)r * H + row) * DV + c] = __float2bfloat16(l > 0.f ? a / l : 0.f);
  }
}

// Key splits and the keys of each, a multiple of the tile.
void plan(int rows, int L, int t_val, bool t_on_device, int* splits, int* chunk) {
  const int kv = t_on_device ? L : std::max(0, std::min(L, t_val + 1));
  int s = std::min((TARGET_BLOCKS + rows - 1) / std::max(1, rows), (kv + KT - 1) / KT);
  s = std::max(1, std::min(s, MAX_SPLITS));
  *chunk = std::max(KT, ((kv + s - 1) / s + KT - 1) / KT * KT);
  *splits = std::max(1, (kv + *chunk - 1) / *chunk);
}

}  // namespace

void latent_decode_scratch(int rows, int L, int t_val, bool t_on_device,
                           int64_t* partial_floats) {
  int splits, chunk;
  plan(rows, L, t_val, t_on_device, &splits, &chunk);
  *partial_floats = splits > 1 ? (int64_t)rows * splits * H * PART : 0;
}

cudaError_t latent_decode_launch(const void* q, const void* cache, const int32_t* t_ptr,
                                 int t_val, void* out, float* partials, int rows, int L,
                                 float scale, cudaStream_t stream) {
  if (rows <= 0) return cudaSuccess;
  int splits, chunk;
  plan(rows, L, t_val, t_ptr != nullptr, &splits, &chunk);
  const int blocks = rows * splits;
  const size_t smem = SMEM_BYTES;
  const cudaError_t err = cudaFuncSetAttribute(
      latent_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  latent_decode_kernel<<<blocks, THREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)cache, t_ptr, t_val, (bf16*)out, partials, L,
      scale * LOG2E, splits, chunk);
  // a refused first launch stays the thread's last error for the caller's check
  if (splits > 1)
    latent_combine_kernel<<<rows, THREADS, 0, stream>>>(partials, (bf16*)out, splits);
  return cudaSuccess;
}
