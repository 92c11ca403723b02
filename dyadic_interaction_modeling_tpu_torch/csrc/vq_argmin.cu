// Nearest-codebook argmin for VQ tokenization (CUDA, sm_90a).
//
// Replaces the TPU kernel `pallas_nearest_code`
// (dyadic_interaction_modeling_tpu/ops/pallas/vq.py:49, body `_vq_kernel` :35,
// pallas_call :62).
//
// idx[n] = argmin_c ( |e_c|^2 - 2 z_n . e_c ), ties to the lowest c. |z_n|^2
// is constant per row and dropped, as in the TPU kernel. The (N, n_e)
// distance matrix is never written.
//
// Bound on the H100: operations. At the generate's shape (6400 latents x 512
// codes x 128 dims, fp32) the work is 0.84 GFLOP against 3.5 MB of inputs,
// ~240 FLOP per byte, far above fp32's ~20 FLOP/byte ridge on CUDA cores:
// 12.5 us at 67 TFLOP/s.
//
// Design: a register-tiled SGEMM with an argmin in place of its store.
// - A block takes BN = 128 latents x BC = 128 codes; each of its 256 threads
//   accumulates an 8 x 8 micro-tile of dot products in registers over d.
// - d streams through shared memory in chunks of DK = 16, k-major, double
//   buffered with cp.async, so a thread reads its 8 latents and 8 codes of
//   one k as four 16-byte loads for 64 FMAs.
// - |e|^2 is computed once per code and block, from the same chunks, by the
//   first BC threads.
// - The codebook is also split over blocks (6400 latents: 50 latent tiles
//   x 4 code tiles), and the splits merge exactly, whatever order they land
//   in: each thread takes the least (distance, index) key of its 8 codes, 16
//   threads reduce by shuffles, and one 64-bit atomicMin per latent merges
//   the code tiles. The key orders as torch.argmin: an order-preserving map
//   of the distance in the high word (NaN below every number, -0 as +0) and
//   the index in the low word, so a NaN latent gets code 0 and equal
//   distances go to the lower index. The keys start at all ones (a memset).
// fp32 FMAs on CUDA cores, no tensor cores and no TF32: exact fp32
// distances keep the indices equal to the plain version's away from
// near-ties.

#include <math.h>

#include "kernels.h"
#include "ptx_sm90.cuh"

namespace {

constexpr int TN = 8, TC = 8;     // a thread's latents and codes
constexpr int BN = 16 * TN;       // latents a block
constexpr int BC = 128;           // codes a block
constexpr int DK = 16;            // d a chunk
constexpr int THREADS = (BN / TN) * (BC / TC);  // 256
constexpr int ZP = BN + 4, EP = BC + 4;         // padded rows of the k-major chunks

struct Smem {
  float z[2][DK][ZP];
  float e[2][DK][EP];
  float e2[BC];
};

// (distance, index) as one key that orders as torch.argmin.
__device__ __forceinline__ unsigned long long argmin_key(float dist, int idx) {
  uint32_t u = __float_as_uint(dist);
  if (u == 0x80000000u) u = 0u;  // -0 orders as +0
  const uint32_t ord = isnan(dist) ? 0u : (u & 0x80000000u) ? ~u : u | 0x80000000u;
  return ((unsigned long long)ord << 32) | (uint32_t)idx;
}

// Starts the copy of d-chunk [k0, k0 + DK) of the block's latents and codes,
// transposed to k-major; what lies past n, n_e or d becomes zeros.
__device__ __forceinline__ void load_chunk(Smem& s, int stage, const float* __restrict__ z,
                                           const float* __restrict__ e, int n0, int c0,
                                           int k0, int n, int n_e, int d) {
  for (int i = threadIdx.x; i < BN * DK; i += THREADS) {
    const int row = i / DK, kk = i % DK;
    const bool valid = n0 + row < n && k0 + kk < d;
    cp_async_4(&s.z[stage][kk][row], z + (valid ? (size_t)(n0 + row) * d + k0 + kk : 0), valid);
  }
  for (int i = threadIdx.x; i < BC * DK; i += THREADS) {
    const int row = i / DK, kk = i % DK;
    const bool valid = c0 + row < n_e && k0 + kk < d;
    cp_async_4(&s.e[stage][kk][row], e + (valid ? (size_t)(c0 + row) * d + k0 + kk : 0), valid);
  }
}

__global__ void __launch_bounds__(THREADS)
vq_argmin_kernel(const float* __restrict__ z, const float* __restrict__ e,
                 unsigned long long* __restrict__ keys, int n, int n_e, int d) {
  extern __shared__ uint4 smem[];
  Smem& s = *reinterpret_cast<Smem*>(smem);
  const int tid = threadIdx.x;
  const int tx = tid % (BC / TC), ty = tid / (BC / TC);
  const int n0 = blockIdx.x * BN, c0 = blockIdx.y * BC;
  const int chunks = (d + DK - 1) / DK;

  load_chunk(s, 0, z, e, n0, c0, 0, n, n_e, d);
  cp_async_commit();
  float acc[TN][TC] = {};
  float sq = 0.f;  // |e|^2 of code tid, for the first BC threads
  for (int ch = 0; ch < chunks; ++ch) {
    if (ch + 1 < chunks) load_chunk(s, (ch + 1) & 1, z, e, n0, c0, (ch + 1) * DK, n, n_e, d);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int st = ch & 1;
    if (tid < BC)
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) sq = fmaf(s.e[st][kk][tid], s.e[st][kk][tid], sq);
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      float av[TN];
#pragma unroll
      for (int i = 0; i < TN; i += 4) {
        const float4 a = *reinterpret_cast<const float4*>(&s.z[st][kk][ty * TN + i]);
        av[i] = a.x, av[i + 1] = a.y, av[i + 2] = a.z, av[i + 3] = a.w;
      }
      const float4 b0 = *reinterpret_cast<const float4*>(&s.e[st][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&s.e[st][kk][BC / 2 + tx * 4]);
      const float bv[TC] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TN; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();  // this stage is read before the next copy into it
  }
  cp_async_wait<0>();
  if (tid < BC) s.e2[tid] = sq;
  __syncthreads();

#pragma unroll
  for (int i = 0; i < TN; ++i) {
    unsigned long long best = ~0ull;
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int c = j < 4 ? tx * 4 + j : BC / 2 + tx * 4 + j - 4;
      if (c0 + c < n_e) {
        const unsigned long long key = argmin_key(s.e2[c] - 2.f * acc[i][j], c0 + c);
        best = key < best ? key : best;
      }
    }
    // the 16 threads of a latent row are lanes 0-15 or 16-31 of one warp
#pragma unroll
    for (int off = 1; off < BC / TC; off <<= 1) {
      const unsigned long long other = __shfl_xor_sync(0xffffffffu, best, off);
      best = other < best ? other : best;
    }
    const int row = n0 + ty * TN + i;
    if (tx == 0 && row < n) atomicMin(keys + row, best);
  }
}

}  // namespace

cudaError_t vq_argmin_launch(const float* z, const float* codebook,
                             unsigned long long* keys, int n, int n_e, int d,
                             cudaStream_t stream) {
  const size_t smem = sizeof(Smem);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        vq_argmin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((n + BN - 1) / BN, (n_e + BC - 1) / BC);
  if (n > 0 && n_e > 0) vq_argmin_kernel<<<grid, THREADS, smem, stream>>>(z, codebook, keys, n, n_e, d);
  return cudaSuccess;
}
