// Nearest-codebook argmin for VQ tokenization (CUDA, sm_90a).
//
// Replaces the TPU kernel `pallas_nearest_code`
// (dyadic_interaction_modeling_tpu/ops/pallas/vq.py:49, body `_vq_kernel` :35).
//
// idx[n] = argmin_c ( |e_c|^2 - 2 z_n . e_c ), ties to the lowest c. |z_n|^2
// is constant per row and dropped, as in the TPU kernel. The (N, n_e)
// distance matrix is never written.
//
// Bound on the H100: operations. At the slice's shape (6400 latents x 512
// codes x 128 dims, fp32) the work is 0.84 GFLOP against 3.5 MB of inputs,
// ~240 FLOP per byte, far above fp32's ~20 FLOP/byte ridge on CUDA cores.
// Design: one block per tile of TN latents, held in shared memory; the
// codebook streams through shared memory TC codes at a time with each
// code's |e|^2 computed once per tile; each thread keeps a running
// (distance, index) minimum in registers for one latent over a strided
// slice of codes; the SL threads of a latent then reduce with warp
// shuffles. Padded shared-memory rows (D + 1) keep the reads conflict-free.
// fp32 FMAs on CUDA cores, no tensor cores: exact fp32 distances keep the
// indices equal to the plain version's away from near-ties. The order is
// torch.argmin's: a NaN distance comes before every number (a NaN latent
// gets code 0), equal distances go to the lower index.

#include <limits.h>
#include <math.h>

#include "kernels.h"

namespace {

constexpr int TN = 32;            // latents per block
constexpr int SL = 8;             // threads per latent
constexpr int TC = 32;            // codes per shared-memory tile
constexpr int THREADS = TN * SL;  // 256

// (a, ai) comes before (b, bi) in torch.argmin's order
__device__ __forceinline__ bool before(float a, int ai, float b, int bi) {
  const bool an = isnan(a), bn = isnan(b);
  if (an || bn) return an && (!bn || ai < bi);
  return a < b || (a == b && ai < bi);
}

__global__ void __launch_bounds__(THREADS)
vq_argmin_kernel(const float* __restrict__ z, const float* __restrict__ e,
                 int32_t* __restrict__ idx, int n, int n_e, int d) {
  extern __shared__ float smem[];
  const int dp = d + 1;
  float* zs = smem;            // TN x dp
  float* es = zs + TN * dp;    // TC x dp
  float* e2 = es + TC * dp;    // TC

  const int tid = threadIdx.x;
  const int li = tid / SL;     // latent within the tile
  const int sl = tid % SL;     // code slice
  const int n0 = blockIdx.x * TN;

  for (int i = tid; i < TN * d; i += THREADS) {
    const int r = i / d, c = i % d;
    zs[r * dp + c] = (n0 + r < n) ? z[(size_t)(n0 + r) * d + c] : 0.f;
  }

  float best = INFINITY;  // (INFINITY, INT_MAX) comes after every code
  int best_i = INT_MAX;
  for (int c0 = 0; c0 < n_e; c0 += TC) {
    const int nc = min(TC, n_e - c0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = tid; i < nc * d; i += THREADS) {
      const int r = i / d, c = i % d;
      es[r * dp + c] = e[(size_t)(c0 + r) * d + c];
    }
    __syncthreads();
    if (tid < nc) {
      float s = 0.f;
      for (int c = 0; c < d; ++c) s = fmaf(es[tid * dp + c], es[tid * dp + c], s);
      e2[tid] = s;
    }
    __syncthreads();
    const float* zr = zs + li * dp;
    for (int cc = sl; cc < nc; cc += SL) {
      const float* er = es + cc * dp;
      float dot = 0.f;
      for (int c = 0; c < d; ++c) dot = fmaf(zr[c], er[c], dot);
      const float dist = e2[cc] - 2.f * dot;
      if (before(dist, c0 + cc, best, best_i)) {
        best = dist;
        best_i = c0 + cc;
      }
    }
  }
  // reduce over the SL consecutive lanes that share a latent
  for (int off = SL / 2; off > 0; off >>= 1) {
    const float ob = __shfl_down_sync(0xffffffffu, best, off, SL);
    const int oi = __shfl_down_sync(0xffffffffu, best_i, off, SL);
    if (before(ob, oi, best, best_i)) {
      best = ob;
      best_i = oi;
    }
  }
  if (sl == 0 && n0 + li < n) idx[n0 + li] = best_i;
}

}  // namespace

cudaError_t vq_argmin_launch(const float* z, const float* codebook, int32_t* idx,
                             int n, int n_e, int d, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)(TN + TC) * (d + 1) + TC);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        vq_argmin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int grid = (n + TN - 1) / TN;
  if (grid > 0) {
    vq_argmin_kernel<<<grid, THREADS, smem, stream>>>(z, codebook, idx, n, n_e, d);
  }
  return cudaSuccess;
}
