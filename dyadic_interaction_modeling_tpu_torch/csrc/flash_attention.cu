// Flash attention in fp32 on the CUDA cores, forward (K2) and backward (K3),
// for Hopper (sm_90a). bf16 inputs take the tensor-core kernels of
// flash_attention_mma.cu; the binding picks by dtype.
//
// Replaces the TPU kernels of dyadic_interaction_modeling_tpu/ops/pallas/
// attention.py: `_fwd` (:111, body `_fwd_kernel` :47) and `_bwd` (:152, body
// `_bwd_kernel` :70), the custom VJP of `flash_attention` (:194-210).
//
// Rows r = batch x head of (R, L, D) q, k, v, D in {48, 64, 128}, fp32. The
// forward computes o = softmax(q k^T * scale) v under an optional causal
// mask and a key mask (uint8, row r reads mask row r / mask_div) and saves
// the row log-sum-exp in fp32. A query row whose keys are all masked gets
// o = 0 and lse = +inf, so the backward turns its probabilities into exactly
// 0 and its gradients are 0 (the dense path's rule; the Pallas kernel's
// finite -1e30 mask returns the mean of v there instead).
//
// Bound on the H100: operations (67 TFLOP/s of fp32 FMAs), since TF32 on the
// tensor cores would not keep the 1e-5 agreement with the plain version that
// the fp32 path exists for. The kernels are templates over the element type
// and are instantiated for float alone.
//
// Design. Tiles of 64 query rows and 64 keys are staged in shared memory as
// fp32 (rows padded to D + 1 floats against bank conflicts); 256 threads form
// a 16 x 16 grid and each owns a 4 x 4 register tile of the 64 x 64 score
// tile (rows ty + 16 i, keys tx + 16 j) and 4 x D/16 outputs (rows ty + 16 i,
// columns tx + 16 c). A ragged tail is masked in the kernel; the inputs are
// never padded.
//
// * Forward: one block per (row, query tile) loops over key tiles with an
//   fp32 online softmax (running max, denominator, accumulator; one thread
//   per query row rescales). Key tiles wholly above the diagonal are skipped
//   when causal.
// * Backward: the TPU kernel carried dk/dv across a sequential query-tile
//   grid in one resident block; Hopper blocks run in parallel with nothing
//   carried between them. So two deterministic passes, no atomics, both
//   recomputing P = exp(s - lse) from the saved lse:
//   - dq: one block per (row, query tile) loops over key tiles; it first
//     computes delta = rowsum(do * o) of its rows and writes it out;
//   - dk/dv: one block per (row, key tile) loops over the query tiles at or
//     below the diagonal, reading that delta.

#include <cuda_bf16.h>
#include <math.h>

#include "kernels.h"
#include "tile_io.cuh"

namespace {

constexpr int TILE = 64;       // query rows and keys per tile
constexpr int THREADS = 256;   // a 16 x 16 grid of 4 x 4 register tiles
constexpr int SLD = TILE + 1;  // row stride of a score tile in shared memory

// Rows [0, n) of a (., D) matrix into shared memory as fp32 rows of stride
// D + 1; rows [n, TILE) are zero, so masked tails multiply as 0.
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int n,
                                          float* __restrict__ dst) {
  constexpr int VEC = 16 / sizeof(T);
  for (int e = threadIdx.x * VEC; e < TILE * D; e += THREADS * VEC) {
    const int row = e / D, col = e % D;
    float x[VEC];
    if (row < n) {
      load_vec(src + (size_t)row * D + col, x);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) x[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) dst[row * (D + 1) + col + i] = x[i];
  }
}

// s[i][j] += a[row i] . b[row j] over D for the thread's 4 x 4 tile.
template <int D>
__device__ __forceinline__ void tile_dot(const float* __restrict__ a,
                                         const float* __restrict__ b, int ty,
                                         int tx, float (&s)[4][4]) {
  constexpr int LD = D + 1;
#pragma unroll 8
  for (int c = 0; c < D; ++c) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = a[(ty + 16 * i) * LD + c];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = b[(tx + 16 * j) * LD + c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(x[i], y[j], s[i][j]);
  }
}

// Whether query `qi` attends key `kj` (both absolute) of a row.
__device__ __forceinline__ bool attends(int qi, int kj, int L,
                                        const uint8_t* __restrict__ mr,
                                        bool causal) {
  return kj < L && (mr == nullptr || mr[kj] != 0) && (!causal || kj <= qi);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const uint8_t* __restrict__ mask,
                 T* __restrict__ o, float* __restrict__ lse, int L, int mask_div,
                 bool causal, float scale) {
  constexpr int LD = D + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                 // TILE x LD
  float* Ks = Qs + TILE * LD;       // TILE x LD
  float* Vs = Ks + TILE * LD;       // TILE x LD
  float* S = Vs + TILE * LD;        // TILE x SLD scores, then probabilities
  float* row_m = S + TILE * SLD;    // running max
  float* row_l = row_m + TILE;      // running denominator
  float* row_a = row_l + TILE;      // rescale of the earlier key tiles

  const int r = blockIdx.y, q0 = blockIdx.x * TILE;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t base = (size_t)r * L * D;
  const uint8_t* mr = mask ? mask + (size_t)(r / mask_div) * L : nullptr;

  load_tile<T, D>(q + base + (size_t)q0 * D, min(TILE, L - q0), Qs);
  if (tid < TILE) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.f;
  }
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  const int k_end = causal ? min(L, q0 + TILE) : L;
  for (int k0 = 0; k0 < k_end; k0 += TILE) {
    const int nk = min(TILE, L - k0);
    __syncthreads();  // the previous tile's K, V and P are consumed
    load_tile<T, D>(k + base + (size_t)k0 * D, nk, Ks);
    load_tile<T, D>(v + base + (size_t)k0 * D, nk, Vs);
    __syncthreads();
    float s[4][4] = {};
    tile_dot<D>(Qs, Ks, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = ty + 16 * i, kj = tx + 16 * j;
        S[qi * SLD + kj] =
            attends(q0 + qi, k0 + kj, L, mr, causal) ? s[i][j] * scale : -INFINITY;
      }
    __syncthreads();
    if (tid < TILE) {  // online softmax, one thread per query row
      float* si = S + tid * SLD;
      float mx = -INFINITY;
      for (int j = 0; j < TILE; ++j) mx = fmaxf(mx, si[j]);
      const float m_old = row_m[tid];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = 0; j < TILE; ++j) {
        const float p = si[j] == -INFINITY ? 0.f : expf(si[j] - m_new);
        sum += p;
        si[j] = round_as(p, v);
      }
      const float a = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
      row_a[tid] = a;
      row_l[tid] = row_l[tid] * a + sum;
      row_m[tid] = m_new;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = row_a[ty + 16 * i];
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= a;
    }
    for (int j = 0; j < nk; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = S[(ty + 16 * i) * SLD + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = Vs[j * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = ty + 16 * i;
    if (q0 + qi >= L) continue;
    const float l = row_l[qi];
    const float inv = l > 0.f ? 1.f / l : 0.f;
    T* orow = o + base + (size_t)(q0 + qi) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) store(orow + tx + 16 * c, acc[i][c] * inv);
    if (tx == 0) lse[(size_t)r * L + q0 + qi] = l > 0.f ? row_m[qi] + logf(l) : INFINITY;
  }
}

// Loads the saved lse (and, when `delta` is given, delta) of the query tile
// at q0; rows past L get lse = +inf, so their probabilities are 0.
__device__ __forceinline__ void load_rows(const float* __restrict__ lse,
                                          const float* __restrict__ delta,
                                          size_t row0, int n, float* row_lse,
                                          float* row_delta) {
  const int t = threadIdx.x;
  if (t < TILE) {
    row_lse[t] = t < n ? lse[row0 + t] : INFINITY;
    if (delta) row_delta[t] = t < n ? delta[row0 + t] : 0.f;
  }
}

// P and dS of the thread's 4 x 4 tile, from the scores s and dp = do . v:
// p = exp(s * scale - lse), ds = p * (dp - delta) * scale.
__device__ __forceinline__ void probs_and_grads(
    const float (&s)[4][4], const float (&dp)[4][4], int q0, int k0, int ty,
    int tx, int L, const uint8_t* __restrict__ mr, bool causal, float scale,
    const float* row_lse, const float* row_delta, float (&p)[4][4],
    float (&ds)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qi = ty + 16 * i, kj = tx + 16 * j;
      const bool keep = q0 + qi < L && attends(q0 + qi, k0 + kj, L, mr, causal);
      p[i][j] = keep ? expf(s[i][j] * scale - row_lse[qi]) : 0.f;
      ds[i][j] = p[i][j] * (dp[i][j] - row_delta[qi]) * scale;
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const uint8_t* __restrict__ mask, float* __restrict__ delta,
                    T* __restrict__ dq, int L, int mask_div, bool causal,
                    float scale) {
  constexpr int LD = D + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                 // TILE x LD
  float* dOs = Qs + TILE * LD;      // TILE x LD
  float* Ks = dOs + TILE * LD;      // TILE x LD (o of the query tile first)
  float* Vs = Ks + TILE * LD;       // TILE x LD
  float* dS = Vs + TILE * LD;       // TILE x SLD
  float* row_lse = dS + TILE * SLD;
  float* row_delta = row_lse + TILE;

  const int r = blockIdx.y, q0 = blockIdx.x * TILE;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t base = (size_t)r * L * D;
  const uint8_t* mr = mask ? mask + (size_t)(r / mask_div) * L : nullptr;
  const int nq = min(TILE, L - q0);

  load_tile<T, D>(q + base + (size_t)q0 * D, nq, Qs);
  load_tile<T, D>(dout + base + (size_t)q0 * D, nq, dOs);
  load_tile<T, D>(o + base + (size_t)q0 * D, nq, Ks);
  load_rows(lse, nullptr, (size_t)r * L + q0, nq, row_lse, nullptr);
  __syncthreads();
  if (tid < TILE) {  // delta = rowsum(do * o), for this pass and the dk/dv one
    float d = 0.f;
    for (int c = 0; c < D; ++c) d = fmaf(dOs[tid * LD + c], Ks[tid * LD + c], d);
    row_delta[tid] = d;
    if (tid < nq) delta[(size_t)r * L + q0 + tid] = d;
  }
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  const int k_end = causal ? min(L, q0 + TILE) : L;
  for (int k0 = 0; k0 < k_end; k0 += TILE) {
    const int nk = min(TILE, L - k0);
    __syncthreads();  // o, or the previous K and dS, are consumed
    load_tile<T, D>(k + base + (size_t)k0 * D, nk, Ks);
    load_tile<T, D>(v + base + (size_t)k0 * D, nk, Vs);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {}, p[4][4], ds[4][4];
    tile_dot<D>(Qs, Ks, ty, tx, s);
    tile_dot<D>(dOs, Vs, ty, tx, dp);
    probs_and_grads(s, dp, q0, k0, ty, tx, L, mr, causal, scale, row_lse,
                    row_delta, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dS[(ty + 16 * i) * SLD + tx + 16 * j] = ds[i][j];
    __syncthreads();
    for (int j = 0; j < nk; ++j) {  // dq += dS K
      float g[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) g[i] = dS[(ty + 16 * i) * SLD + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kk = Ks[j * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(g[i], kk, acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = ty + 16 * i;
    if (qi >= nq) continue;
    T* row = dq + base + (size_t)(q0 + qi) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) store(row + tx + 16 * c, acc[i][c]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      const uint8_t* __restrict__ mask, T* __restrict__ dk,
                      T* __restrict__ dv, int L, int mask_div, bool causal,
                      float scale) {
  constexpr int LD = D + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;                 // TILE x LD
  float* Vs = Ks + TILE * LD;       // TILE x LD
  float* Qs = Vs + TILE * LD;       // TILE x LD
  float* dOs = Qs + TILE * LD;      // TILE x LD
  float* P = dOs + TILE * LD;       // TILE x SLD, [query][key]
  float* dS = P + TILE * SLD;       // TILE x SLD, [query][key]
  float* row_lse = dS + TILE * SLD;
  float* row_delta = row_lse + TILE;

  const int r = blockIdx.y, k0 = blockIdx.x * TILE;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t base = (size_t)r * L * D;
  const uint8_t* mr = mask ? mask + (size_t)(r / mask_div) * L : nullptr;
  const int nk = min(TILE, L - k0);

  load_tile<T, D>(k + base + (size_t)k0 * D, nk, Ks);
  load_tile<T, D>(v + base + (size_t)k0 * D, nk, Vs);
  // thread (ty, tx) accumulates keys ty + 16 i, columns tx + 16 c
  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // causal: queries below k0 attend none of these keys
  for (int q0 = causal ? k0 : 0; q0 < L; q0 += TILE) {
    const int nq = min(TILE, L - q0);
    __syncthreads();  // the previous query tile, P and dS are consumed
    load_tile<T, D>(q + base + (size_t)q0 * D, nq, Qs);
    load_tile<T, D>(dout + base + (size_t)q0 * D, nq, dOs);
    load_rows(lse, delta, (size_t)r * L + q0, nq, row_lse, row_delta);
    __syncthreads();
    // the thread's 4 x 4 tile of (query ty + 16 i, key tx + 16 j)
    float s[4][4] = {}, dp[4][4] = {}, p[4][4], ds[4][4];
    tile_dot<D>(Qs, Ks, ty, tx, s);
    tile_dot<D>(dOs, Vs, ty, tx, dp);
    probs_and_grads(s, dp, q0, k0, ty, tx, L, mr, causal, scale, row_lse,
                    row_delta, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        P[(ty + 16 * i) * SLD + tx + 16 * j] = p[i][j];
        dS[(ty + 16 * i) * SLD + tx + 16 * j] = ds[i][j];
      }
    __syncthreads();
    for (int qi = 0; qi < nq; ++qi) {  // dv += P^T dO, dk += dS^T Q
      float pk[4], gk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pk[i] = P[qi * SLD + ty + 16 * i];
        gk[i] = dS[qi * SLD + ty + 16 * i];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float g = dOs[qi * LD + tx + 16 * c];
        const float x = Qs[qi * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv_acc[i][c] = fmaf(pk[i], g, dv_acc[i][c]);
          dk_acc[i][c] = fmaf(gk[i], x, dk_acc[i][c]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = ty + 16 * i;
    if (kj >= nk) continue;
    T* krow = dk + base + (size_t)(k0 + kj) * D;
    T* vrow = dv + base + (size_t)(k0 + kj) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      store(krow + tx + 16 * c, dk_acc[i][c]);
      store(vrow + tx + 16 * c, dv_acc[i][c]);
    }
  }
}

constexpr size_t tile_floats(int D) { return (size_t)TILE * (D + 1); }

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, const uint8_t* mask,
                void* o, float* lse, int rows, int L, int mask_div, bool causal,
                float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (3 * tile_floats(D) + TILE * SLD + 3 * TILE);
  const cudaError_t err = allow_smem(flash_fwd_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + TILE - 1) / TILE, rows);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, mask, (T*)o, lse, L, mask_div, causal,
      scale);
  return cudaSuccess;
}

template <typename T, int D>
cudaError_t bwd(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, const uint8_t* mask,
                float* delta, void* dq, void* dk, void* dv, int rows, int L,
                int mask_div, bool causal, float scale, cudaStream_t stream) {
  const size_t smem_dq = sizeof(float) * (4 * tile_floats(D) + TILE * SLD + 2 * TILE);
  const size_t smem_dkdv =
      sizeof(float) * (4 * tile_floats(D) + 2 * TILE * SLD + 2 * TILE);
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<T, D>, smem_dq);
  if (err == cudaSuccess) err = allow_smem(flash_bwd_dkdv_kernel<T, D>, smem_dkdv);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + TILE - 1) / TILE, rows);
  flash_bwd_dq_kernel<T, D><<<grid, THREADS, smem_dq, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)o, (const T*)dout, lse, mask,
      delta, (T*)dq, L, mask_div, causal, scale);
  // reads the delta the dq pass wrote: same stream, so it runs after it
  flash_bwd_dkdv_kernel<T, D><<<grid, THREADS, smem_dkdv, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, mask,
      (T*)dk, (T*)dv, L, mask_div, causal, scale);
  return cudaSuccess;
}

}  // namespace

cudaError_t flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                                       const uint8_t* mask, void* o, float* lse,
                                       int rows, int L, int D, int mask_div,
                                       bool causal, float scale, cudaStream_t stream) {
  if (rows == 0 || L == 0) return cudaSuccess;
  if (D == 48)
    return fwd<float, 48>(q, k, v, mask, o, lse, rows, L, mask_div, causal, scale, stream);
  if (D == 64)
    return fwd<float, 64>(q, k, v, mask, o, lse, rows, L, mask_div, causal, scale, stream);
  if (D == 128)
    return fwd<float, 128>(q, k, v, mask, o, lse, rows, L, mask_div, causal, scale, stream);
  return cudaErrorInvalidValue;
}

cudaError_t flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                       const void* o, const void* dout,
                                       const float* lse, const uint8_t* mask,
                                       float* delta, void* dq, void* dk, void* dv,
                                       int rows, int L, int D, int mask_div,
                                       bool causal, float scale, cudaStream_t stream) {
  if (rows == 0 || L == 0) return cudaSuccess;
  if (D == 48)
    return bwd<float, 48>(q, k, v, o, dout, lse, mask, delta, dq, dk, dv, rows, L,
                          mask_div, causal, scale, stream);
  if (D == 64)
    return bwd<float, 64>(q, k, v, o, dout, lse, mask, delta, dq, dk, dv, rows, L,
                          mask_div, causal, scale, stream);
  if (D == 128)
    return bwd<float, 128>(q, k, v, o, dout, lse, mask, delta, dq, dk, dv, rows, L,
                           mask_div, causal, scale, stream);
  return cudaErrorInvalidValue;
}
