// Single-step decode attention against a KV cache (CUDA, sm_90a).
//
// Replaces the TPU kernel `decode_attention`
// (dyadic_interaction_modeling_tpu/ops/pallas/decode.py:129, body `_kernel`
// :54).
//
// For each cache row r (batch x kv head): NQ query rows q[r] attend over the
// keys k[r, j], j <= t (all L keys when unbounded), optionally restricted by
// a key mask, and return softmax(q k^T * scale) v in q's dtype. A row whose
// keys are all masked returns 0. Key blocks past t are never read.
//
// Bound on the H100: bytes. Each launch reads the live K/V prefix once and
// does ~2 FLOP per byte read per query row (NQ <= 40 here), far below the
// card's ridge. Design: one thread block per cache row; key/value blocks of
// BK keys are staged once in shared memory (16-byte vector loads, converted
// to fp32) and serve all NQ query rows; the softmax runs online over the
// blocks with an fp32 running max, denominator and accumulator; the loop
// stops at the last block holding a key <= t, so the bytes read follow the
// live prefix. The step index t is read from device memory when given as a
// tensor, so a decode loop needs no host sync. Split-K, TMA and wgmma are
// later work.

#include <cuda_bf16.h>
#include <math.h>

#include "kernels.h"
#include "tile_io.cuh"

namespace {

constexpr int BK = 32;          // keys per shared-memory block
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const uint8_t* __restrict__ mask,
                        const int32_t* __restrict__ t_ptr, int t_val,
                        T* __restrict__ out, int nq, int L, int D, int mask_div,
                        float scale) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ float smem[];
  const int dp = D + 1;
  float* Ks = smem;               // BK x (D + 1), padded against bank conflicts
  float* Vs = Ks + BK * dp;       // BK x D
  float* Qs = Vs + BK * D;        // nq x D
  float* S = Qs + nq * D;         // nq x BK scores, then probabilities
  float* acc = S + nq * BK;       // nq x D
  float* m = acc + nq * D;        // nq running max
  float* lsum = m + nq;           // nq running denominator
  float* alpha = lsum + nq;       // nq rescale of the previous blocks

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int t = t_ptr ? *t_ptr : t_val;
  const int kv_len = min(L, t + 1);  // keys [0, kv_len) are live

  const T* kr = k + (size_t)r * L * D;
  const T* vr = v + (size_t)r * L * D;
  const uint8_t* mr = mask ? mask + (size_t)(r / mask_div) * L : nullptr;

  for (int i = tid; i < nq * D; i += THREADS) {
    Qs[i] = to_float(q[(size_t)r * nq * D + i]);
    acc[i] = 0.f;
  }
  for (int i = tid; i < nq; i += THREADS) {
    m[i] = -INFINITY;
    lsum[i] = 0.f;
  }

  for (int j0 = 0; j0 < kv_len; j0 += BK) {
    const int nk = min(BK, kv_len - j0);
    __syncthreads();  // previous block's Vs and S are consumed
    for (int e = tid * VEC; e < nk * D; e += THREADS * VEC) {
      const int row = e / D, col = e % D;
      float kv[VEC], vv[VEC];
      load_vec(kr + (size_t)j0 * D + e, kv);
      load_vec(vr + (size_t)j0 * D + e, vv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        Ks[row * dp + col + i] = kv[i];
        Vs[row * D + col + i] = vv[i];
      }
    }
    __syncthreads();
    for (int p = tid; p < nq * BK; p += THREADS) {
      const int i = p / BK, j = p % BK;
      float s = -INFINITY;
      if (j < nk && (mr == nullptr || mr[j0 + j])) {
        const float* qi = Qs + i * D;
        const float* kj = Ks + j * dp;
        float dot = 0.f;
        for (int c = 0; c < D; ++c) dot = fmaf(qi[c], kj[c], dot);
        s = dot * scale;
      }
      S[p] = s;
    }
    __syncthreads();
    for (int i = warp; i < nq; i += WARPS) {
      float* si = S + i * BK;
      float mx = -INFINITY;
      for (int j = lane; j < BK; j += 32) mx = fmaxf(mx, si[j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m[i];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < BK; j += 32) {
        const float s = si[j];
        const float pj = (s == -INFINITY) ? 0.f : expf(s - m_new);
        si[j] = pj;
        sum += pj;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float a = (m_old == -INFINITY) ? 0.f : expf(m_old - m_new);
        alpha[i] = a;
        lsum[i] = lsum[i] * a + sum;
        m[i] = m_new;
      }
    }
    __syncthreads();
    for (int p = tid; p < nq * D; p += THREADS) {
      const int i = p / D, c = p % D;
      const float* pi = S + i * BK;
      float a = acc[p] * alpha[i];
      for (int j = 0; j < nk; ++j) a = fmaf(pi[j], Vs[j * D + c], a);
      acc[p] = a;
    }
  }
  __syncthreads();
  for (int p = tid; p < nq * D; p += THREADS) {
    const float l = lsum[p / D];
    store(out + (size_t)r * nq * D + p, l > 0.f ? acc[p] / l : 0.f);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const uint8_t* mask,
                   const int32_t* t_ptr, int t_val, void* out, int rows, int nq,
                   int L, int D, int mask_div, float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)BK * (D + 1) + (size_t)BK * D + 2 * (size_t)nq * D
                       + (size_t)nq * BK + 3 * (size_t)nq);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  if (rows > 0) {
    decode_attention_kernel<T><<<rows, THREADS, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, mask, t_ptr, t_val, (T*)out, nq, L,
        D, mask_div, scale);
  }
  return cudaSuccess;
}

}  // namespace

cudaError_t decode_attention_launch(const void* q, const void* k, const void* v,
                                    const uint8_t* mask, const int32_t* t_ptr,
                                    int t_val, void* out, int rows, int nq, int L,
                                    int D, int mask_div, float scale, bool bf16,
                                    cudaStream_t stream) {
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, mask, t_ptr, t_val, out, rows, nq, L, D,
                                 mask_div, scale, stream);
  return launch<float>(q, k, v, mask, t_ptr, t_val, out, rows, nq, L, D, mask_div,
                       scale, stream);
}
