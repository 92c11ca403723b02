// Launchers of the port's CUDA kernels, shared by the kernel sources and the
// binding (binding.cpp), so the compiler holds both to one signature. Each
// launcher enqueues its kernel on `stream` and does not synchronise; it
// returns the status of its set-up (cudaSuccess when there is none), and the
// caller checks the launch itself with cudaGetLastError(). The names have C
// linkage, so one source built alone into a shared library (nvcc -shared) can
// be driven through ctypes.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" {

// K1, decode_attention.cu. q (rows, nq, D), k and v (rows, L, D), out like q;
// bf16 when `bf16`, else fp32; D in {64, 128}, nq <= DECODE_MAX_NQ. t_ptr
// (device int32) overrides t_val when not null; an unbounded call passes
// L - 1. mask (uint8, rows / mask_div rows of L) may be null; cache row r
// reads mask row r / mask_div. `partials` (fp32) and `counters` (int32) are
// the sizes decode_attention_scratch gives for the same arguments (null when
// 0); the counters must be zero at the launch, and the launch leaves them so.
#define DECODE_MAX_NQ 256

void decode_attention_scratch(int rows, int nq, int L, int D, int t_val, bool t_on_device,
                              bool bf16, int64_t* partial_floats, int64_t* counters);

cudaError_t decode_attention_launch(const void* q, const void* k, const void* v,
                                    const uint8_t* mask, const int32_t* t_ptr, int t_val,
                                    void* out, float* partials, int* counters, int rows,
                                    int nq, int L, int D, int mask_div, float scale,
                                    bool bf16, cudaStream_t stream);

// K2 in fp32, flash_attention.cu. q, k, v and o (rows, L, D) contiguous,
// D in {48, 64, 96, 128}; lse (rows, L) fp32. mask as for K1 (null: none).
cudaError_t flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                                       const uint8_t* mask, void* o, float* lse,
                                       int rows, int L, int D, int mask_div,
                                       bool causal, float scale, cudaStream_t stream);

// K3 in fp32, flash_attention.cu. Inputs as K2's plus dout (like o); dq, dk,
// dv like q; delta (rows, L) fp32 scratch. Two launches: dq (which first
// computes delta from its own P and dP, so o is not read), then dk/dv. o
// stays in the signature the binding calls for both dtypes.
cudaError_t flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                       const void* o, const void* dout,
                                       const float* lse, const uint8_t* mask,
                                       float* delta, void* dq, void* dk, void* dv,
                                       int rows, int L, int D, int mask_div,
                                       bool causal, float scale, cudaStream_t stream);

// K2 and K3 in bf16 on the tensor cores, flash_attention_mma.cu. As the fp32
// launchers, but the bf16 tensors of a call share one strided layout: row
// block r = batch * heads + head starts at batch * batch_stride + head *
// head_stride elements and its L rows are row_stride apart (all multiples of
// 8). A contiguous (rows, L, D) tensor is heads = 1, batch_stride = L * D,
// head_stride = 0, row_stride = D. lse and delta are contiguous (rows, L).
cudaError_t flash_attention_mma_fwd_launch(const void* q, const void* k, const void* v,
                                           const uint8_t* mask, void* o, float* lse,
                                           int rows, int L, int D, int mask_div,
                                           bool causal, float scale, int heads,
                                           int64_t batch_stride, int64_t head_stride,
                                           int64_t row_stride, cudaStream_t stream);

cudaError_t flash_attention_mma_bwd_launch(const void* q, const void* k, const void* v,
                                           const void* o, const void* dout,
                                           const float* lse, const uint8_t* mask,
                                           float* delta, void* dq, void* dk, void* dv,
                                           int rows, int L, int D, int mask_div,
                                           bool causal, float scale, int heads,
                                           int64_t batch_stride, int64_t head_stride,
                                           int64_t row_stride, cudaStream_t stream);

// K4, vq_argmin.cu. z (n, d) and codebook (n_e, d) fp32, d <= 256 -> keys
// (n,) uint64 whose low 32 bits are the nearest code's index. The keys must
// hold all ones at the launch (a memset of 0xff).
cudaError_t vq_argmin_launch(const float* z, const float* codebook,
                             unsigned long long* keys, int n, int n_e, int d,
                             cudaStream_t stream);

}  // extern "C"
