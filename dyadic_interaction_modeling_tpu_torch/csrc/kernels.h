// Launchers of the port's CUDA kernels, shared by the kernel sources and the
// binding (binding.cpp), so the compiler holds both to one signature. Each
// launcher enqueues its kernel on `stream` and does not synchronise; it
// returns the status of its set-up (cudaSuccess when there is none), and the
// caller checks the launch itself with cudaGetLastError().

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// K1, decode_attention.cu. q (rows, nq, D), k and v (rows, L, D), out like q;
// bf16 when `bf16`, else fp32. t_ptr (device int32) overrides t_val when not
// null; an unbounded call passes L - 1. mask (uint8, rows / mask_div rows of
// L) may be null; cache row r reads mask row r / mask_div.
cudaError_t decode_attention_launch(const void* q, const void* k, const void* v,
                                    const uint8_t* mask, const int32_t* t_ptr,
                                    int t_val, void* out, int rows, int nq, int L,
                                    int D, int mask_div, float scale, bool bf16,
                                    cudaStream_t stream);

// K4, vq_argmin.cu. z (n, d) and codebook (n_e, d) fp32 -> idx (n,) int32.
cudaError_t vq_argmin_launch(const float* z, const float* codebook, int32_t* idx,
                             int n, int n_e, int d, cudaStream_t stream);
