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

// K5, latent_decode.cu. q (rows, LATENT_HEADS, LATENT_DK) and the latent
// cache (rows, L, LATENT_DK), bf16, contiguous; out (rows, LATENT_HEADS,
// LATENT_DV) bf16: softmax(q c^T * scale) c[:, :LATENT_DV] over the cache
// positions <= t. t_ptr (device int32) overrides t_val when not null; an
// unbounded call passes L - 1. `partials` (fp32) is the size
// latent_decode_scratch gives for the same arguments (null when 0).
#define LATENT_HEADS 16
#define LATENT_DK 576
#define LATENT_DV 512

void latent_decode_scratch(int rows, int L, int t_val, bool t_on_device,
                           int64_t* partial_floats);

cudaError_t latent_decode_launch(const void* q, const void* cache, const int32_t* t_ptr,
                                 int t_val, void* out, float* partials, int rows, int L,
                                 float scale, cudaStream_t stream);

// K6, moe_route.cu: the expert layer's routing, dispatch and combine.
// moe_dispatch: logits (n, E) fp32 and x (n, H) bf16, contiguous, H a
// multiple of 8, E <= MOE_MAX_EXPERTS, 1 <= k <= min(MOE_MAX_K, E) -> w (n,
// k) fp32 and ids (n, k) int32 (the greedy top-k of the softmax, ties to the
// lower expert, slots by score), ends (E,) int32 (expert e's pairs end at
// ends[e]), pos (n, k) int32 (the pair's row in the routed order) and xs
// (n * k, H) bf16 (x's rows grouped by expert, token order within each);
// load (E,) int64 (null: none) gains each expert's count. `scratch` holds
// the ints moe_dispatch_scratch gives; `arrivals` one int, zero at the
// launch, which the launch leaves at zero.
// moe_combine: ys (n * k, H) bf16, w and pos as moe_dispatch gives them,
// shared (n, H) bf16 or null -> y (n, H) bf16.
#define MOE_MAX_EXPERTS 256
#define MOE_MAX_K 8

void moe_dispatch_scratch(int n, int E, int k, int64_t* ints);

cudaError_t moe_dispatch_launch(const float* logits, const void* x, int n, int E, int k, int H,
                                bool norm_topk, float scaling, float* w, int32_t* ids,
                                int32_t* ends, int32_t* pos, void* xs, long long* load,
                                int32_t* scratch, int* arrivals, cudaStream_t stream);

cudaError_t moe_combine_launch(const void* ys, const float* w, const int32_t* pos,
                               const void* shared, void* y, int n, int k, int H,
                               cudaStream_t stream);

}  // extern "C"
