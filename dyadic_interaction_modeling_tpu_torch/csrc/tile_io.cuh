// Element loads and stores of the decode attention kernels: 16-byte vector
// loads converted to fp32, and fp32 results stored in the tensor's dtype
// (fp32 or bf16). The kernels compute in fp32 whatever the storage type.

#pragma once

#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ void load_vec(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(h[i]);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

}  // namespace
