// Python binding of the port's CUDA kernels: the one source that includes
// PyTorch's headers (they take the bulk of the build time). Its callers, the
// wrappers in kernels/decode.py, kernels/attention.py and kernels/vq.py,
// check device, dtype, shape and contiguity and raise on what a kernel does
// not take. Each function here allocates its outputs (and scratch), launches
// on PyTorch's current stream of the input's device and checks the launch.

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <torch/extension.h>

#include "kernels.h"

namespace {

// A key mask of (rows / m, L): its pointer (null when absent) and m.
const uint8_t* mask_ptr(const c10::optional<torch::Tensor>& key_mask) {
  return key_mask ? static_cast<const uint8_t*>(key_mask->data_ptr()) : nullptr;
}

int mask_div(const torch::Tensor& q, const c10::optional<torch::Tensor>& key_mask) {
  return key_mask ? (int)(q.size(0) / key_mask->size(0)) : 1;
}

// K2 and K3 have two sets of kernels, and this is where a call takes one:
// bf16 the tensor-core kernels (flash_attention_mma.cu), fp32 the exact
// CUDA-core kernels (flash_attention.cu).
bool takes_mma(const torch::Tensor& q) { return q.scalar_type() == torch::kBFloat16; }

torch::Tensor decode_attention(const torch::Tensor& q, const torch::Tensor& k,
                               const torch::Tensor& v,
                               const c10::optional<torch::Tensor>& key_mask,
                               const c10::optional<torch::Tensor>& t, int64_t t_val,
                               double scale) {
  const c10::cuda::CUDAGuard guard(q.device());
  auto out = torch::empty_like(q);
  C10_CUDA_CHECK(decode_attention_launch(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr(key_mask),
      t ? t->data_ptr<int32_t>() : nullptr, (int)t_val, out.data_ptr(), (int)q.size(0),
      (int)q.size(1), (int)k.size(1), (int)q.size(2), mask_div(q, key_mask),
      (float)scale, q.scalar_type() == torch::kBFloat16,
      at::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return out;
}

std::vector<torch::Tensor> flash_attention_fwd(const torch::Tensor& q,
                                               const torch::Tensor& k,
                                               const torch::Tensor& v,
                                               const c10::optional<torch::Tensor>& key_mask,
                                               bool causal, double scale) {
  const c10::cuda::CUDAGuard guard(q.device());
  auto o = torch::empty_like(q);
  auto lse = torch::empty({q.size(0), q.size(1)}, q.options().dtype(torch::kFloat));
  const int rows = (int)q.size(0), L = (int)q.size(1), D = (int)q.size(2);
  const auto stream = at::cuda::getCurrentCUDAStream();
  if (takes_mma(q))  // contiguous (rows, L, D): one head a row block
    C10_CUDA_CHECK(flash_attention_mma_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr(key_mask), o.data_ptr(),
        lse.data_ptr<float>(), rows, L, D, mask_div(q, key_mask), causal, (float)scale,
        /*heads=*/1, /*batch_stride=*/(int64_t)L * D, /*head_stride=*/0,
        /*row_stride=*/D, stream));
  else
    C10_CUDA_CHECK(flash_attention_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr(key_mask), o.data_ptr(),
        lse.data_ptr<float>(), rows, L, D, mask_div(q, key_mask), causal, (float)scale,
        stream));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return {o, lse};
}

std::vector<torch::Tensor> flash_attention_bwd(
    const torch::Tensor& q, const torch::Tensor& k, const torch::Tensor& v,
    const torch::Tensor& o, const torch::Tensor& dout, const torch::Tensor& lse,
    const c10::optional<torch::Tensor>& key_mask, bool causal, double scale) {
  const c10::cuda::CUDAGuard guard(q.device());
  auto dq = torch::empty_like(q);
  auto dk = torch::empty_like(k);
  auto dv = torch::empty_like(v);
  auto delta = torch::empty_like(lse);
  const int rows = (int)q.size(0), L = (int)q.size(1), D = (int)q.size(2);
  const auto stream = at::cuda::getCurrentCUDAStream();
  if (takes_mma(q))
    C10_CUDA_CHECK(flash_attention_mma_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), dout.data_ptr(),
        lse.data_ptr<float>(), mask_ptr(key_mask), delta.data_ptr<float>(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), rows, L, D, mask_div(q, key_mask),
        causal, (float)scale, /*heads=*/1, /*batch_stride=*/(int64_t)L * D,
        /*head_stride=*/0, /*row_stride=*/D, stream));
  else
    C10_CUDA_CHECK(flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), dout.data_ptr(),
        lse.data_ptr<float>(), mask_ptr(key_mask), delta.data_ptr<float>(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), rows, L, D, mask_div(q, key_mask),
        causal, (float)scale, stream));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return {dq, dk, dv};
}

torch::Tensor vq_argmin(const torch::Tensor& z, const torch::Tensor& codebook) {
  const c10::cuda::CUDAGuard guard(z.device());
  auto idx = torch::empty({z.size(0)}, z.options().dtype(torch::kInt));
  C10_CUDA_CHECK(vq_argmin_launch(z.data_ptr<float>(), codebook.data_ptr<float>(),
                                  idx.data_ptr<int32_t>(), (int)z.size(0),
                                  (int)codebook.size(0), (int)z.size(1),
                                  at::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return idx;
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("decode_attention", &decode_attention, "K1: one decode attention step");
  m.def("flash_attention_fwd", &flash_attention_fwd, "K2: flash attention forward");
  m.def("flash_attention_bwd", &flash_attention_bwd, "K3: flash attention backward");
  m.def("vq_argmin", &vq_argmin, "K4: nearest-codebook argmin");
}
