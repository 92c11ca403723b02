// Python binding of the port's CUDA kernels: the one source that includes
// PyTorch's headers (they take the bulk of the build time). Its callers, the
// wrappers in kernels/decode.py and kernels/vq.py, check device, dtype, shape
// and contiguity and raise on what a kernel does not take. Each function
// here allocates its output, launches on PyTorch's current stream of the
// input's device and checks the launch.

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <torch/extension.h>

#include "kernels.h"

namespace {

torch::Tensor decode_attention(const torch::Tensor& q, const torch::Tensor& k,
                               const torch::Tensor& v,
                               const c10::optional<torch::Tensor>& key_mask,
                               const c10::optional<torch::Tensor>& t, int64_t t_val,
                               double scale) {
  const c10::cuda::CUDAGuard guard(q.device());
  auto out = torch::empty_like(q);
  C10_CUDA_CHECK(decode_attention_launch(
      q.data_ptr(), k.data_ptr(), v.data_ptr(),
      key_mask ? static_cast<const uint8_t*>(key_mask->data_ptr()) : nullptr,
      t ? t->data_ptr<int32_t>() : nullptr, (int)t_val, out.data_ptr(), (int)q.size(0),
      (int)q.size(1), (int)k.size(1), (int)q.size(2),
      key_mask ? (int)(q.size(0) / key_mask->size(0)) : 1, (float)scale,
      q.scalar_type() == torch::kBFloat16, at::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return out;
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
  m.def("vq_argmin", &vq_argmin, "K4: nearest-codebook argmin");
}
