// Python binding of the port's CUDA kernels: the one source that includes
// PyTorch's headers (they take the bulk of the build time). Its callers, the
// wrappers in kernels/decode.py, kernels/attention.py, kernels/vq.py,
// kernels/latent_decode.py and kernels/moe_route.py,
// check device, dtype, shape and contiguity and raise on what a kernel does
// not take. Each function here allocates its outputs (and scratch), launches
// on PyTorch's current stream of the input's device and checks the launch.

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGraphsC10Utils.h>
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
// bf16 the kernels of flash_attention_mma.cu, fp32 the 3xTF32 kernels of
// flash_attention.cu, both on the tensor cores.
bool takes_mma(const torch::Tensor& q) { return q.scalar_type() == torch::kBFloat16; }

// Arrival counters, one buffer a device for each user (0: K1, 1: K6's
// dispatch): zero when made, and every launch leaves the counters it used at
// zero, so a call needs no memset. The buffer is made on a call outside a
// CUDA graph's capture (a fill inside one would run only at its replays).
int* arrival_counters(const torch::Tensor& like, int64_t n, int user) {
  static auto* by_device = new std::vector<torch::Tensor>[2]();  // never freed
  std::vector<torch::Tensor>& bufs = by_device[user];
  const size_t dev = (size_t)like.get_device();
  if (bufs.size() <= dev) bufs.resize(dev + 1);
  torch::Tensor& buf = bufs[dev];
  if (!buf.defined() || buf.numel() < n) {
    TORCH_CHECK(
        c10::cuda::currentStreamCaptureStatusMayInitCtx() == c10::cuda::CaptureStatus::None,
        "arrival counters are first made outside a CUDA graph's capture");
    buf = torch::zeros({std::max<int64_t>(n, 4096)}, like.options().dtype(torch::kInt));
  }
  return buf.data_ptr<int>();
}

torch::Tensor decode_attention(const torch::Tensor& q, const torch::Tensor& k,
                               const torch::Tensor& v,
                               const c10::optional<torch::Tensor>& key_mask,
                               const c10::optional<torch::Tensor>& t, int64_t t_val,
                               double scale) {
  const c10::cuda::CUDAGuard guard(q.device());
  auto out = torch::empty_like(q);
  const int rows = (int)q.size(0), nq = (int)q.size(1), L = (int)k.size(1),
            D = (int)q.size(2);
  const bool bf16 = q.scalar_type() == torch::kBFloat16;
  int64_t n_part = 0, n_count = 0;
  decode_attention_scratch(rows, nq, L, D, (int)t_val, t.has_value(), bf16, &n_part,
                           &n_count);
  auto part = torch::empty({n_part}, q.options().dtype(torch::kFloat));
  C10_CUDA_CHECK(decode_attention_launch(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr(key_mask),
      t ? t->data_ptr<int32_t>() : nullptr, (int)t_val, out.data_ptr(),
      n_part ? part.data_ptr<float>() : nullptr,
      n_count ? arrival_counters(q, n_count, 0) : nullptr, rows, nq, L, D,
      mask_div(q, key_mask), (float)scale, bf16, at::cuda::getCurrentCUDAStream()));
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

// K4's result: the low words of its 64-bit (distance, index) keys, which the
// kernel merges by atomicMin from all ones.
torch::Tensor vq_argmin(const torch::Tensor& z, const torch::Tensor& codebook) {
  const c10::cuda::CUDAGuard guard(z.device());
  const int64_t n = z.size(0);
  auto keys = torch::empty({n}, z.options().dtype(torch::kLong));
  const auto stream = at::cuda::getCurrentCUDAStream();
  C10_CUDA_CHECK(cudaMemsetAsync(keys.data_ptr(), 0xff, n * sizeof(int64_t), stream));
  C10_CUDA_CHECK(vq_argmin_launch(
      z.data_ptr<float>(), codebook.data_ptr<float>(),
      reinterpret_cast<unsigned long long*>(keys.data_ptr<int64_t>()), (int)n,
      (int)codebook.size(0), (int)z.size(1), stream));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return keys.view(torch::kInt).view({n, 2}).select(1, 0);  // little-endian low words
}

// K5: the latent rows of (rows, 16, 576) queries over (rows, L, 576) cache rows.
torch::Tensor latent_decode(const torch::Tensor& q, const torch::Tensor& cache,
                            const c10::optional<torch::Tensor>& t, int64_t t_val,
                            double scale) {
  const c10::cuda::CUDAGuard guard(q.device());
  const int rows = (int)q.size(0), L = (int)cache.size(1);
  auto out = torch::empty({q.size(0), LATENT_HEADS, LATENT_DV}, q.options());
  int64_t n_part = 0;
  latent_decode_scratch(rows, L, (int)t_val, t.has_value(), &n_part);
  auto part = torch::empty({n_part}, q.options().dtype(torch::kFloat));
  C10_CUDA_CHECK(latent_decode_launch(
      q.data_ptr(), cache.data_ptr(), t ? t->data_ptr<int32_t>() : nullptr, (int)t_val,
      out.data_ptr(), n_part ? part.data_ptr<float>() : nullptr, rows, L, (float)scale,
      at::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return out;
}

// K6: the routing and the routed rows of an expert layer from its fp32 gate
// logits; returns w, ids, ends, pos, xs.
std::vector<torch::Tensor> moe_dispatch(const torch::Tensor& logits, const torch::Tensor& x,
                                        int64_t k, bool norm_topk, double scaling,
                                        const c10::optional<torch::Tensor>& load) {
  const c10::cuda::CUDAGuard guard(x.device());
  const int n = (int)x.size(0), H = (int)x.size(1), E = (int)logits.size(1);
  auto ints = x.options().dtype(torch::kInt);
  auto w = torch::empty({n, k}, x.options().dtype(torch::kFloat));
  auto ids = torch::empty({n, k}, ints);
  auto pos = torch::empty({n, k}, ints);
  auto ends = torch::empty({E}, ints);
  auto xs = torch::empty({n * k, H}, x.options());
  int64_t n_scratch = 0;
  moe_dispatch_scratch(n, E, (int)k, &n_scratch);
  auto scratch = torch::empty({n_scratch}, ints);
  C10_CUDA_CHECK(moe_dispatch_launch(
      logits.data_ptr<float>(), x.data_ptr(), n, E, (int)k, H, norm_topk, (float)scaling,
      w.data_ptr<float>(), ids.data_ptr<int32_t>(), ends.data_ptr<int32_t>(),
      pos.data_ptr<int32_t>(), xs.data_ptr(),
      load ? reinterpret_cast<long long*>(load->data_ptr<int64_t>()) : nullptr,
      scratch.data_ptr<int32_t>(), arrival_counters(x, 1, 1),
      at::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return {w, ids, ends, pos, xs};
}

// K6: y = bf16(sum_j w_j ys[pos_j]), plus the shared rows when given.
torch::Tensor moe_combine(const torch::Tensor& ys, const torch::Tensor& w,
                          const torch::Tensor& pos, const c10::optional<torch::Tensor>& shared) {
  const c10::cuda::CUDAGuard guard(ys.device());
  const int n = (int)w.size(0), k = (int)w.size(1), H = (int)ys.size(1);
  auto y = torch::empty({n, H}, ys.options());
  C10_CUDA_CHECK(moe_combine_launch(ys.data_ptr(), w.data_ptr<float>(), pos.data_ptr<int32_t>(),
                                    shared ? shared->data_ptr() : nullptr, y.data_ptr(), n, k,
                                    H, at::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return y;
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("decode_attention", &decode_attention, "K1: one decode attention step");
  m.def("flash_attention_fwd", &flash_attention_fwd, "K2: flash attention forward");
  m.def("flash_attention_bwd", &flash_attention_bwd, "K3: flash attention backward");
  m.def("vq_argmin", &vq_argmin, "K4: nearest-codebook argmin");
  m.def("latent_decode", &latent_decode, "K5: latent (MLA) decode attention");
  m.def("moe_dispatch", &moe_dispatch, "K6: expert routing and the routed rows");
  m.def("moe_combine", &moe_combine, "K6: the weighted combine of the experts' rows");
}
