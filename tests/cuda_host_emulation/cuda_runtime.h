// Host stand-in for the CUDA runtime, for running a kernel source on the CPU
// with g++ -std=c++20: one std::thread per CUDA thread, blocks one after
// another, __syncthreads as a std::barrier, and a per-warp barrier and
// exchange area for the warp-level instructions (ptx_sm90.cuh beside this
// file), and the fences, atomics and L2 loads of a combine across blocks.
// The test that uses it rewrites two things in the kernel source that
// C++ cannot express: `extern __shared__` arrays become pointers to
// emulation::shared_memory(), and `kernel<<<grid, threads, smem, stream>>>(...)`
// becomes emulation::launch(grid, threads, smem, [=] { kernel(...); }).

#pragma once

#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)

typedef int cudaError_t;
constexpr int cudaSuccess = 0, cudaErrorInvalidValue = 1;
typedef void* cudaStream_t;
constexpr int cudaFuncAttributeMaxDynamicSharedMemorySize = 8;
template <typename K>
cudaError_t cudaFuncSetAttribute(K, int, int) { return cudaSuccess; }

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
struct uint4 { uint32_t x, y, z, w; };
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };

namespace emulation {

// One cp.async: carried out when its group is waited for, the latest moment
// the hardware allows, so a missing or too lax wait_group shows as stale data.
struct Copy { void* dst; const void* src; int bytes; bool valid; };

struct Warp {
  std::barrier<> bar{32};
  uint32_t a[32][4], b[32][2];  // mma operands of every lane
  uint32_t ta[2][32][4], tb[2][32][2];  // TF32 mma operands, two calls' worth
  int tf32_calls[32] = {};              // each lane's count of TF32 mma calls
  uint64_t f[32];               // shuffle values (up to 64 bits)
  const void* p[32];            // ldmatrix row addresses
};

struct Block {
  std::barrier<> bar;
  std::atomic<int> count{0};
  std::vector<std::unique_ptr<Warp>> warps;
  std::vector<unsigned char> smem;
  Block(int threads, size_t bytes) : bar(threads), smem(bytes + 128) {
    for (int i = 0; i < (threads + 31) / 32; ++i) warps.emplace_back(new Warp);
    std::memset(smem.data(), 0xff, smem.size());  // NaNs: unwritten reads show
  }
};

inline thread_local Block* block = nullptr;
inline thread_local std::deque<std::vector<Copy>> groups;  // committed, not waited for
inline thread_local std::vector<Copy> open_group;

inline void carry_out(const Copy& c) {
  if (c.valid) std::memcpy(c.dst, c.src, c.bytes);
  else std::memset(c.dst, 0, c.bytes);
}

inline void* shared_memory() {
  const auto p = reinterpret_cast<uintptr_t>(block->smem.data());
  return reinterpret_cast<void*>((p + 127) & ~uintptr_t(127));
}

}  // namespace emulation

inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;

namespace emulation {

inline Warp& warp() { return *block->warps[threadIdx.x / 32]; }
inline int lane() { return threadIdx.x % 32; }

template <typename F>
void launch(dim3 grid, int threads, size_t smem, F kernel) {
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      Block blk(threads, smem);
      std::vector<std::thread> ts;
      for (int t = 0; t < threads; ++t)
        ts.emplace_back([&, t] {
          block = &blk;
          threadIdx = dim3(t), blockIdx = dim3(bx, by), blockDim = dim3(threads), gridDim = grid;
          groups.clear(), open_group.clear();
          kernel();
          for (const auto& g : groups)
            if (!g.empty()) {
              std::fprintf(stderr, "emulation: a cp.async group was never waited for\n");
              std::abort();
            }
        });
      for (auto& t : ts) t.join();
    }
}

}  // namespace emulation

inline void __syncthreads() { emulation::block->bar.arrive_and_wait(); }

inline int __syncthreads_count(int predicate) {
  if (predicate) emulation::block->count.fetch_add(1);
  __syncthreads();
  const int n = emulation::block->count.load();
  __syncthreads();
  if (threadIdx.x == 0) emulation::block->count.store(0);
  __syncthreads();
  return n;
}

inline int __syncthreads_or(int predicate) { return __syncthreads_count(predicate) != 0; }

inline void __syncwarp() { emulation::warp().bar.arrive_and_wait(); }

template <typename T>
inline T __shfl_xor_sync(unsigned, T v, int lane_mask) {
  static_assert(sizeof(T) <= sizeof(uint64_t));
  auto& w = emulation::warp();
  const int l = emulation::lane();
  std::memcpy(&w.f[l], &v, sizeof(T));
  w.bar.arrive_and_wait();
  T r;
  std::memcpy(&r, &w.f[l ^ lane_mask], sizeof(T));
  w.bar.arrive_and_wait();
  return r;
}

// Blocks run one after another, so every other block's writes are visible:
// the fence is a full fence and the L2-only load a plain load.
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }

inline float __ldcg(const float* p) { return *p; }

inline int atomicAdd(int* p, int v) { return std::atomic_ref<int>(*p).fetch_add(v); }

inline unsigned long long atomicMin(unsigned long long* p, unsigned long long v) {
  std::atomic_ref<unsigned long long> a(*p);
  unsigned long long old = a.load();
  while (v < old && !a.compare_exchange_weak(old, v)) {
  }
  return old;
}

inline uint32_t __float_as_uint(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  return u;
}

inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

inline float2 make_float2(float x, float y) { return {x, y}; }

using std::isnan;
using std::max;
using std::min;
