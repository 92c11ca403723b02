// Host stand-in for the CUDA runtime, for running a kernel source on the CPU
// with g++ -std=c++20: a block's CUDA threads run as fibers (user-level
// contexts, each on a stack of its own) on the calling OS thread, blocks one
// after another. A fiber runs until it waits at a barrier: __syncthreads, or
// the per-warp barrier of the warp-level instructions (ptx_sm90.cuh beside
// this file); the last to arrive releases the others. Warps run one after
// another up to each __syncthreads, a warp's lanes in step between its own
// barriers. There are also the fences, atomics and L2 loads of a combine
// across blocks. Switching fibers costs a few register moves (x86-64 assembly
// below, where ucontext's swapcontext would make a system call at each);
// a barrier that can never complete aborts. A test runs each launch twice (emulation_schedule): warps
// and lanes first to last with every cp.async carried out at its wait, then
// last to first with every cp.async carried out when issued. A barrier
// missing after a write shows only when the readers run first, and a missing
// or too lax wait or a copy into a buffer still being read only at one of
// the two moments, so each such fault shows in one of the runs.
// The test that uses it rewrites two things in the kernel source that
// C++ cannot express: `extern __shared__` arrays become pointers to
// emulation::shared_memory(), and `kernel<<<grid, threads, smem, stream>>>(...)`
// becomes emulation::launch(grid, threads, smem, [=] { kernel(...); }).
// One launch runs at a time in a process.

#pragma once

#include <sys/mman.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <memory>
#include <vector>

#if !defined(__x86_64__)
#error "the fiber switch of this emulation is x86-64 assembly"
#endif

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

inline dim3 threadIdx, blockIdx, blockDim, gridDim;  // threadIdx: the running fiber's

// emulation_switch(save, to): pushes the callee-saved registers, stores the
// stack pointer in *save, takes `to` as the stack pointer and pops the
// registers saved there; `ret` resumes that context.
extern "C" void emulation_switch(void** save, void* to);
asm(R"(
  .pushsection .text
  .weak emulation_switch
  .hidden emulation_switch
  .type emulation_switch, @function
emulation_switch:
  pushq %rbp
  pushq %rbx
  pushq %r12
  pushq %r13
  pushq %r14
  pushq %r15
  movq %rsp, (%rdi)
  movq %rsi, %rsp
  popq %r15
  popq %r14
  popq %r13
  popq %r12
  popq %rbx
  popq %rbp
  ret
  .size emulation_switch, .-emulation_switch
  .popsection
)");

namespace emulation {

// One cp.async: carried out when its group is waited for, the latest moment
// the hardware allows, so a missing or too lax wait_group shows as stale data
// (or, under eager_copies, when issued: then a copy into a buffer that a
// later fiber still reads before the next barrier shows as wrong values).
struct Copy { void* dst; const void* src; int bytes; bool valid; };

// A CUDA thread: its context, index and cp.async groups.
struct Fiber {
  void* sp = nullptr;
  char* stack = nullptr;
  dim3 tid;
  bool done = false;
  bool parked = false;  // arrived at the block's barrier in this pass
  std::deque<std::vector<Copy>> groups;  // committed, not waited for
  std::vector<Copy> open_group;
};

constexpr size_t kStackBytes = size_t(1) << 20;  // a guard page below each

inline Fiber* current = nullptr;  // the running fiber
inline long progress = 0;         // barrier arrivals and finished fibers
inline void* scheduler_sp = nullptr;
inline bool reverse_order = false;  // resume a block's fibers last to first
inline bool eager_copies = false;   // carry a cp.async out when issued

// Back to the scheduler, which resumes the next fiber.
inline void yield() { emulation_switch(&current->sp, scheduler_sp); }

// Every fiber of the group arrives; the last releases the others and yields
// too, so that past the barrier the fibers run in the schedule's order.
struct Barrier {
  int expected, arrived = 0;
  unsigned generation = 0;
  explicit Barrier(int n) : expected(n) {}
  void arrive_and_wait() {
    ++progress;
    const unsigned g = generation;
    if (++arrived == expected) {
      arrived = 0, ++generation;
      yield();
      return;
    }
    while (generation == g) yield();
  }
};

struct Warp {
  Barrier bar;
  uint32_t a[32][4], b[32][2];  // mma operands of every lane
  uint32_t ta[2][32][4], tb[2][32][2];  // TF32 mma operands, two calls' worth
  int tf32_calls[32] = {};              // each lane's count of TF32 mma calls
  uint64_t f[32];               // shuffle values (up to 64 bits)
  const void* p[32];            // ldmatrix row addresses
  explicit Warp(int lanes) : bar(lanes) {}
};

struct Block {
  Barrier bar;
  int count = 0;
  std::vector<std::unique_ptr<Warp>> warps;
  std::vector<unsigned char> smem;
  Block(int threads, size_t bytes) : bar(threads), smem(bytes + 128) {
    for (int i = 0; i < (threads + 31) / 32; ++i)
      warps.emplace_back(new Warp(std::min(32, threads - 32 * i)));
    std::memset(smem.data(), 0xff, smem.size());  // NaNs: unwritten reads show
  }
};

inline Block* block = nullptr;

inline void carry_out(const Copy& c) {
  if (c.valid) std::memcpy(c.dst, c.src, c.bytes);
  else std::memset(c.dst, 0, c.bytes);
}

inline void* shared_memory() {
  const auto p = reinterpret_cast<uintptr_t>(block->smem.data());
  return reinterpret_cast<void*>((p + 127) & ~uintptr_t(127));
}

inline Warp& warp() { return *block->warps[threadIdx.x / 32]; }
inline int lane() { return threadIdx.x % 32; }

// Stacks stay mapped for later launches; only the pages a kernel touches
// take memory.
inline char* stack(size_t i) {
  static std::vector<char*> pool;
  while (pool.size() <= i) {
    void* p = mmap(nullptr, kStackBytes, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0);
    if (p == MAP_FAILED) {
      std::fprintf(stderr, "emulation: no memory for a fiber stack\n");
      std::abort();
    }
    mprotect(p, 4096, PROT_NONE);  // an overflow faults instead of corrupting
    pool.push_back(static_cast<char*>(p));
  }
  return pool[i];
}

inline void (*run_kernel)(const void*) = nullptr;
inline const void* kernel_object = nullptr;

inline void fiber_main() {
  run_kernel(kernel_object);
  for (const auto& g : current->groups)
    if (!g.empty()) {
      std::fprintf(stderr, "emulation: a cp.async group was never waited for\n");
      std::abort();
    }
  current->done = true;
  ++progress;
  yield();  // never resumed
  std::abort();
}

inline void start(Fiber& f) {
  // fiber_main is entered by the `ret` of emulation_switch as if called:
  // below its entry address lie the six registers the switch pops, and the
  // stack pointer is 8 past a multiple of 16 once the address is taken
  auto top = reinterpret_cast<uintptr_t>(f.stack + kStackBytes) & ~uintptr_t(15);
  auto* sp = reinterpret_cast<void**>(top - 64);
  for (int i = 0; i < 6; ++i) sp[i] = nullptr;
  sp[6] = reinterpret_cast<void*>(&fiber_main);
  sp[7] = nullptr;
  f.sp = sp;
}

inline void resume(Fiber& f) {
  current = &f;
  threadIdx = f.tid;
  emulation_switch(&scheduler_sp, f.sp);
}

template <typename F>
void launch(dim3 grid, int threads, size_t smem, F kernel) {
  run_kernel = [](const void* k) { (*static_cast<const F*>(k))(); };
  kernel_object = &kernel;
  std::vector<Fiber> fibers(threads);
  for (int t = 0; t < threads; ++t) fibers[t].stack = stack(t);
  blockDim = dim3(threads), gridDim = grid;
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      Block blk(threads, smem);
      block = &blk;
      blockIdx = dim3(bx, by);
      for (int t = 0; t < threads; ++t) {
        Fiber& f = fibers[t];
        f.tid = dim3(t), f.done = false;
        f.groups.clear(), f.open_group.clear();
        start(f);
      }
      // A pass runs one warp after another, in the schedule's order, each
      // until every lane waits at the block's barrier or has finished; the
      // lanes of a warp run one barrier interval a sweep. Warps thus run as
      // far apart as the block's barriers let them.
      const int n_warps = (threads + 31) / 32;
      for (int live = threads; live > 0;) {
        const long before = progress;
        for (auto& f : fibers) f.parked = false;
        for (int wi = 0; wi < n_warps; ++wi) {
          const int lo = 32 * (reverse_order ? n_warps - 1 - wi : wi);
          const int lanes = std::min(32, threads - lo);
          for (;;) {
            const long swept = progress;
            bool ran = false;
            for (int i = 0; i < lanes; ++i)
              if (Fiber& f = fibers[lo + (reverse_order ? lanes - 1 - i : i)];
                  !f.done && !f.parked)
                resume(f), ran = true;
            if (!ran || progress == swept) break;
          }
        }
        live = 0;
        for (const auto& f : fibers) live += !f.done;
        if (live > 0 && progress == before) {
          std::fprintf(stderr, "emulation: threads wait at a barrier that can never complete\n");
          std::abort();
        }
      }
    }
  current = nullptr;
}

}  // namespace emulation

// 0: fibers first to last, copies late; 1: last to first, copies early.
extern "C" __attribute__((used, visibility("default"))) inline void emulation_schedule(
    int second) {
  emulation::reverse_order = emulation::eager_copies = second != 0;
}

inline void __syncthreads() {
  emulation::current->parked = true;
  emulation::block->bar.arrive_and_wait();
}

inline int __syncthreads_count(int predicate) {
  if (predicate) ++emulation::block->count;
  __syncthreads();
  const int n = emulation::block->count;
  __syncthreads();
  if (threadIdx.x == 0) emulation::block->count = 0;
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

template <typename T>
inline T __shfl_up_sync(unsigned, T v, unsigned delta) {
  static_assert(sizeof(T) <= sizeof(uint64_t));
  auto& w = emulation::warp();
  const int l = emulation::lane();
  std::memcpy(&w.f[l], &v, sizeof(T));
  w.bar.arrive_and_wait();
  T r = v;  // a lane below delta keeps its own value
  if (l >= (int)delta) std::memcpy(&r, &w.f[l - delta], sizeof(T));
  w.bar.arrive_and_wait();
  return r;
}

// The warp-wide unsigned reductions (redux.sync) over every lane of the warp.
template <typename Op>
inline unsigned warp_reduce(unsigned v, Op op) {
  auto& w = emulation::warp();
  w.f[emulation::lane()] = v;
  w.bar.arrive_and_wait();
  unsigned r = (unsigned)w.f[0];
  for (int i = 1; i < w.bar.expected; ++i) r = op(r, (unsigned)w.f[i]);
  w.bar.arrive_and_wait();
  return r;
}

inline unsigned __reduce_max_sync(unsigned, unsigned v) {
  return warp_reduce(v, [](unsigned a, unsigned b) { return a > b ? a : b; });
}

inline unsigned __reduce_min_sync(unsigned, unsigned v) {
  return warp_reduce(v, [](unsigned a, unsigned b) { return a < b ? a : b; });
}

// Blocks run one after another, so every other block's writes are visible:
// the fence is a full fence and the L2-only load a plain load.
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }

inline float __ldcg(const float* p) { return *p; }
inline int __ldcg(const int* p) { return *p; }

// Round-to-nearest product and sum, never contracted into a fused multiply-add.
inline float __fmul_rn(float a, float b) {
  volatile float r = a * b;
  return r;
}
inline float __fadd_rn(float a, float b) {
  volatile float r = a + b;
  return r;
}

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
