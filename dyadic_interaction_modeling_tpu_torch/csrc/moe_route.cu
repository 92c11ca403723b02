// The expert layer's routing, dispatch and combine (K6; CUDA, sm_90a).
//
// Replaces no TPU kernel: the JAX package has no mixture of experts. It is
// the data path around the grouped expert GEMMs of DeepSeek-V2's expert layer
// (models/deepseek_v2.py MoE.forward), which took a sort, gathers, scatters
// and two fp32 copies of the routed rows in PyTorch operations.
//
// moe_dispatch, from the router's fp32 logits (n, E) and the rows x (n, H)
// bf16, in two launches:
// - moe_route_kernel: a warp a token. Softmax in fp32 (butterfly max and sum,
//   expf, each score e / sum), then a greedy top-k over the scores, ties to
//   the lower expert (each pick: a warp max of the scores' bits, which order
//   as the non-negative floats do, then a warp min of the experts that hold
//   it), and the weights (normalised over the k when norm_topk, then
//   scaled). A block holds 8 x tpw tokens; one thread an expert walks them
//   in token order and gives each of its pairs its rank, so the block's
//   count of each expert is known without atomics. The last block to arrive
//   (an arrival counter, left at zero) scans the blocks' counts: each
//   expert's end (the int32 `offs` of torch._grouped_mm), expert_load +=
//   the counts, and each block's first position in each expert's range.
// - moe_scatter_kernel: a thread a 16-byte chunk of a row: the token's k
//   positions (its route block's first position + rank), and the chunk
//   copied to each. Within an expert's range the rows keep token order, as
//   a stable sort by expert would give them, so the routed rows are the
//   same bits from run to run.
// moe_combine_kernel: a thread a 16-byte chunk of a row. y = bf16(sum_j w_j
// ys[pos_j]), fp32 products summed in slot order, no fused multiply-add;
// then, where the shared experts' bf16 output is given, bf16(float(y) +
// shared). The k loads are issued before the sum, so they are in flight
// together.
//
// Bound on the H100: bytes. The dispatch reads the logits and x and writes
// the k routed rows; the combine reads the k expert outputs and the shared
// output and writes y. At the dsv2_lite cell's shapes (H 2048, E 64, k 6):
// a decode step's 512 tokens move 31.5 MB an expert layer (9.4 us at 3.35
// TB/s), a prefill chunk's 65,536 tokens 4.0 GB (1.2 ms). The route
// kernel's grid follows n: blocks of 8 tokens at decode (64 blocks), 64 at
// a prefill chunk (1024); the other two take a thread a chunk.

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "kernels.h"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int EPL = MOE_MAX_EXPERTS / 32;  // experts a lane
constexpr int MAX_TPW = 8;                  // tokens a warp of the route kernel
constexpr int TARGET_BLOCKS = 4 * 132;      // route blocks that fill the card
constexpr unsigned FULL = 0xffffffffu;

static_assert(MOE_MAX_EXPERTS % 32 == 0 && MOE_MAX_EXPERTS <= THREADS, "one thread an expert");

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

// Every lane ends with the same bits: each step adds the same two values.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void unpack8(const uint4& v, float* f) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) f[2 * i] = bf16_lo(w[i]), f[2 * i + 1] = bf16_hi(w[i]);
}

// Shared memory of the route kernel: the last block's per-group sums
// (THREADS ints), the experts' first positions, its flag, then a byte a
// (token, expert) of the block: the slot that chose the expert, or -1.
constexpr int SHARED_INTS = THREADS + MOE_MAX_EXPERTS + 4;

__global__ void __launch_bounds__(THREADS)
moe_route_kernel(const float* __restrict__ logits, int n, int E, int k, int tpw,
                 bool norm_topk, float scaling, float* __restrict__ w, int32_t* __restrict__ ids,
                 int32_t* __restrict__ rank, int32_t* __restrict__ counts,
                 int32_t* __restrict__ offsets, int32_t* __restrict__ ends,
                 long long* __restrict__ load, int* __restrict__ arrivals) {
  extern __shared__ uint4 smem[];
  int* part = reinterpret_cast<int*>(smem);
  int* start = part + THREADS;
  int* last = start + MOE_MAX_EXPERTS;
  signed char* slot_of = reinterpret_cast<signed char*>(part + SHARED_INTS);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tb = WARPS * tpw, t0 = blockIdx.x * tb;
  for (int i = tid; i < tb * E; i += THREADS) slot_of[i] = -1;
  __syncthreads();

  for (int i = 0; i < tpw; ++i) {
    const int lt = warp * tpw + i, tok = t0 + lt;
    if (tok >= n) break;  // the whole warp
    const float* row = logits + (size_t)tok * E;
    float v[EPL];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      v[j] = lane + 32 * j < E ? row[lane + 32 * j] : -INFINITY;
      mx = fmaxf(mx, v[j]);
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < EPL; ++j)
      if (lane + 32 * j < E) v[j] = expf(v[j] - mx), sum += v[j];
    sum = warp_sum(sum);
    uint32_t bits[EPL] = {};
    unsigned avail = 0;
#pragma unroll
    for (int j = 0; j < EPL; ++j)
      if (lane + 32 * j < E) bits[j] = __float_as_uint(v[j] / sum), avail |= 1u << j;
    float wsel[MOE_MAX_K], wsum = 0.f;
    int esel[MOE_MAX_K];
#pragma unroll
    for (int s = 0; s < MOE_MAX_K; ++s) {
      if (s >= k) break;
      uint32_t best = 0;
      int bj = -1;  // this lane's best available expert: the highest score, then the lowest j
#pragma unroll
      for (int j = 0; j < EPL; ++j)
        if (((avail >> j) & 1u) && (bj < 0 || bits[j] > best)) best = bits[j], bj = j;
      const uint32_t m = __reduce_max_sync(FULL, bj >= 0 ? best : 0u);
      const uint32_t e = __reduce_min_sync(FULL, bj >= 0 && best == m ? lane + 32 * bj : ~0u);
      if (lane == (int)(e & 31)) avail &= ~(1u << (e >> 5));
      esel[s] = (int)e;
      wsel[s] = __uint_as_float(m);
      wsum += wsel[s];
    }
#pragma unroll
    for (int s = 0; s < MOE_MAX_K; ++s) {
      if (s >= k) break;
      float ws = wsel[s];
      if (norm_topk && k > 1) ws = ws / (wsum + 1e-20f);
      if (lane == s) {
        w[(size_t)tok * k + s] = ws * scaling;
        ids[(size_t)tok * k + s] = esel[s];
        slot_of[lt * E + esel[s]] = (signed char)s;
      }
    }
  }
  __syncthreads();

  // ranks within each expert in token order, and the block's counts
  if (tid < E) {
    int c = 0;
    for (int lt = 0; lt < tb; ++lt) {
      const int s = slot_of[lt * E + tid];
      if (s >= 0) rank[(size_t)(t0 + lt) * k + s] = c++;
    }
    counts[(size_t)blockIdx.x * E + tid] = c;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) *last = atomicAdd(arrivals, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();

  // The last block: group g of THREADS / E sums blocks [g seg, (g+1) seg)
  // of each expert's counts; warp 0 scans the experts' totals.
  const int nb = gridDim.x, groups = THREADS / E, seg = (nb + groups - 1) / groups;
  const int g = tid / E, e = tid % E, b0 = g * seg, b1 = min(nb, b0 + seg);
  if (g < groups) {
    int s = 0;
#pragma unroll 8
    for (int b = b0; b < b1; ++b) s += __ldcg(counts + (size_t)b * E + e);
    part[g * E + e] = s;
  }
  __syncthreads();
  if (warp == 0) {
    int tot[EPL], run = 0;
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      const int ex = lane * EPL + j;
      tot[j] = 0;
      if (ex < E)
        for (int q = 0; q < groups; ++q) tot[j] += part[q * E + ex];
      run += tot[j];
    }
    int incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += up;
    }
    int base = incl - run;
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      const int ex = lane * EPL + j;
      if (ex < E) {
        start[ex] = base;
        base += tot[j];
        ends[ex] = base;
        if (load) load[ex] += tot[j];
      }
    }
  }
  __syncthreads();
  if (g < groups) {
    int run = start[e];
    for (int q = 0; q < g; ++q) run += part[q * E + e];
#pragma unroll 8
    for (int b = b0; b < b1; ++b) {
      offsets[(size_t)b * E + e] = run;
      run += __ldcg(counts + (size_t)b * E + e);
    }
  }
  if (tid == 0) *arrivals = 0;  // the next launch finds it at zero
}

__global__ void __launch_bounds__(THREADS)
moe_scatter_kernel(const uint4* __restrict__ x, int n, int E, int k, int chunks, int tpw,
                   const int32_t* __restrict__ ids, const int32_t* __restrict__ offsets,
                   const int32_t* __restrict__ rank, int32_t* __restrict__ pos,
                   uint4* __restrict__ xs) {
  const size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= (size_t)n * chunks) return;
  const int tok = (int)(i / chunks), c = (int)(i % chunks);
  const int32_t* off = offsets + (size_t)(tok / (WARPS * tpw)) * E;
  const uint4 v = x[i];
#pragma unroll
  for (int s = 0; s < MOE_MAX_K; ++s) {
    if (s >= k) break;
    const size_t pair = (size_t)tok * k + s;
    const int d = off[ids[pair]] + rank[pair];
    if (c == 0) pos[pair] = d;
    xs[(size_t)d * chunks + c] = v;
  }
}

__global__ void __launch_bounds__(THREADS)
moe_combine_kernel(const uint4* __restrict__ ys, const float* __restrict__ w,
                   const int32_t* __restrict__ pos, const uint4* __restrict__ shared,
                   uint4* __restrict__ y, int n, int k, int chunks) {
  const size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= (size_t)n * chunks) return;
  const int tok = (int)(i / chunks), c = (int)(i % chunks);
  uint4 v[MOE_MAX_K];
#pragma unroll
  for (int s = 0; s < MOE_MAX_K; ++s)
    if (s < k) v[s] = ys[(size_t)pos[(size_t)tok * k + s] * chunks + c];
  float acc[8] = {};
#pragma unroll
  for (int s = 0; s < MOE_MAX_K; ++s) {
    if (s >= k) break;
    const float ws = w[(size_t)tok * k + s];
    float f[8];
    unpack8(v[s], f);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(ws, f[j]));
  }
  uint4 r = uint4{pack2(acc[0], acc[1]), pack2(acc[2], acc[3]), pack2(acc[4], acc[5]),
                  pack2(acc[6], acc[7])};
  if (shared) {
    float a[8], b[8];
    unpack8(r, a);
    unpack8(shared[i], b);
    r = uint4{pack2(a[0] + b[0], a[1] + b[1]), pack2(a[2] + b[2], a[3] + b[3]),
              pack2(a[4] + b[4], a[5] + b[5]), pack2(a[6] + b[6], a[7] + b[7])};
  }
  y[i] = r;
}

// Tokens a warp of the route kernel, and its blocks: one token a warp until
// the grid fills the card, then up to MAX_TPW.
void plan(int n, int* tpw, int* blocks) {
  const int t = (n + WARPS * TARGET_BLOCKS - 1) / (WARPS * TARGET_BLOCKS);
  *tpw = std::max(1, std::min(MAX_TPW, t));
  *blocks = std::max(1, (n + WARPS * *tpw - 1) / (WARPS * *tpw));
}

}  // namespace

void moe_dispatch_scratch(int n, int E, int k, int64_t* ints) {
  int tpw, blocks;
  plan(n, &tpw, &blocks);
  *ints = 2 * (int64_t)blocks * E + (int64_t)n * k;
}

cudaError_t moe_dispatch_launch(const float* logits, const void* x, int n, int E, int k, int H,
                                bool norm_topk, float scaling, float* w, int32_t* ids,
                                int32_t* ends, int32_t* pos, void* xs, long long* load,
                                int32_t* scratch, int* arrivals, cudaStream_t stream) {
  int tpw, blocks;
  plan(n, &tpw, &blocks);
  int32_t* counts = scratch;
  int32_t* offsets = counts + (size_t)blocks * E;
  int32_t* rank = offsets + (size_t)blocks * E;
  const size_t smem = sizeof(int) * SHARED_INTS + (size_t)WARPS * tpw * E;
  moe_route_kernel<<<blocks, THREADS, smem, stream>>>(
      logits, n, E, k, tpw, norm_topk, scaling, w, ids, rank, counts, offsets, ends, load,
      arrivals);
  const int chunk_blocks = (int)(((int64_t)n * (H / 8) + THREADS - 1) / THREADS);
  if (chunk_blocks > 0)
    moe_scatter_kernel<<<chunk_blocks, THREADS, 0, stream>>>(
        (const uint4*)x, n, E, k, H / 8, tpw, ids, offsets, rank, pos, (uint4*)xs);
  return cudaSuccess;
}

cudaError_t moe_combine_launch(const void* ys, const float* w, const int32_t* pos,
                               const void* shared, void* y, int n, int k, int H,
                               cudaStream_t stream) {
  const int chunk_blocks = (int)(((int64_t)n * (H / 8) + THREADS - 1) / THREADS);
  if (chunk_blocks > 0)
    moe_combine_kernel<<<chunk_blocks, THREADS, 0, stream>>>(
        (const uint4*)ys, w, pos, (const uint4*)shared, (uint4*)y, n, k, H / 8);
  return cudaSuccess;
}
