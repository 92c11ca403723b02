// Single-step decode attention against a KV cache (CUDA, sm_90a).
//
// Replaces the TPU kernel `decode_attention`
// (dyadic_interaction_modeling_tpu/ops/pallas/decode.py:129, body `_kernel`
// :54, pallas_call :201).
//
// For each cache row r (batch x kv head): NQ query rows q[r] attend over the
// keys k[r, j], j <= t (all L keys when unbounded), optionally restricted by
// a key mask, and return softmax(q k^T * scale) v in q's dtype. A row whose
// keys are all masked returns exactly 0. Keys past t are never read.
//
// Bound on the H100: bytes. Each launch reads the live K/V prefix once and
// does ~2 FLOP per byte read per query row. At the generate's shapes (bf16,
// L = 256, 3.35 TB/s): self (3000, 1, 64), a sweep t = 0..255, moves 98.7 MB
// a mean launch -> 29.5 us; cross (300, 10, 64) 19.7 MB -> 5.9 us; the MQA
// cross (25, 120, 64) 1.6 MB, under the launch latency.
//
// Design. A call is one launch of blocks (cache row, query tile, key split):
// - the key axis is cut into `splits` chunks (at most 16), chosen on the
//   host from L and from t when t is an int, so that rows x query tiles x
//   splits reach the 132 SMs: a call with few rows (MQA cross at B0 = 2:
//   2 rows x 8 query tiles) splits its keys, one with enough rows (self
//   3000, cross 300, MQA cross 25 x 8) does not. When t lives on the device,
//   a block whose chunk starts past t reads no K/V and contributes an empty
//   partial;
// - small NQ (self, G <= 4; fp32 at any NQ): `decode_vec_kernel`. LPK = D /
//   (16 bytes) lanes hold one key as 16-byte loads in its own dtype (eight
//   lanes x 8 bf16 cover D = 64, so a warp scores 4 keys a round by
//   shuffles); U rounds of loads are issued before the first is used. Each
//   lane group keeps its own online softmax over its keys; groups and warps
//   merge once, at the end;
// - NQ >= 8 in bf16 (cross N = 10, MQA 120): `decode_mma_kernel`. 16 query
//   rows a block as mma.sync.m16n8k16 A fragments; each warp walks 16-key
//   tiles of its chunk through a two-stage cp.async ring of its own and runs
//   S = Q K^T and O += P V on the tensor cores (mma_tile.cuh), with P rounded
//   to bf16 as the operand;
// - the combine: a block merges its warps' partials (max, sum, unnormalised
//   output) in warp order. With one split it writes the output; else it
//   writes its partial to fp32 scratch and bumps the row's arrival counter,
//   and the block that arrives last folds the splits in split order, writes
//   the output and sets the counter back to 0, loading every slot it needs
//   before it uses one. One launch a call, no memset, and the same bits
//   whichever block arrives last.

#include <cuda_bf16.h>
#include <math.h>

#include <algorithm>

#include "kernels.h"
#include "mma_tile.cuh"
#include "tile_io.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
// Blocks a launch aims at: one an SM. Splits beyond that measured slower on
// the H100 (PERF.md, section 6): the combine costs more than the extra blocks
// gain.
constexpr int TARGET_BLOCKS = 132;
constexpr int U = 2;                    // key rounds in flight together (vec kernel)
constexpr int KT = 16;                  // keys a tile (mma kernel)
constexpr int STAGES = 2;               // K/V tiles in flight a warp (mma kernel)
constexpr int MMA_MIN_NQ = 8;
constexpr int MAX_SPLITS = 16;
constexpr float LOG2E = 1.4426950408889634f;

// The warps' partials of QR query rows, in shared memory: running max (log2
// units), denominator and unnormalised output; `last` is the block's turn,
// and the last block of a row keeps the splits' weights and 1 / sum here.
template <int D, int QR>
struct Merge {
  float m[WARPS][QR];
  float l[WARPS][QR];
  float acc[WARPS][QR][D];
  float w[MAX_SPLITS][QR];
  float inv[QR];
  int last;
};

// Merges the block's warps in `mg` and writes the result: normalised to
// `out` when the row has one split, else to this split's slot of `part`, and
// the last split of the row to arrive folds all slots in split order.
template <typename T, int D, int QR>
__device__ void finish(Merge<D, QR>& mg, float* __restrict__ part, int* __restrict__ count,
                       T* __restrict__ out, int rq, int split, int splits, int r, int q0,
                       int nq) {
  __syncthreads();
  const int nrow = min(QR, nq - q0);
  T* o = out + ((size_t)r * nq + q0) * D;
  float* slots = part + (size_t)rq * splits * QR * (D + 2);
  for (int i = threadIdx.x; i < nrow * D; i += THREADS) {
    const int row = i / D, c = i % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, mg.m[w][row]);
    float l = 0.f, a = 0.f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float f = exp2f(mg.m[w][row] - mx);
        l = fmaf(f, mg.l[w][row], l);
        a = fmaf(f, mg.acc[w][row][c], a);
      }
    }
    if (splits == 1) {
      store(o + row * D + c, l > 0.f ? a / l : 0.f);
    } else {
      float* slot = slots + ((size_t)split * QR + row) * (D + 2);
      slot[c] = a;
      if (c == 0) slot[D] = mx, slot[D + 1] = l;
    }
  }
  if (splits == 1) return;
  __threadfence();  // the slot is visible before the counter says so
  __syncthreads();
  if (threadIdx.x == 0) mg.last = atomicAdd(count + rq, 1) == splits - 1;
  __syncthreads();
  if (!mg.last) return;
  __threadfence();
  // every load of a pass is issued before its first use: the slots are in L2
  for (int row = threadIdx.x; row < nrow; row += THREADS) {
    float ms[MAX_SPLITS], ls[MAX_SPLITS], mx = -INFINITY;
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s) {
      const float* slot = slots + ((size_t)s * QR + row) * (D + 2);
      ms[s] = s < splits ? __ldcg(slot + D) : -INFINITY;
      ls[s] = s < splits ? __ldcg(slot + D + 1) : 0.f;
      mx = fmaxf(mx, ms[s]);
    }
    float l = 0.f;
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s) {
      const float f = mx == -INFINITY ? 0.f : exp2f(ms[s] - mx);
      mg.w[s][row] = f;
      l = fmaf(f, ls[s], l);
    }
    mg.inv[row] = l > 0.f ? 1.f / l : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nrow * D; i += THREADS) {
    const int row = i / D, c = i % D;
    float a = 0.f;
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s)
      if (s < splits) a = fmaf(mg.w[s][row], __ldcg(slots + ((size_t)s * QR + row) * (D + 2) + c), a);
    store(o + row * D + c, a * mg.inv[row]);
  }
  if (threadIdx.x == 0) count[rq] = 0;
}

// Block (row, query tile, split) from the flat block index.
struct Tile {
  int rq, split, r, q0, k0, k1;
};

__device__ __forceinline__ Tile tile_of(int qrows, int qtiles, int splits, int chunk,
                                        const int32_t* t_ptr, int t_val, int L) {
  Tile b;
  b.split = blockIdx.x % splits;
  b.rq = blockIdx.x / splits;
  b.r = b.rq / qtiles;
  b.q0 = (b.rq % qtiles) * qrows;
  const int t = t_ptr ? *t_ptr : t_val;
  const int kv_len = max(0, min(L, t + 1));  // keys [0, kv_len) are live
  b.k0 = b.split * chunk;
  b.k1 = min(kv_len, b.k0 + chunk);
  return b;
}

// Small NQ, and fp32 at any NQ: CUDA cores, QV query rows a block.
template <typename T, int D, int QV>
__global__ void __launch_bounds__(THREADS)
decode_vec_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const uint8_t* __restrict__ mask, const int32_t* __restrict__ t_ptr,
                  int t_val, T* __restrict__ out, float* __restrict__ part,
                  int* __restrict__ count, int nq, int L, int mask_div, float scale_log2,
                  int qtiles, int splits, int chunk) {
  constexpr int VEC = 16 / sizeof(T);   // values a 16-byte load
  constexpr int LPK = D / VEC;          // lanes a key
  constexpr int GPW = 32 / LPK;         // keys a warp a round
  constexpr int ROUND = WARPS * GPW;    // keys a block a round
  extern __shared__ uint4 smem[];
  Merge<D, QV>& mg = *reinterpret_cast<Merge<D, QV>*>(smem);

  const Tile b = tile_of(QV, qtiles, splits, chunk, t_ptr, t_val, L);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane / LPK, sub = lane % LPK;
  const T* kr = k + (size_t)b.r * L * D + sub * VEC;
  const T* vr = v + (size_t)b.r * L * D + sub * VEC;
  const uint8_t* mr = mask ? mask + (size_t)(b.r / mask_div) * L : nullptr;

  float qf[QV][VEC], acc[QV][VEC], m[QV], l[QV];
#pragma unroll
  for (int i = 0; i < QV; ++i) {
    if (b.q0 + i < nq) {
      load_vec(q + ((size_t)b.r * nq + b.q0 + i) * D + sub * VEC, qf[i]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) qf[i][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) qf[i][e] *= scale_log2, acc[i][e] = 0.f;
    m[i] = -INFINITY;
    l[i] = 0.f;
  }

  for (int j0 = b.k0; j0 < b.k1; j0 += U * ROUND) {
    float kv[U][VEC], vv[U][VEC];
    bool live[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * ROUND + warp * GPW + grp;
      live[u] = j < b.k1 && (mr == nullptr || mr[j]);
      if (live[u]) {
        load_vec(kr + (size_t)j * D, kv[u]);
        load_vec(vr + (size_t)j * D, vv[u]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kv[u][e] = 0.f, vv[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < QV; ++i) {
      float s[U], smax = -INFINITY;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) dot = fmaf(qf[i][e], kv[u][e], dot);
#pragma unroll
        for (int off = LPK / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        s[u] = live[u] ? dot : -INFINITY;
        smax = fmaxf(smax, s[u]);
      }
      const float mn = fmaxf(m[i], smax);
      if (mn == -INFINITY) continue;  // no live key yet in this group
      const float alpha = exp2f(m[i] - mn);
      l[i] *= alpha;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[i][e] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = exp2f(s[u] - mn);
        l[i] += p;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[i][e] = fmaf(p, vv[u][e], acc[i][e]);
      }
      m[i] = mn;
    }
  }

  // the warp's GPW lane groups merge into group 0
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1) {
#pragma unroll
    for (int i = 0; i < QV; ++i) {
      const float om = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float ol = __shfl_xor_sync(0xffffffffu, l[i], off);
      float oacc[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) oacc[e] = __shfl_xor_sync(0xffffffffu, acc[i][e], off);
      const float mn = fmaxf(m[i], om);
      const float fa = mn == -INFINITY ? 0.f : exp2f(m[i] - mn);
      const float fb = mn == -INFINITY ? 0.f : exp2f(om - mn);
      l[i] = l[i] * fa + ol * fb;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[i][e] = acc[i][e] * fa + oacc[e] * fb;
      m[i] = mn;
    }
  }
  if (grp == 0) {
#pragma unroll
    for (int i = 0; i < QV; ++i) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) mg.acc[warp][i][sub * VEC + e] = acc[i][e];
      if (sub == 0) mg.m[warp][i] = m[i], mg.l[warp][i] = l[i];
    }
  }
  finish<T, D, QV>(mg, part, count, out, b.rq, b.split, splits, b.r, b.q0, nq);
}

// Starts the copy of keys [j0, j0 + KT) below k1 of cache row r into one
// warp's K and V tiles (rows past k1 become zeros).
template <int D>
__device__ __forceinline__ void load_kv_tile(bf16* kt, bf16* vt, const bf16* __restrict__ k,
                                             const bf16* __restrict__ v, size_t row_base,
                                             int j0, int k1, int lane) {
  constexpr int CH = D / 8;
#pragma unroll
  for (int c = lane; c < KT * CH; c += 32) {
    const int row = c / CH, ch = c % CH;
    const bool valid = j0 + row < k1;
    const size_t off = (row_base + (valid ? j0 + row : 0)) * D + ch * 8;
    cp_async_16(chunk_ptr<D>(kt, row, ch), k + off, valid);
    cp_async_16(chunk_ptr<D>(vt, row, ch), v + off, valid);
  }
}

// NQ >= 8 in bf16: tensor cores, 16 query rows a block, the block's chunk of
// keys dealt out to the warps in 16-key tiles.
template <int D>
__global__ void __launch_bounds__(THREADS)
decode_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                  const int32_t* __restrict__ t_ptr, int t_val, bf16* __restrict__ out,
                  float* __restrict__ part, int* __restrict__ count, int nq, int L,
                  int mask_div, float scale_log2, int qtiles, int splits, int chunk) {
  constexpr int CH = D / 8;
  constexpr int TILE = KT * D;  // bf16 of one 16-key tile
  extern __shared__ uint4 smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bf16* qs = reinterpret_cast<bf16*>(smem);      // 16 query rows
  bf16* ring = qs + KT * D + warp * 2 * STAGES * TILE;  // this warp's [stage][K, V]
  Merge<D, KT>& mg = *reinterpret_cast<Merge<D, KT>*>(smem);  // after the loop

  const Tile b = tile_of(KT, qtiles, splits, chunk, t_ptr, t_val, L);
  const uint8_t* mr = mask ? mask + (size_t)(b.r / mask_div) * L : nullptr;
  for (int c = threadIdx.x; c < KT * CH; c += THREADS) {
    const int row = c / CH, ch = c % CH;
    const bool valid = b.q0 + row < nq;
    cp_async_16(chunk_ptr<D>(qs, row, ch),
                q + ((size_t)b.r * nq + (valid ? b.q0 + row : 0)) * D + ch * 8, valid);
  }
  cp_async_commit();
  // the warp's first K/V tiles are in flight while the query tile lands
  const int tiles = b.k1 > b.k0 ? (b.k1 - b.k0 + KT - 1) / KT : 0;
  const int mine = tiles > warp ? (tiles - warp + WARPS - 1) / WARPS : 0;
  const size_t row_base = (size_t)b.r * L;
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < mine)
      load_kv_tile<D>(ring + i * 2 * TILE, ring + (i * 2 + 1) * TILE, k, v, row_base,
                      b.k0 + (warp + i * WARPS) * KT, b.k1, lane);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 1>();
  __syncthreads();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) load_a<D>(qa[kk], qs, 0, kk, lane);

  float acc[D / 8][4] = {};
  float mrow[2] = {-INFINITY, -INFINITY}, lsum[2] = {0.f, 0.f};
  for (int i = 0; i < mine; ++i) {
    const int j0 = b.k0 + (warp + i * WARPS) * KT;
    if (i + STAGES - 1 < mine) {
      bf16* nt = ring + ((i + STAGES - 1) % STAGES) * 2 * TILE;
      load_kv_tile<D>(nt, nt + TILE, k, v, row_base, j0 + (STAGES - 1) * WARPS * KT, b.k1,
                      lane);
    }
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncwarp();
    const bf16* kt = ring + (i % STAGES) * 2 * TILE;
    const bf16* vt = kt + TILE;
    float s[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t f[4];  // b0, b1 of keys 0..7, then of keys 8..15
      ldmatrix_x4(f, chunk_ptr<D>(kt, (lane & 7) + ((lane >> 4) << 3), 2 * kk + ((lane >> 3) & 1)));
      mma_bf16(s[0], qa[kk], f[0], f[1]);
      mma_bf16(s[1], qa[kk], f[2], f[3]);
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + 8 * n + 2 * (lane & 3) + (e & 1);
        const bool live = j < b.k1 && (mr == nullptr || mr[j]);
        s[n][e] = live ? s[n][e] * scale_log2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mn = fmaxf(mrow[h], quad_max(mx[h]));
      alpha[h] = mn == -INFINITY ? 1.f : exp2f(mrow[h] - mn);
      mrow[h] = mn;
      lsum[h] *= alpha[h];
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mh = mrow[e >> 1];
        const float p = mh == -INFINITY ? 0.f : exp2f(s[n][e] - mh);
        s[n][e] = p;
        lsum[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0], acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1], acc[n][3] *= alpha[1];
    }
    uint32_t pa[1][4];
    pack_a<1>(pa, s);
    mma_p_b<D, 1>(acc, pa, vt, 0, lane);
    __syncwarp();  // this stage is read before the next copy into it
  }
  cp_async_wait<0>();

  const float l0 = quad_sum(lsum[0]), l1 = quad_sum(lsum[1]);
  __syncthreads();  // every warp is done with the tiles that `mg` overlays
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    mg.acc[warp][g][8 * n + 2 * tq] = acc[n][0];
    mg.acc[warp][g][8 * n + 2 * tq + 1] = acc[n][1];
    mg.acc[warp][g + 8][8 * n + 2 * tq] = acc[n][2];
    mg.acc[warp][g + 8][8 * n + 2 * tq + 1] = acc[n][3];
  }
  if (tq == 0) {
    mg.m[warp][g] = mrow[0], mg.l[warp][g] = l0;
    mg.m[warp][g + 8] = mrow[1], mg.l[warp][g + 8] = l1;
  }
  finish<bf16, D, KT>(mg, part, count, out, b.rq, b.split, splits, b.r, b.q0, nq);
}

// The launch's shape: which kernel, its query rows a block, query tiles and
// key splits of `chunk` keys each.
struct Plan {
  bool mma;
  int qrows, qtiles, splits, chunk;
};

Plan plan(int rows, int nq, int L, int D, int t_val, bool t_on_device, bool bf16) {
  Plan p;
  p.mma = bf16 && nq >= MMA_MIN_NQ;
  p.qrows = p.mma ? KT : nq == 1 ? 1 : nq == 2 ? 2 : 4;
  p.qtiles = (nq + p.qrows - 1) / p.qrows;
  const int vec = bf16 ? 8 : 4;
  const int gran = p.mma ? KT : U * WARPS * (32 / (D / vec));
  const int kv = t_on_device ? L : std::max(0, std::min(L, t_val + 1));
  const int base = std::max(1, rows * p.qtiles);
  int splits = std::min((TARGET_BLOCKS + base - 1) / base, (kv + gran - 1) / gran);
  splits = std::max(1, std::min(splits, MAX_SPLITS));
  p.chunk = std::max(gran, ((kv + splits - 1) / splits + gran - 1) / gran * gran);
  p.splits = std::max(1, (kv + p.chunk - 1) / p.chunk);
  return p;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int D, int QV>
cudaError_t launch_vec(const void* q, const void* k, const void* v, const uint8_t* mask,
                       const int32_t* t_ptr, int t_val, void* out, float* part, int* count,
                       int nq, int L, int mask_div, float scale_log2, const Plan& p,
                       int blocks, cudaStream_t stream) {
  const size_t smem = sizeof(Merge<D, QV>);
  const cudaError_t err = allow_smem(decode_vec_kernel<T, D, QV>, smem);
  if (err != cudaSuccess) return err;
  decode_vec_kernel<T, D, QV><<<blocks, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, mask, t_ptr, t_val, (T*)out, part, count, nq,
      L, mask_div, scale_log2, p.qtiles, p.splits, p.chunk);
  return cudaSuccess;
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, const uint8_t* mask,
                     const int32_t* t_ptr, int t_val, void* out, float* part, int* count,
                     int nq, int L, int mask_div, float scale_log2, const Plan& p, int blocks,
                     cudaStream_t stream) {
  if (p.mma) {
    const size_t smem = std::max(sizeof(Merge<D, KT>),
                                 sizeof(bf16) * (size_t)(1 + 2 * STAGES * WARPS) * KT * D);
    const cudaError_t err = allow_smem(decode_mma_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    decode_mma_kernel<D><<<blocks, THREADS, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, mask, t_ptr, t_val, (bf16*)out, part,
        count, nq, L, mask_div, scale_log2, p.qtiles, p.splits, p.chunk);
    return cudaSuccess;
  }
  if (p.qrows == 1)
    return launch_vec<T, D, 1>(q, k, v, mask, t_ptr, t_val, out, part, count, nq, L,
                               mask_div, scale_log2, p, blocks, stream);
  if (p.qrows == 2)
    return launch_vec<T, D, 2>(q, k, v, mask, t_ptr, t_val, out, part, count, nq, L,
                               mask_div, scale_log2, p, blocks, stream);
  return launch_vec<T, D, 4>(q, k, v, mask, t_ptr, t_val, out, part, count, nq, L, mask_div,
                             scale_log2, p, blocks, stream);
}

}  // namespace

void decode_attention_scratch(int rows, int nq, int L, int D, int t_val, bool t_on_device,
                              bool bf16, int64_t* partial_floats, int64_t* counters) {
  const Plan p = plan(rows, nq, L, D, t_val, t_on_device, bf16);
  const bool split = p.splits > 1;
  *partial_floats = split ? (int64_t)rows * p.qtiles * p.splits * p.qrows * (D + 2) : 0;
  *counters = split ? (int64_t)rows * p.qtiles : 0;
}

cudaError_t decode_attention_launch(const void* q, const void* k, const void* v,
                                    const uint8_t* mask, const int32_t* t_ptr, int t_val,
                                    void* out, float* partials, int* counters, int rows,
                                    int nq, int L, int D, int mask_div, float scale,
                                    bool bf16, cudaStream_t stream) {
  if ((D != 64 && D != 128) || nq > DECODE_MAX_NQ) return cudaErrorInvalidValue;
  if (rows <= 0 || nq <= 0) return cudaSuccess;
  const Plan p = plan(rows, nq, L, D, t_val, t_ptr != nullptr, bf16);
  const int blocks = rows * p.qtiles * p.splits;
  const float sl = scale * LOG2E;
  if (bf16) {
    if (D == 64)
      return launch_d<__nv_bfloat16, 64>(q, k, v, mask, t_ptr, t_val, out, partials, counters, nq, L,
                                mask_div, sl, p, blocks, stream);
    return launch_d<__nv_bfloat16, 128>(q, k, v, mask, t_ptr, t_val, out, partials, counters, nq, L,
                               mask_div, sl, p, blocks, stream);
  }
  if (D == 64)
    return launch_d<float, 64>(q, k, v, mask, t_ptr, t_val, out, partials, counters, nq, L,
                               mask_div, sl, p, blocks, stream);
  return launch_d<float, 128>(q, k, v, mask, t_ptr, t_val, out, partials, counters, nq, L,
                              mask_div, sl, p, blocks, stream);
}
