// Lane-exact host emulations of the PTX wrappers in the port's
// csrc/ptx_sm90.cuh, with the same names and signatures, for the threads of
// cuda_runtime.h beside this file. Fragment layouts are those of
// mma.sync.aligned.m16n8k16.row.col and ldmatrix.m8n8.x4 (g = lane / 4,
// t = lane % 4), written out here independently of the kernels' use of them
// (mma.sync.aligned.m16n8k8 in TF32 below mma_bf16):
//   A (16 x 16): a0 (row g, k 2t..2t+1), a1 (row g + 8, same k),
//                a2 (row g, k 2t + 8..), a3 (row g + 8, k 2t + 8..)
//   B (16 x 8):  b0 (k 2t..2t+1, column g), b1 (k 2t + 8.., column g)
//   C (16 x 8):  c0, c1 (row g, columns 2t, 2t + 1), c2, c3 (row g + 8)
//   ldmatrix: lanes 8i..8i+7 give the row addresses of matrix i; register i
//   holds matrix i's (row g, columns 2t..2t+1), with .trans its
//   (rows 2t..2t+1, column g).

#pragma once

#include <cuda_runtime.h>

namespace {

inline void cp_async(void* dst, const void* src, int bytes, bool valid) {
  if (reinterpret_cast<uintptr_t>(dst) % bytes ||
      (valid && reinterpret_cast<uintptr_t>(src) % bytes)) {
    std::fprintf(stderr, "emulation: cp.async of %d bytes is not aligned\n", bytes);
    std::abort();
  }
  const emulation::Copy c{dst, src, bytes, valid};
  if (emulation::eager_copies) emulation::carry_out(c);
  else emulation::current->open_group.push_back(c);
}

inline void cp_async_16(void* dst, const void* src, bool valid) { cp_async(dst, src, 16, valid); }
inline void cp_async_4(void* dst, const void* src, bool valid) { cp_async(dst, src, 4, valid); }

inline void cp_async_commit() {
  emulation::current->groups.push_back(emulation::current->open_group);
  emulation::current->open_group.clear();
}

template <int N>
inline void cp_async_wait() {
  while ((int)emulation::current->groups.size() > N) {
    for (const auto& c : emulation::current->groups.front()) emulation::carry_out(c);
    emulation::current->groups.pop_front();
  }
}

inline void ldmatrix(uint32_t (&r)[4], const void* p, bool trans) {
  auto& w = emulation::warp();
  const int l = emulation::lane(), g = l >> 2, t = l & 3;
  if (reinterpret_cast<uintptr_t>(p) % 16) {
    std::fprintf(stderr, "emulation: an ldmatrix row address is not 16-byte aligned\n");
    std::abort();
  }
  w.p[l] = p;
  w.bar.arrive_and_wait();
  for (int i = 0; i < 4; ++i) {
    if (!trans) {
      std::memcpy(&r[i], (const char*)w.p[8 * i + g] + 4 * t, 4);
    } else {
      uint16_t lo, hi;
      std::memcpy(&lo, (const char*)w.p[8 * i + 2 * t] + 2 * g, 2);
      std::memcpy(&hi, (const char*)w.p[8 * i + 2 * t + 1] + 2 * g, 2);
      r[i] = (uint32_t)lo | ((uint32_t)hi << 16);
    }
  }
  w.bar.arrive_and_wait();
}

inline void ldmatrix_x4(uint32_t (&r)[4], const void* p) { ldmatrix(r, p, false); }
inline void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) { ldmatrix(r, p, true); }

inline float bf16_lo(uint32_t u) {
  const uint32_t x = u << 16;
  float f;
  std::memcpy(&f, &x, 4);
  return f;
}

inline float bf16_hi(uint32_t u) {
  const uint32_t x = u & 0xffff0000u;
  float f;
  std::memcpy(&f, &x, 4);
  return f;
}

inline void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  auto& w = emulation::warp();
  const int l = emulation::lane(), g = l >> 2, t = l & 3;
  for (int i = 0; i < 4; ++i) w.a[l][i] = a[i];
  w.b[l][0] = b0, w.b[l][1] = b1;
  w.bar.arrive_and_wait();
  float A[16][16], B[16][8];  // the warp's operands, from every lane's registers
  for (int s = 0; s < 32; ++s) {
    const int sg = s >> 2, st = s & 3;
    for (int i = 0; i < 4; ++i) {
      const int row = sg + 8 * (i & 1), k = 2 * st + 8 * (i >> 1);
      A[row][k] = bf16_lo(w.a[s][i]), A[row][k + 1] = bf16_hi(w.a[s][i]);
    }
    for (int i = 0; i < 2; ++i) {
      B[2 * st + 8 * i][sg] = bf16_lo(w.b[s][i]), B[2 * st + 8 * i + 1][sg] = bf16_hi(w.b[s][i]);
    }
  }
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e >> 1), col = 2 * t + (e & 1);
    float sum = c[e];
    for (int k = 0; k < 16; ++k) sum += A[row][k] * B[k][col];
    c[e] = sum;
  }
  w.bar.arrive_and_wait();
}

// cvt.rna.tf32.f32: to 10 mantissa bits, to nearest, ties away from zero (a
// carry into the exponent is the next binade, past the largest finite value
// infinity); infinities and NaNs unchanged.
inline uint32_t cvt_tf32(float x) {
  uint32_t u;
  std::memcpy(&u, &x, 4);
  if ((u & 0x7f800000u) == 0x7f800000u) return u;
  return (u + 0x1000u) & 0xffffe000u;
}

// The value the tensor cores read from a TF32 operand register: its upper 19
// bits (sign, exponent, 10 mantissa bits).
inline float tf32_operand(uint32_t u) {
  u &= 0xffffe000u;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32. Fragments:
//   A (16 x 8): a0 (row g, k t), a1 (row g + 8, k t), a2 (row g, k t + 4),
//               a3 (row g + 8, k t + 4)
//   B (8 x 8):  b0 (k t, column g), b1 (k t + 4, column g)
//   C (16 x 8): as m16n8k16's. A product of two TF32 values is exact in fp32;
//   the sums are fp32, k in order.
// The operands go to one of two exchange areas by turns, so one barrier a
// call suffices: a lane writes an area again only after every lane has
// arrived at the next call's barrier, past its reads of that area.
inline void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  auto& w = emulation::warp();
  const int l = emulation::lane(), g = l >> 2, t = l & 3;
  const int x = w.tf32_calls[l]++ & 1;
  for (int i = 0; i < 4; ++i) w.ta[x][l][i] = a[i];
  w.tb[x][l][0] = b0, w.tb[x][l][1] = b1;
  w.bar.arrive_and_wait();
  float A[2][8], B[8][2];  // the rows and columns of this lane's accumulators
  for (int h = 0; h < 2; ++h)
    for (int k = 0; k < 8; ++k) {
      // A (row g + 8h, k) is register (h + 2 (k / 4)) of lane 4 g + k % 4
      A[h][k] = tf32_operand(w.ta[x][4 * g + (k & 3)][h + 2 * (k >> 2)]);
      // B (k, column 2t + h) is register k / 4 of lane 4 (2t + h) + k % 4
      B[k][h] = tf32_operand(w.tb[x][4 * (2 * t + h) + (k & 3)][k >> 2]);
    }
  for (int e = 0; e < 4; ++e) {
    float sum = c[e];
    for (int k = 0; k < 8; ++k) sum += A[e >> 1][k] * B[k][e & 1];
    c[e] = sum;
  }
}

inline float fast_exp2(float x) { return std::exp2(x); }

}  // namespace
