// The int8 tensor-core product of the port's quantized kernels: one warp
// computes a 16x8 int32 tile D += A (16x32 int8, row-major) · B (32x8
// int8, column-major) with mma.sync.aligned.m16n8k32 (sm_80 and later).
//
// Fragments, per lane (g = lane / 4, t = lane % 4), as the PTX ISA lays
// them out for m16n8k32 with .s8 operands:
//   a[0] = A[g    ][4t .. 4t+3]     a[1] = A[g + 8][4t .. 4t+3]
//   a[2] = A[g    ][16+4t .. +3]    a[3] = A[g + 8][16+4t .. +3]
//   b[0] = B[4t .. 4t+3][g]         b[1] = B[16+4t .. +3][g]
//   d[0], d[1] = D[g][2t], D[g][2t+1]; d[2], d[3] = D[g+8][2t], D[g+8][2t+1]
// with the lowest k in the lowest byte of each 32-bit register. The sums
// are exact int32 (|a|, |b| <= 127: no overflow below K = 2^17), so they
// equal any other order of summation bit for bit.
#pragma once
#include <stdint.h>

namespace repro_torch {

__device__ inline void mma_s8_16x8x32(int (&d)[4], const uint32_t (&a)[4],
                                      const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The A fragment of rows r0 .. r0+15, depth k0 .. k0+31, of an int8
// matrix in shared memory, row-major at a row stride of `ld` bytes (a
// multiple of 4; ld = 16 mod 32 keeps the loads free of bank conflicts).
__device__ inline void mma_load_a(uint32_t (&a)[4],
                                  const int8_t* __restrict__ m, int ld,
                                  int r0, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int8_t* p = m + (r0 + g) * ld + k0 + 4 * t;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * ld);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 16);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * ld + 16);
}

// The B fragment of output columns c0 .. c0+7, depth k0 .. k0+31, of an
// int8 matrix stored transposed in shared memory (row c holds column c's
// depth, at a row stride of `ld` bytes, as for mma_load_a).
__device__ inline void mma_load_b(uint32_t (&b)[2],
                                  const int8_t* __restrict__ wt, int ld,
                                  int c0, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int8_t* p = wt + (c0 + g) * ld + k0 + 4 * t;
  b[0] = *reinterpret_cast<const uint32_t*>(p);
  b[1] = *reinterpret_cast<const uint32_t*>(p + 16);
}

// The B fragment of output columns c0 .. c0+7, depth k0 .. k0+31, gathered
// byte by byte from a row-major (K, N) int8 matrix in shared memory at a
// row stride of `ld` bytes (the layout the weights have in device memory,
// so they are staged as they are); k >= kmax or c >= nmax reads 0, which
// zero-pads the depth to the MMA's 32 and the width to its 8.
__device__ inline void mma_gather_b(uint32_t (&b)[2],
                                    const int8_t* __restrict__ w, int ld,
                                    int kmax, int nmax, int k0, int c0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int c = c0 + g;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t v = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + 16 * h + 4 * t + i;
      const uint32_t byte =
          (k < kmax && c < nmax) ? (uint32_t)(uint8_t)w[k * ld + c] : 0u;
      v |= byte << (8 * i);
    }
    b[h] = v;
  }
}

}  // namespace repro_torch
