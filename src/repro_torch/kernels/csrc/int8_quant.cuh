// Quantization to int8 without an f32 division per value, bit for bit
// what clip(rint(v / s), -127, 127) gives with v / s an IEEE division.
// Shared by the int8 kernels (gravnet_block_int8.cu, fused_dense_int8.cu).
//
// Why: an f32 division compiles to a reciprocal, Newton steps and a
// branch to a slow-path call for operands its fast path cannot round, and
// those branches keep the compiler from overlapping one value's chain with
// the next; a CTA that quantizes its whole event spends microseconds in
// them (kernels/phase_split.py times it).
//
// How: the quotient is (float)((double)v * rd), rd = 1.0 / (double)s,
// rounded once per launch. The double result is within 2^-52 (relative)
// of v / s (two roundings at double precision). A quotient of two floats
// is never exactly halfway between two neighbouring normal floats (such a
// midpoint has 25 significant bits, and midpoint * s would too, but it
// equals v, which has 24), and when it is not a float itself it lies at
// least 2^-49 (relative) from every such midpoint (|v - m s| is a nonzero
// multiple of ulp(m) ulp(s)). So the double result rounds to the same
// float as v / s, overflow to infinity included; zeros, infinities and
// NaNs come out as the division gives them. The argument needs the
// normal range: a caller takes the division itself wherever
// quotient_exact says no (a nonzero v whose quotient is below 2^-125).
#pragma once
#include <stdint.h>

namespace repro_torch {

// v / s rounded to f32 as the IEEE division rounds it, given
// rd = 1.0 / (double)s, wherever quotient_exact(v, result) holds.
__device__ inline float quotient(float v, double rd) {
  return (float)((double)v * rd);
}

__device__ inline bool quotient_exact(float v, float q) {
  return v == 0.0f || !(fabsf(q) < 0x1p-125f);
}

// clip(rint(q), -127, 127) as an int8. Clipping before rounding gives
// the same for every q (NaN included: fmaxf returns -127, as after
// rintf); the clipped value plus 1.5 * 2^23 rounds half to even at the
// units (an exact add of an integer-spaced float) and leaves the integer
// in the low bits, so no F2I is needed.
__device__ inline int8_t round_clip_s8(float q) {
  const float c = fminf(fmaxf(q, -127.0f), 127.0f);
  return (int8_t)(__float_as_int(c + 12582912.0f) - 0x4B400000);
}

}  // namespace repro_torch
