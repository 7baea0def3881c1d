// The operand and output types of the kernels' bf16 forms, shared by
// every source but flash_attention.cu (which has its own bf16 path).
//
// Counterpart of the Pallas kernels' ``.astype(jnp.float32)`` on each
// float operand and ``.astype(out_dtype)`` on the result (repro/kernels/
// fused_dense.py, gravnet.py, gravnet_block.py, knn_build.py,
// edge_aggregate.py). A kernel is templated on its float operands' type T
// (float or __nv_bfloat16) and its output's type O. It reads a bf16
// operand as bf16 from device memory and widens each value with
// __bfloat162float, which is exact, so the f32 arithmetic after it is
// the f32 form's unchanged (-fmad=false, the same order); it stores with
// __float2bfloat16_rn, round to nearest even, as Tensor.to(torch.bfloat16)
// and astype round. A bf16 form therefore stays bitwise with its plain
// version (kernels/ref.py: the f32 computation, one rounding at the end).
//
// Staging: cp.async copies bytes and cannot widen, so a bf16 operand is
// staged by ordinary vector loads of 16, 8, 4 or 2 bytes (the widest that
// the address, the row stride and the row length allow: a row of K = 70
// bf16 is 140 bytes, 4-byte aligned) into the same f32 shared memory the
// f32 form stages into (widen_all: every operand of a stage at once, 2
// to 8 vectors of each a thread in flight, so that their loads overlap).
// The shared-memory plans count 4-byte elements for both forms. The cost
// on the H100 against the f32 form's cp.async, which keeps no value in a
// register: +11-27 % a launch at the paths' shapes, more where a dense's
// K > 256 walks slabs (the next slab's loads no longer overlap the sums).
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {
namespace io {

using bf16 = __nv_bfloat16;

// The C entries' dtype codes (kernels/_build.py:DTYPE_CODES).
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The widest vector of bf16 (8, 4, 2 or 1 elements) that keeps every
// vector of a row of len elements inside the row (rows ld elements
// apart) and its source aligned to its size.
__host__ __device__ inline int bf16_width(const void* p, long long ld,
                                          int len) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  for (int v = 8; v > 1; v /= 2)
    if (a % (2 * v) == 0 && ld % v == 0 && len % v == 0) return v;
  return 1;
}

// The two bf16 of a 32-bit word (the lower address in the low half),
// widened.
__device__ __forceinline__ float2 widen2(uint32_t w) {
  __nv_bfloat162_raw r;
  r.x = static_cast<unsigned short>(w & 0xffffu);
  r.y = static_cast<unsigned short>(w >> 16);
  return __bfloat1622float2(__nv_bfloat162(r));
}

__device__ __forceinline__ void widen_pair(float* d, uint32_t w) {
  const float2 f = widen2(w);
  d[0] = f.x;
  d[1] = f.y;
}

// Four consecutive values from element 4 e of p (aligned to 4 elements),
// as a float4: one 16-byte load of f32, one 8-byte load of bf16.
__device__ __forceinline__ float4 load4(const float* p, int e) {
  return __ldg(reinterpret_cast<const float4*>(p) + e);
}
__device__ __forceinline__ float4 load4(const bf16* p, int e) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p) + e);
  const float2 a = widen2(u.x), b = widen2(u.y);
  return make_float4(a.x, a.y, b.x, b.y);
}

// One bf16 operand to stage: rows x cols of g (row stride ldg) into the
// f32 s (row stride lds), in vectors of v elements (bf16_width's answer
// for g, or a narrower one).
struct Widen {
  float* s;
  long long lds;
  const bf16* g;
  long long ldg;
  int rows, cols, v;
};

// A flat array of count elements.
__device__ inline Widen flat(float* s, const bf16* g, int count) {
  return Widen{s, 0, g, 0, 1, count, bf16_width(g, 0, count)};
}

// The raw bytes of vector i of an operand (v elements at the lower end).
__device__ __forceinline__ uint4 load_raw(const Widen& w, int i) {
  const int per_row = w.cols / w.v;
  const int r = i / per_row, c = (i - r * per_row) * w.v;
  const bf16* p = w.g + r * w.ldg + c;
  uint4 u = make_uint4(0u, 0u, 0u, 0u);
  if (w.v == 8) {
    u = __ldg(reinterpret_cast<const uint4*>(p));
  } else if (w.v == 4) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    u.x = t.x;
    u.y = t.y;
  } else if (w.v == 2) {
    u.x = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else {
    u.x = __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  return u;
}

// Vector i of an operand, widened, into its place in shared memory.
__device__ __forceinline__ void store_widened(const Widen& w, int i,
                                              const uint4& u) {
  const int per_row = w.cols / w.v;
  const int r = i / per_row, c = (i - r * per_row) * w.v;
  float* d = w.s + r * w.lds + c;
  const uint32_t word[4] = {u.x, u.y, u.z, u.w};
  if (w.v == 1) {
    __nv_bfloat16_raw one;
    one.x = static_cast<unsigned short>(u.x);
    d[0] = __bfloat162float(bf16(one));
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (2 * q < w.v) widen_pair(d + 2 * q, word[q]);
}

// Stages N bf16 operands at once by ordinary loads, each value widened
// exactly into its f32 place: each thread loads its next vectors of every
// operand (kInFlight of each) before it widens and stores them, so the
// loads of all the operands overlap: one round trip where every thread's
// share fits. The operands are indexed at compile time only (the loops
// over them unroll), so their descriptors and the loaded vectors stay in
// registers. The stores have landed once the caller's barrier is passed.
template <int N>
__device__ inline void widen_all(const Widen (&op)[N], int tid, int nt) {
  constexpr int kInFlight = N > 4 ? 2 : 8 / N;
  int count[N];
  int most = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    count[j] = op[j].rows * (op[j].cols / op[j].v);
    most = count[j] > most ? count[j] : most;
  }
  for (int i0 = tid; i0 < most; i0 += kInFlight * nt) {
    uint4 raw[N][kInFlight];
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        if (i0 + u * nt < count[j]) raw[j][u] = load_raw(op[j], i0 + u * nt);
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        if (i0 + u * nt < count[j])
          store_widened(op[j], i0 + u * nt, raw[j][u]);
  }
}

}  // namespace io
}  // namespace repro_torch

// A C entry's dispatch over the dtype codes of its float operands (IN)
// and output (OUT): runs the statement after them with T and O bound to
// the types, or returns cudaErrorInvalidValue for a code it does not
// know.
#define REPRO_DISPATCH_IO(IN, OUT, ...)                                   \
  do {                                                                     \
    using repro_torch::io::bf16;                                           \
    if ((IN) == repro_torch::io::kF32 && (OUT) == repro_torch::io::kF32) { \
      using T = float;                                                     \
      using O = float;                                                     \
      __VA_ARGS__;                                                         \
    }                                                                      \
    if ((IN) == repro_torch::io::kF32 && (OUT) == repro_torch::io::kBF16) {\
      using T = float;                                                     \
      using O = bf16;                                                      \
      __VA_ARGS__;                                                         \
    }                                                                      \
    if ((IN) == repro_torch::io::kBF16 && (OUT) == repro_torch::io::kF32) {\
      using T = bf16;                                                      \
      using O = float;                                                     \
      __VA_ARGS__;                                                         \
    }                                                                      \
    if ((IN) == repro_torch::io::kBF16 &&                                  \
        (OUT) == repro_torch::io::kBF16) {                                 \
      using T = bf16;                                                      \
      using O = bf16;                                                      \
      __VA_ARGS__;                                                         \
    }                                                                      \
    return (int)cudaErrorInvalidValue;                                     \
  } while (0)
