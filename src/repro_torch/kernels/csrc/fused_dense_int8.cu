// fused_dense_int8: the quantized dense for Hopper (sm_90a).
//
//   acc = x_q @ w_q                       (int8 x int8 -> exact int32)
//   y   = act(acc * (x_scale * w_scale[c]) + b[c])          (f32)
//   act: none, relu, gelu or silu (activation.cuh)
//   out = y, or clip(rint(y / out_scale), -127, 127) as int8
//
// Replaces: repro/kernels/fused_dense.py — fused_dense_int8_pallas (its
// looped grid with an int32 VMEM accumulator and the dequant/requant
// epilogue), for the flattened and the row-packed batched forms alike.
//
// Bound on this card: latency. The paths' products are (128-256, K) by
// (K, N <= 64) int8 with K = 4, 32, 64 or 128: at most 2*M*K*N = 2.1 M
// integer operations (1 ns at the 1,979 TOPS int8 tensor-core rate)
// against 9-87 KB moved (3-26 ns at 3.35 TB/s), while a launch costs
// microseconds. The first version (32x64 output tiles, 8 CTAs for a
// (256, K)->64 product; each 32-deep K tile gathered byte by byte and
// transposed into words between two barriers; __dp4a) took 3.7-7.9 us
// a launch, up to twice torch._int_mm's product alone.
//
// Design: 32x16 output tiles by default, one CTA of 4 warps each, every
// warp one 16x8 tile of the int8 tensor cores (mma.sync m16n8k32,
// mma_s8.cuh): 32 CTAs for a (256, K)->64 product. A narrow output (the
// merged head's N = 7) keeps 8 CTAs for 256 rows: 16-row tiles, twice
// the CTAs, measured slower. The CTA tile is a template parameter and
// the C entry takes it as a code (kernels/fused_dense.py:INT8_TILES),
// the tuner's knob: 0 = 32x16 (the default), 1 = 16x16 (twice the CTAs
// of 2 warps, for shapes whose CTAs do not fill the card), 2 = 64x16
// (half the CTAs of 8 warps, each w slab staged once for 64 rows) and
// 3 = 32x32 (half the CTAs of 8 warps, each x slab staged once for 32
// columns); a CTA runs (BM/16)(BN/8) warps, each one m16n8k32 tile. A
// CTA stages up to 128 of K in one
// round trip: its rows of x as 16-byte vectors where K is a multiple
// of 16 (else words, else bytes), and its columns of w as 16-byte
// vectors per k where N is a multiple of 16 (else bytes), as w lies in
// device memory; the weights' fragments are gathered from there with
// every k >= K and column >= N read as 0, which zero-pads K to the MMA's
// depth of 32 (x's padding is never written: it meets those zeros). The
// scales and biases of a lane's two columns load while the operands do.
// Any M, K, N: a longer K loops over 128-deep slices, rows and columns
// past M and N are not stored (the merged head has N = 7). Integer sums
// are exact in any order, so the accumulators equal the plain version's
// (kernels/ref.py:fused_dense_int8_ref) bitwise under every tile. The epilogue keeps the
// reference's order of rounded f32 operations — scale = x_scale *
// w_scale[c], y = (float)acc * scale, y + b, the activation, then
// rint(y / out_scale) (ties to even; the quotient rounded as the IEEE
// division rounds it, int8_quant.cuh) clamped to +-127 — and the build's
// -fmad=false keeps the product and the bias add apart. Under gelu and
// silu the activation rounds as CUDA's tanhf and expf do: the f32 output
// is then within the float32 row of the plain version, and a requantized
// one may sit a step away where y lies by a rounding at a half step.
#include <cuda_runtime.h>
#include <stdint.h>

#include "activation.cuh"
#include "int8_quant.cuh"
#include "mma_s8.cuh"

namespace {

using repro_torch::mma_gather_b;
using repro_torch::mma_load_a;
using repro_torch::mma_s8_16x8x32;
using repro_torch::quotient;
using repro_torch::quotient_exact;
using repro_torch::round_clip_s8;

constexpr int KC = 128;         // depth staged per round trip
constexpr int LDX = KC + 16;    // x tile's row stride: 16 mod 32 bytes

__device__ inline bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// A CTA computes a BM x BN output tile: (BM/16)(BN/8) warps, each one
// 16x8 MMA tile.
template <int BM, int BN>
__global__ void __launch_bounds__(32 * (BM / 16) * (BN / 8))
fused_dense_int8_kernel(const int8_t* __restrict__ x,
                        const int8_t* __restrict__ w,
                        const float* __restrict__ b,
                        const float* __restrict__ w_scale, float x_scale,
                        void* __restrict__ y, int M, int K, int N, int act,
                        int out_int8, float out_scale) {
  constexpr int kNT = BN / 8;                 // MMA tiles across a row
  constexpr int kThreads = 32 * (BM / 16) * kNT;
  static_assert(BM % 16 == 0 && BN % 16 == 0, "16-row, 16-column tiles");
  __shared__ __align__(16) int8_t xs[BM * LDX];
  __shared__ __align__(16) int8_t wsm[KC * BN];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int rows = min(BM, M - row0), cols = min(BN, N - col0);
  const int mt = warp / kNT, nt = warp % kNT;

  // this lane's two output columns: scale and bias
  float sc[2], bias[2];
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    const int c = nt * 8 + 2 * t + jj;
    sc[jj] = c < cols ? x_scale * w_scale[col0 + c] : 0.0f;
    bias[jj] = (b != nullptr && c < cols) ? b[col0 + c] : 0.0f;
  }

  const bool x16 = K % 16 == 0 && aligned(x, 16);
  const bool x4 = K % 4 == 0 && aligned(x, 4);
  const bool w16 = N % 16 == 0 && aligned(w, 16);
  int acc[4] = {0, 0, 0, 0};
  for (int kc = 0; kc < K; kc += KC) {
    const int kw = min(KC, K - kc);
    if (kc > 0) __syncthreads();      // the last slice's fragments are read
    const int8_t* xg = x + (size_t)row0 * K + kc;
    if (x16) {
      const int per = kw / 16;
      for (int e = tid; e < rows * per; e += kThreads) {
        const int r = e / per, v = e - r * per;
        *reinterpret_cast<int4*>(xs + r * LDX + 16 * v) =
            __ldg(reinterpret_cast<const int4*>(xg + (size_t)r * K) + v);
      }
    } else if (x4) {
      const int per = kw / 4;
      for (int e = tid; e < rows * per; e += kThreads) {
        const int r = e / per, v = e - r * per;
        *reinterpret_cast<int*>(xs + r * LDX + 4 * v) =
            __ldg(reinterpret_cast<const int*>(xg + (size_t)r * K) + v);
      }
    } else {
      for (int e = tid; e < rows * kw; e += kThreads) {
        const int r = e / kw, c = e - r * kw;
        xs[r * LDX + c] = xg[(size_t)r * K + c];
      }
    }
    const int8_t* wg = w + (size_t)kc * N + col0;
    if (w16) {       // cols is a multiple of 16 where N is
      const int per = cols / 16;
      for (int e = tid; e < kw * per; e += kThreads) {
        const int kk = e / per, v = e - kk * per;
        *reinterpret_cast<int4*>(wsm + kk * BN + 16 * v) =
            __ldg(reinterpret_cast<const int4*>(wg + (size_t)kk * N) + v);
      }
    } else {
      for (int e = tid; e < kw * cols; e += kThreads) {
        const int kk = e / cols, c = e - kk * cols;
        wsm[kk * BN + c] = wg[(size_t)kk * N + c];
      }
    }
    __syncthreads();
    for (int k0 = 0; k0 < kw; k0 += 32) {
      uint32_t a[4], bf[2];
      mma_load_a(a, xs, LDX, 16 * mt, k0);
      mma_gather_b(bf, wsm, BN, kw, cols, k0, 8 * nt);
      mma_s8_16x8x32(acc, a, bf);
    }
  }

  // the epilogue: dequantize, bias, activation; requantize as
  // int8_quant.cuh does, or by f32 divisions where its quotient is out of
  // range
  const double rd = 1.0 / (double)out_scale;
  float v[4], q[4];
  bool ok = true;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int jj = e & 1;
    v[e] = (float)acc[e] * sc[jj];
    if (b != nullptr) v[e] = v[e] + bias[jj];
    v[e] = repro_torch::activate(v[e], act);
    q[e] = quotient(v[e], rd);
    ok = ok && quotient_exact(v[e], q[e]);
  }
  if (out_int8 && !ok) {
#pragma unroll
    for (int e = 0; e < 4; ++e) q[e] = v[e] / out_scale;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = 16 * mt + g + 8 * (e >> 1), c = 8 * nt + 2 * t + (e & 1);
    if (r >= rows || c >= cols) continue;
    const size_t o = (size_t)(row0 + r) * N + col0 + c;
    if (out_int8)
      static_cast<int8_t*>(y)[o] = round_clip_s8(q[e]);
    else
      static_cast<float*>(y)[o] = v[e];
  }
}

template <int BM, int BN>
void launch(const int8_t* x, const int8_t* w, const float* b,
            const float* w_scale, float x_scale, void* y, int M, int K,
            int N, int act, int out_int8, float out_scale,
            cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  fused_dense_int8_kernel<BM, BN>
      <<<grid, 32 * (BM / 16) * (BN / 8), 0, stream>>>(
          x, w, b, w_scale, x_scale, y, M, K, N, act, out_int8, out_scale);
}

}  // namespace

// x:(M,K) int8, w:(K,N) int8, b:(N,) f32 or null, w_scale:(N,) f32,
// y:(M,N) f32 (out_int8 = 0) or int8 (out_int8 = 1); contiguous, on the
// device of `stream`. act: 0 = none, 1 = relu, 2 = gelu, 3 = silu. tile:
// the CTA's output tile, 0 = 32x16, 1 = 16x16, 2 = 64x16, 3 = 32x32
// (kernels/fused_dense.py:INT8_TILES); any other code is
// cudaErrorInvalidValue.
extern "C" int fused_dense_int8_ex(const int8_t* x, const int8_t* w,
                                   const float* b, const float* w_scale,
                                   float x_scale, void* y, int M, int K,
                                   int N, int act, int out_int8,
                                   float out_scale, int tile,
                                   void* stream) {
  if (tile < 0 || tile > 3) return (int)cudaErrorInvalidValue;
  if (M > 0 && N > 0) {
    const cudaStream_t st = (cudaStream_t)stream;
#define REPRO_TILE(CODE, BM_, BN_)                                          \
  if (tile == CODE)                                                         \
    launch<BM_, BN_>(x, w, b, w_scale, x_scale, y, M, K, N, act, out_int8, \
                     out_scale, st);
    REPRO_TILE(0, 32, 16)
    REPRO_TILE(1, 16, 16)
    REPRO_TILE(2, 64, 16)
    REPRO_TILE(3, 32, 32)
#undef REPRO_TILE
  }
  return (int)cudaGetLastError();
}
