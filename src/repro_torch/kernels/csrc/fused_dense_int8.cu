// fused_dense_int8: the quantized dense for Hopper (sm_90a).
//
//   acc = x_q @ w_q                       (int8 x int8 -> exact int32)
//   y   = act(acc * (x_scale * w_scale[c]) + b[c])          (f32)
//   out = y, or clip(rint(y / out_scale), -127, 127) as int8
//
// Replaces: repro/kernels/fused_dense.py — fused_dense_int8_pallas (its
// looped grid with an int32 VMEM accumulator and the dequant/requant
// epilogue), for the flattened and the row-packed batched forms alike.
//
// Bound on this card: memory. The paths' products are (128-256, K) by
// (K, N<=64) int8 with K = 4, 32, 64, or 128 (the unfused chain's
// lane-padded concat): at most 2*M*K*N = 2.1 M integer operations (1 ns
// at the 1,979 TOPS int8 tensor-core rate) against 9-87 KB moved
// (3-26 ns at 3.35 TB/s); each launch costs microseconds, so the launch
// and one CTA's dependent chain are what it pays.
//
// Design: the f32 fused_dense's tiling (one CTA of 256 threads per 32x64
// output tile, each thread a 2x4 block of outputs), with 32-deep K tiles
// of int8 staged in shared memory as packed 32-bit words — four
// consecutive k of a row of x, and four consecutive k of a column of w
// (the w tile is transposed on its way in) — and summed with __dp4a,
// four int8 products per instruction. Any M, K, N: loads outside the
// operands read 0, so K is zero-padded in shared memory up to the tile
// depth, and stores outside are skipped (the merged head has N = 7).
// Integer sums are exact in any order, so the accumulators equal the
// plain version's (kernels/ref.py:fused_dense_int8_ref) bitwise. The
// epilogue keeps the reference's order of rounded f32 operations —
// scale = x_scale * w_scale[c], y = (float)acc * scale, y + b, the
// activation, then rintf(y / out_scale) (ties to even, an IEEE
// division) clamped to +-127 — and the build's -fmad=false keeps the
// product and the bias add apart. int8 tensor cores (mma.sync s8) are
// for a later, faster version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;
constexpr int BN = 64;
constexpr int BK = 32;          // int8 values of K per tile
constexpr int BKW = BK / 4;     // packed words per tile row
constexpr int TM = 2;
constexpr int TN = 4;

__device__ inline int pack4(int8_t a, int8_t b, int8_t c, int8_t d) {
  return (int)((uint32_t)(uint8_t)a | ((uint32_t)(uint8_t)b << 8) |
               ((uint32_t)(uint8_t)c << 16) | ((uint32_t)(uint8_t)d << 24));
}

__global__ void __launch_bounds__(256)
fused_dense_int8_kernel(const int8_t* __restrict__ x,
                        const int8_t* __restrict__ w,
                        const float* __restrict__ b,
                        const float* __restrict__ w_scale, float x_scale,
                        void* __restrict__ y, int M, int K, int N, int relu,
                        int out_int8, float out_scale) {
  __shared__ int xs[BM][BKW + 1];
  __shared__ int wt[BN][BKW + 1];
  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    {  // x tile: BM*BKW = 256 words, one per thread
      const int r = tid / BKW, kw = tid % BKW;
      const int gr = row0 + r, gk = k0 + 4 * kw;
      int8_t v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        v[q] = (gr < M && gk + q < K) ? x[(size_t)gr * K + gk + q] : 0;
      xs[r][kw] = pack4(v[0], v[1], v[2], v[3]);
    }
    // w tile, transposed: BN*BKW = 512 words, two per thread
    for (int e = tid; e < BN * BKW; e += 256) {
      const int c = e % BN, kw = e / BN;
      const int gc = col0 + c, gk = k0 + 4 * kw;
      int8_t v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        v[q] = (gc < N && gk + q < K) ? w[(size_t)(gk + q) * N + gc] : 0;
      wt[c][kw] = pack4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < BKW; ++kw) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int a = xs[tr + 16 * i][kw];
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = __dp4a(a, wt[tc + 16 * j][kw], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + tr + 16 * i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + tc + 16 * j;
      if (gc >= N) continue;
      const float sc = x_scale * w_scale[gc];
      float v = (float)acc[i][j] * sc;
      if (b != nullptr) v = v + b[gc];
      if (relu) v = v > 0.0f ? v : 0.0f;
      const size_t o = (size_t)gr * N + gc;
      if (out_int8) {
        const float q = fminf(fmaxf(rintf(v / out_scale), -127.0f), 127.0f);
        static_cast<int8_t*>(y)[o] = (int8_t)(int)q;
      } else {
        static_cast<float*>(y)[o] = v;
      }
    }
  }
}

}  // namespace

// x:(M,K) int8, w:(K,N) int8, b:(N,) f32 or null, w_scale:(N,) f32,
// y:(M,N) f32 (out_int8 = 0) or int8 (out_int8 = 1); contiguous, on the
// device of `stream`. act: 0 = none, 1 = relu.
extern "C" int fused_dense_int8(const int8_t* x, const int8_t* w,
                                const float* b, const float* w_scale,
                                float x_scale, void* y, int M, int K, int N,
                                int act, int out_int8, float out_scale,
                                void* stream) {
  if (M > 0 && N > 0) {
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    fused_dense_int8_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
        x, w, b, w_scale, x_scale, y, M, K, N, act, out_int8, out_scale);
  }
  return (int)cudaGetLastError();
}
