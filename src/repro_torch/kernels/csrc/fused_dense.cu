// fused_dense: y = act(x @ w + b) in f32, for Hopper (sm_90a).
//
// Replaces: repro/kernels/fused_dense.py — fused_dense_pallas (the
// flattened and looped variants) and fused_dense_batched_pallas, whose
// batched form the wrapper row-packs into one (B*M, K) launch.
//
// Bound on this card: memory. The main path's products are (256, K<=108)
// by (K, N<=64): about 2*M*K*N = 2.1 MFLOP against 40-150 KB moved, far
// under the f32 rate's ridge, and each launch takes microseconds against
// a bound of tens of nanoseconds, so the launch itself is the cost.
//
// Design: one CTA of 256 threads per 32x64 output tile, x and w tiles of
// depth 16 staged in shared memory, each thread accumulating a 2x4
// block in registers. Any M, K, N: the kernel masks the ragged edges
// itself (loads outside the operands read 0, stores outside are
// skipped, and the last K tile stops at K). Full f32, no TF32 and no
// tensor cores: each output sums its K products in order k = 0..K-1,
// then adds the bias and applies the activation in the epilogue. Built
// with -fmad=false, so products and sums round separately, in the same
// order as the plain version (kernels/ref.py:fused_dense_ref), which
// therefore reproduces this kernel's bits. Tensor cores (wgmma) and a
// persistent schedule are for a later, faster version.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 32;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 2;   // rows per thread
constexpr int TN = 4;   // columns per thread (16 x 16 threads)

__global__ void __launch_bounds__(256)
fused_dense_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ b, float* __restrict__ y,
                   int M, int K, int N, int relu) {
  __shared__ float xs[BM][BK + 1];
  __shared__ float ws[BK][BN];
  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile: BM*BK = 512 values, two per thread
    for (int e = tid; e < BM * BK; e += 256) {
      int r = e / BK, c = e % BK;
      int gr = row0 + r, gc = k0 + c;
      xs[r][c] = (gr < M && gc < K) ? x[(size_t)gr * K + gc] : 0.0f;
    }
    // w tile: BK*BN = 1024 values, four per thread
    for (int e = tid; e < BK * BN; e += 256) {
      int r = e / BN, c = e % BN;
      int gr = k0 + r, gc = col0 + c;
      ws[r][c] = (gr < K && gc < N) ? w[(size_t)gr * N + gc] : 0.0f;
    }
    __syncthreads();
    const int kt = min(BK, K - k0);
    for (int kk = 0; kk < kt; ++kk) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float a = xs[tr + 16 * i][kk];
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += a * ws[kk][tc + 16 * j];
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
      float v = acc[i][j];
      if (b != nullptr) v += b[gc];
      if (relu) v = v > 0.0f ? v : 0.0f;
      y[(size_t)gr * N + gc] = v;
    }
  }
}

}  // namespace

// x:(M,K) w:(K,N) b:(N,) or null, y:(M,N); all f32, contiguous, on the
// device of `stream`. act: 0 = none, 1 = relu.
extern "C" int fused_dense_f32(const float* x, const float* w,
                               const float* b, float* y, int M, int K, int N,
                               int act, void* stream) {
  if (M > 0 && N > 0) {
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    fused_dense_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
        x, w, b, y, M, K, N, act);
  }
  return (int)cudaGetLastError();
}
