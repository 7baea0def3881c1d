// knn_aggregate: Gaussian-potential mean/max over prebuilt neighbours,
// f32, for Hopper (sm_90a).
//
// Replaces: repro/kernels/knn_build.py — knn_aggregate_batched_pallas
// and knn_aggregate_pallas (the latter is this kernel at B = 1). It
// runs on the ragged path after each knn_build.
//
//   out_i = [ sum_t w_t f_idx[i,t] / k, max_t w_t f_idx[i,t] ],
//   w_t = exp(-scale d2[i,t]); a slot with d2 >= 0.5e30 weighs 0 and is
//   left out of the max; a max that stays at -1e30 becomes 0; an index
//   outside [0, n) selects a row of zeros, as the TPU kernel's one-hot
//   product does (and no read leaves the bin)
//
// Bound on this card: latency, far from either roofline. At the path
// shape, f (8,128,22) and 8 neighbours, a launch moves about 336 KB
// (100 ns at 3.35 TB/s) and needs at most 0.6 M f32 operations (9 ns at
// the 67 TFLOP/s rate outside the tensor cores). What it pays is one
// CTA's staging of the bin's features and k dependent rounds per row.
//
// Design: the accumulation half of the GravNet cell (gravnet_cell.cuh:
// cell_init, cell_accumulate, cell_finish), fed idx and d2 from device
// memory instead of from the selection rounds. The TPU kernel's one-hot
// matmul becomes a direct indexed load from shared memory. One CTA of
// 256 threads (8 warps) per (row block of bm query rows, bin) stages
// the bin's F in shared memory, with a row of zeros after it for
// out-of-range indices; each warp takes one query row at a
// time, reads its k (idx, d2) pairs (the same address in every lane, a
// broadcast), accumulates in slot order into a warp-private 2*d_f
// buffer and writes the row. bm = 32 gives 4 CTAs per bin at n = 128.
// Products and sums are rounded separately (-fmad=false), in the plain
// version's order, so kernels/ref.py:knn_aggregate_ref reproduces it.
#include <cuda_runtime.h>

#include "gravnet_cell.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Layout {     // offsets, in floats, into dynamic shared memory
  int f, agg, total;
};

__host__ __device__ inline Layout layout(int n, int df) {
  Layout L;
  int o = 0;
  L.f = o;   o += (n + 1) * df;     // row n: zeros
  L.agg = o; o += kWarps * 2 * df;
  L.total = o;
  return L;
}

__global__ void __launch_bounds__(kThreads)
knn_aggregate_kernel(const float* __restrict__ f,
                     const int* __restrict__ idx,
                     const float* __restrict__ d2, float* __restrict__ out,
                     int n, int df, int k, float scale, int bm) {
  extern __shared__ float smem[];
  const Layout L = layout(n, df);
  float* F = smem + L.f;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int bin = blockIdx.y;
  const int row0 = blockIdx.x * bm;
  const int rows = min(bm, n - row0);

  for (int e = tid; e < n * df; e += kThreads)
    F[e] = f[(size_t)bin * n * df + e];
  for (int c = tid; c < df; c += kThreads) F[n * df + c] = 0.0f;
  __syncthreads();

  float* agg = smem + L.agg + warp * 2 * df;
  for (int r = warp; r < rows; r += kWarps) {
    const int i = row0 + r;
    const size_t o = ((size_t)bin * n + i) * k;
    repro_torch::cell_init(df, agg);
    for (int t = 0; t < k; ++t) {
      const int j = idx[o + t];
      const int row = (unsigned)j < (unsigned)n ? j : n;
      repro_torch::cell_accumulate(d2[o + t], F + row * df, df, scale, agg);
    }
    repro_torch::cell_finish(df, k, agg);
    float* y = out + ((size_t)bin * n + i) * 2 * df;
    for (int c = lane; c < 2 * df; c += 32) y[c] = agg[c];
    __syncwarp();   // the next row's cell_init rewrites agg
  }
}

}  // namespace

// Bytes of dynamic shared memory one CTA needs at these shapes.
extern "C" long long knn_aggregate_smem_bytes(int n, int df) {
  return (long long)layout(n, df).total * (long long)sizeof(float);
}

// f:(B,n,df) f32, idx:(B,n,k) i32, d2:(B,n,k) f32 ->
// out:(B,n,2df) f32; all contiguous.
extern "C" int knn_aggregate_f32(const float* f, const int* idx,
                                 const float* d2, float* out, int B, int n,
                                 int df, int k, float scale, int bm,
                                 void* stream) {
  const long long smem = knn_aggregate_smem_bytes(n, df);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        knn_aggregate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (B > 0 && n > 0) {
    dim3 grid((n + bm - 1) / bm, B);
    knn_aggregate_kernel<<<grid, kThreads, (size_t)smem,
                           (cudaStream_t)stream>>>(f, idx, d2, out, n, df,
                                                   k, scale, bm);
  }
  return (int)cudaGetLastError();
}
