// gravnet_aggregate: the standalone GravNet kNN aggregation, f32, for
// Hopper (sm_90a).
//
// Replaces: repro/kernels/gravnet.py — gravnet_aggregate_batched_pallas
// and gravnet_aggregate_pallas (the latter is this kernel at B = 1).
// It runs where the GravNet block stays unfused: design point 1, the
// --no-fuse-gravnet-block escape hatch and, under the mixed policy,
// --no-fuse-int8.
//
//   out_i = [ mean_k(w f_j), max_k(w f_j) ],  w = exp(-scale d2_ij),
//   over the k nearest valid rows j != i of row i's event in S
//
// Bound on this card: memory, narrowly. At the unfused paths' shape,
// s (1,128,4), f (1,128,22), k = 8 (one event per chunk), the launch
// moves about 39 KB (12 ns at 3.35 TB/s) and needs about 0.38 M f32
// operations (6 ns at the 67 TFLOP/s rate outside the tensor cores).
// What a launch pays is latency: k rounds of a warp argmin per row on a
// few CTAs.
//
// Design: the fused block's cell (gravnet_cell.cuh, included, not
// copied) fed S and F from device memory instead of from the block's
// prologue. One CTA of 256 threads (8 warps) per (row block of bm query
// rows, event) stages the event's S, F and mask in shared memory and
// computes |s_j|^2 there; each warp runs the cell for one query row at
// a time, with the row's distances in a warp-private n-float buffer,
// and writes the row's 2*d_f outputs. bm = 32 gives 4 CTAs per event at
// n = 128. Every sum runs in the plain version's order with products
// and sums rounded separately (-fmad=false), so
// kernels/ref.py:gravnet_aggregate_ref reproduces it.
#include <cuda_runtime.h>

#include "gravnet_cell.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Layout {     // offsets, in floats, into dynamic shared memory
  int s, f, sq, msk, agg, d2, total;
};

__host__ __device__ inline Layout layout(int n, int ds, int df) {
  Layout L;
  int o = 0;
  L.s = o;   o += n * ds;
  L.f = o;   o += n * df;
  L.sq = o;  o += n;
  L.msk = o; o += n;
  L.agg = o; o += kWarps * 2 * df;
  L.d2 = o;  o += kWarps * n;
  L.total = o;
  return L;
}

__global__ void __launch_bounds__(kThreads)
gravnet_aggregate_kernel(const float* __restrict__ s,
                         const float* __restrict__ f,
                         const float* __restrict__ mask,
                         float* __restrict__ out, int n, int ds, int df,
                         int k, float scale, int bm) {
  extern __shared__ float smem[];
  const Layout L = layout(n, ds, df);
  float* S = smem + L.s;
  float* F = smem + L.f;
  float* sq = smem + L.sq;
  float* msk = smem + L.msk;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int event = blockIdx.y;
  const int row0 = blockIdx.x * bm;
  const int rows = min(bm, n - row0);

  for (int e = tid; e < n * ds; e += kThreads)
    S[e] = s[(size_t)event * n * ds + e];
  for (int e = tid; e < n * df; e += kThreads)
    F[e] = f[(size_t)event * n * df + e];
  for (int e = tid; e < n; e += kThreads) msk[e] = mask[(size_t)event * n + e];
  __syncthreads();
  for (int j = tid; j < n; j += kThreads) {
    float acc = 0.0f;
    for (int d = 0; d < ds; ++d) acc += S[j * ds + d] * S[j * ds + d];
    sq[j] = acc;
  }
  __syncthreads();

  float* d2row = smem + L.d2 + warp * n;
  float* agg = smem + L.agg + warp * 2 * df;
  for (int r = warp; r < rows; r += kWarps) {
    const int i = row0 + r;
    repro_torch::gravnet_cell_row(i, n, ds, df, k, scale, S, sq, F, msk,
                                  d2row, agg);
    float* o = out + ((size_t)event * n + i) * 2 * df;
    for (int c = lane; c < 2 * df; c += 32) o[c] = agg[c];
    __syncwarp();   // the next row's cell rewrites agg
  }
}

}  // namespace

// Bytes of dynamic shared memory one CTA needs at these shapes.
extern "C" long long gravnet_aggregate_smem_bytes(int n, int ds, int df) {
  return (long long)layout(n, ds, df).total * (long long)sizeof(float);
}

// s:(B,n,ds) f:(B,n,df) mask:(B,n) -> out:(B,n,2df); all f32, contiguous.
extern "C" int gravnet_aggregate_f32(const float* s, const float* f,
                                     const float* mask, float* out, int B,
                                     int n, int ds, int df, int k,
                                     float scale, int bm, void* stream) {
  const long long smem = gravnet_aggregate_smem_bytes(n, ds, df);
  // The opt-in above 48 KB holds per device, so it is set on every such
  // launch (a cheap call) rather than cached for the process.
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gravnet_aggregate_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (B > 0 && n > 0) {
    dim3 grid((n + bm - 1) / bm, B);
    gravnet_aggregate_kernel<<<grid, kThreads, (size_t)smem,
                               (cudaStream_t)stream>>>(s, f, mask, out, n,
                                                       ds, df, k, scale, bm);
  }
  return (int)cudaGetLastError();
}
