// knn_build: segment-masked kNN selection over bin-packed ragged
// events, f32, for Hopper (sm_90a).
//
// Replaces: repro/kernels/knn_build.py — knn_build_batched_pallas and
// knn_build_pallas (the latter is this kernel at B = 1). It runs on the
// ragged path (deploy(ragged=True)): twice per launch of the ragged
// executable, once per GravNet block, feeding knn_aggregate.
//
//   per packed row i of a bin: the k nearest rows j of its own event,
//   valid iff seg[j] == seg[i], j != i and seg[j] >= 0;
//   idx[i, t] = j*, d2[i, t] = dmin of round t (argmin with knockout,
//   ties to the lowest column); a round with no candidate left gives
//   (0, 1e30): 0 is the argmin of an all-1e30 row.
//
// Bound on this card: latency, far from either roofline. At the path
// shape, s (8,128,4) and 8 neighbours, a launch moves about 84 KB
// (25 ns at 3.35 TB/s) and needs at most 2.5 M f32 operations (37 ns at
// the 67 TFLOP/s rate outside the tensor cores) — less for the real
// rows of this run's events. What it pays is k dependent rounds of a
// warp argmin per row on 32 CTAs.
//
// Design: the selection half of the GravNet cell (gravnet_cell.cuh:
// cell_d2, cell_select), with segment ids where the cell has its mask.
// One CTA of 256 threads (8 warps) per (row block of bm query rows,
// bin) stages the bin's S and segment ids in shared memory and computes
// |s_j|^2 there; each warp takes one query row at a time, fills its
// warp-private n-float distance row, and runs k rounds of the shuffle
// argmin, lane 0 writing (j*, dmin) of each round. bm = 32 gives 4 CTAs
// per bin at n = 128. Every sum runs in the plain version's order with
// products and sums rounded separately (-fmad=false), so
// kernels/ref.py:knn_build_ref reproduces it.
#include <cuda_runtime.h>

#include "gravnet_cell.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Layout {     // offsets, in 4-byte words, into dynamic shared memory
  int s, sq, seg, d2, total;
};

__host__ __device__ inline Layout layout(int n, int ds) {
  Layout L;
  int o = 0;
  L.s = o;   o += n * ds;
  L.sq = o;  o += n;
  L.seg = o; o += n;
  L.d2 = o;  o += kWarps * n;
  L.total = o;
  return L;
}

__global__ void __launch_bounds__(kThreads)
knn_build_kernel(const float* __restrict__ s, const int* __restrict__ seg,
                 int* __restrict__ idx, float* __restrict__ d2, int n,
                 int ds, int k, int bm) {
  extern __shared__ float smem[];
  const Layout L = layout(n, ds);
  float* S = smem + L.s;
  float* sq = smem + L.sq;
  int* sg = reinterpret_cast<int*>(smem + L.seg);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int bin = blockIdx.y;
  const int row0 = blockIdx.x * bm;
  const int rows = min(bm, n - row0);

  for (int e = tid; e < n * ds; e += kThreads)
    S[e] = s[(size_t)bin * n * ds + e];
  for (int e = tid; e < n; e += kThreads) sg[e] = seg[(size_t)bin * n + e];
  __syncthreads();
  for (int j = tid; j < n; j += kThreads) {
    float acc = 0.0f;
    for (int d = 0; d < ds; ++d) acc += S[j * ds + d] * S[j * ds + d];
    sq[j] = acc;
  }
  __syncthreads();

  float* d2row = smem + L.d2 + warp * n;
  for (int r = warp; r < rows; r += kWarps) {
    const int i = row0 + r;
    const int si = sg[i];
    for (int j = lane; j < n; j += 32) {
      const float v = repro_torch::cell_d2(i, j, ds, S, sq);
      d2row[j] = (sg[j] != si || j == i || sg[j] < 0) ? repro_torch::kBig
                                                      : v;
    }
    __syncwarp();
    const size_t o = ((size_t)bin * n + i) * k;
    for (int t = 0; t < k; ++t) {
      float dmin;
      int j;
      repro_torch::cell_select(n, d2row, dmin, j);
      if (lane == 0) {
        idx[o + t] = j;
        d2[o + t] = dmin;
      }
    }
  }
}

}  // namespace

// Bytes of dynamic shared memory one CTA needs at these shapes.
extern "C" long long knn_build_smem_bytes(int n, int ds) {
  return (long long)layout(n, ds).total * 4LL;
}

// s:(B,n,ds) f32, seg:(B,n) i32 -> idx:(B,n,k) i32, d2:(B,n,k) f32; all
// contiguous.
extern "C" int knn_build_f32(const float* s, const int* seg, int* idx,
                             float* d2, int B, int n, int ds, int k, int bm,
                             void* stream) {
  const long long smem = knn_build_smem_bytes(n, ds);
  // The opt-in above 48 KB holds per device, so it is set on every such
  // launch (a cheap call) rather than cached for the process.
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        knn_build_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (B > 0 && n > 0 && k > 0) {
    dim3 grid((n + bm - 1) / bm, B);
    knn_build_kernel<<<grid, kThreads, (size_t)smem,
                       (cudaStream_t)stream>>>(s, seg, idx, d2, n, ds, k,
                                               bm);
  }
  return (int)cudaGetLastError();
}
