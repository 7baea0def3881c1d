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
// the 67 TFLOP/s rate outside the tensor cores). What it pays is the
// round trips of a row's chain: its (idx, d2) pairs, then the selected
// feature rows. The first version (one CTA of 8 warps per 32 query
// rows, 32 CTAs at that shape) took 10.7 us: every CTA staged the whole
// bin's F (11 KB at d_f 22) one scalar load a thread at a time to use
// k·32 of its rows, and each warp took 4 rows in turn, reading each
// round's (idx, d2) from device memory as a dependent broadcast load and
// accumulating through a shared buffer.
//
// Design: the accumulation half of the register cell
// (gravnet_cell_reg.cuh: cell_row's round body), fed its rounds from
// knn_build's (idx, d2). One CTA of bm warps per (bm query rows, bin),
// one warp per row, bm from kernels/knn_build.py:aggregate_plan (the
// rule of knn_build's rows: 8 rows and 128 CTAs at that shape). Lanes
// t < k read the row's k pairs in one coalesced load and compute each
// slot's weight; each round takes its (row, weight, valid) with
// __shfl_sync. F is not staged: the selected rows are read straight from
// device memory (L2-resident: the ragged executable's dense wrote them
// just before), 8 rounds' rows issued together before they are summed,
// so a row pays two round trips and no CTA reads a feature it does not
// use. Staging F by cp.async would move the whole bin into every CTA
// (16 times the rows a CTA uses at that shape) and add a barrier to the
// chain. The sums and maxima stay in registers, a lane owning columns
// lane + 32u; the mean is divided by k (the IEEE division), and the
// 2*d_f outputs are written from registers. Past d_f 128 (4 columns a
// lane) the launch runs the first version's kernel
// (knn_aggregate_shared_kernel), a second hand-written path chosen by
// shape. Products and sums are rounded separately (-fmad=false), in the
// plain version's order, so kernels/ref.py:knn_aggregate_ref reproduces
// both.
//
// The bf16 forms (f of type T, the output of type O): the register path
// reads each selected bf16 feature from device memory and widens it
// exactly (dtype_io.cuh), the first version stages F widened into its f32
// shared memory; both round each output once where O is bf16, so every
// form is bitwise with the plain version.
#include <cuda_runtime.h>

#include "dtype_io.cuh"
#include "gravnet_cell.cuh"
#include "gravnet_cell_reg.cuh"

namespace {

using repro_torch::regcell::kBig;
using repro_torch::regcell::kMaxDfPerLane;

constexpr int kMaxRows = 16;     // query rows (warps) per CTA
constexpr int kMaxDf = 32 * kMaxDfPerLane;
constexpr int kBatch = 8;        // rounds whose rows are read together
constexpr unsigned kAll = 0xffffffffu;

// Whether a shape runs the register path.
__host__ __device__ inline bool register_path(int df) { return df <= kMaxDf; }

// bm warps a CTA.
template <typename T, typename O>
__global__ void __launch_bounds__(32 * kMaxRows)
knn_aggregate_kernel(const T* __restrict__ f, const int* __restrict__ idx,
                     const float* __restrict__ d2, O* __restrict__ out,
                     int n, int df, int k, float scale, int bm) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bin = blockIdx.y;
  const int i = blockIdx.x * bm + warp;
  // one warp per query row: its pairs, the selected rows, the outputs
  if (i < n) {
    const T* const F = f + (size_t)bin * n * df;
    const size_t o = ((size_t)bin * n + i) * k;
    float sum[kMaxDfPerLane], mx[kMaxDfPerLane];
#pragma unroll
    for (int u = 0; u < kMaxDfPerLane; ++u) {
      sum[u] = 0.0f;
      mx[u] = -kBig;
    }
    for (int t0 = 0; t0 < k; t0 += 32) {
      // slot t0 + lane's pair: its row (-1 outside [0, n): zeros), its
      // weight and whether it counts
      int j = -1;
      float w = 0.0f;
      bool valid = false;
      if (t0 + lane < k) {
        const int jj = idx[o + t0 + lane];
        const float dd = d2[o + t0 + lane];
        j = (unsigned)jj < (unsigned)n ? jj : -1;
        valid = dd < kBig * 0.5f;
        w = valid ? expf(-scale * dd) : 0.0f;
      }
      const int rounds = min(32, k - t0);
      for (int b = 0; b < rounds; b += kBatch) {
        // kBatch rounds' rows read together, then summed in slot order;
        // a lane past df reads column df - 1: its outputs are never
        // written, and the loop needs no branch
        float fv[kBatch][kMaxDfPerLane];
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          const int jt = __shfl_sync(kAll, j, (b + q) & 31);
#pragma unroll
          for (int u = 0; u < kMaxDfPerLane; ++u)
            fv[q][u] = (b + q < rounds && jt >= 0 && 32 * u < df)
                           ? repro_torch::io::widen(
                                 F[jt * df + min(lane + 32 * u, df - 1)])
                           : 0.0f;
        }
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          if (b + q >= rounds) break;
          const float wt = __shfl_sync(kAll, w, b + q);
          const bool vt = __shfl_sync(kAll, (int)valid, b + q) != 0;
#pragma unroll
          for (int u = 0; u < kMaxDfPerLane; ++u) {
            if (32 * u >= df) break;
            const float wf = wt * fv[q][u];
            sum[u] = sum[u] + wf;
            if (vt) mx[u] = fmaxf(mx[u], wf);
          }
        }
      }
    }
    O* const y = out + ((size_t)bin * n + i) * 2 * df;
#pragma unroll
    for (int u = 0; u < kMaxDfPerLane; ++u) {
      const int c = lane + 32 * u;
      if (c < df) {
        repro_torch::io::put(y + c, sum[u] / (float)k);
        repro_torch::io::put(y + df + c,
                             mx[u] <= -kBig * 0.5f ? 0.0f : mx[u]);
      }
    }
  }
}

// ---------------------------------------------------------------------
// The first version, kept for the shapes the register path does not
// take: one CTA of 256 threads (8 warps) per (bm query rows, bin) stages
// the bin's F in shared memory, with a row of zeros after it for
// out-of-range indices; each warp takes one query row at a time (4 at
// bm = 32), reads its k (idx, d2) pairs (the same address in every lane,
// a broadcast), accumulates in slot order into a warp-private 2*d_f
// buffer (gravnet_cell.cuh: cell_init, cell_accumulate, cell_finish) and
// writes the row.
constexpr int kSharedThreads = 256;
constexpr int kSharedWarps = kSharedThreads / 32;

struct SharedLayout {   // offsets, in floats, into dynamic shared memory
  int f, agg, total;
};

__host__ __device__ inline SharedLayout shared_layout(int n, int df) {
  SharedLayout L;
  int o = 0;
  L.f = o;   o += (n + 1) * df;     // row n: zeros
  L.agg = o; o += kSharedWarps * 2 * df;
  L.total = o;
  return L;
}

template <typename T, typename O>
__global__ void __launch_bounds__(kSharedThreads)
knn_aggregate_shared_kernel(const T* __restrict__ f,
                            const int* __restrict__ idx,
                            const float* __restrict__ d2,
                            O* __restrict__ out, int n, int df, int k,
                            float scale, int bm) {
  extern __shared__ float smem[];
  const SharedLayout L = shared_layout(n, df);
  float* F = smem + L.f;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int bin = blockIdx.y;
  const int row0 = blockIdx.x * bm;
  const int rows = min(bm, n - row0);

  for (int e = tid; e < n * df; e += kSharedThreads)
    F[e] = repro_torch::io::widen(f[(size_t)bin * n * df + e]);
  for (int c = tid; c < df; c += kSharedThreads) F[n * df + c] = 0.0f;
  __syncthreads();

  float* agg = smem + L.agg + warp * 2 * df;
  for (int r = warp; r < rows; r += kSharedWarps) {
    const int i = row0 + r;
    const size_t o = ((size_t)bin * n + i) * k;
    repro_torch::cell_init(df, agg);
    for (int t = 0; t < k; ++t) {
      const int j = idx[o + t];
      const int row = (unsigned)j < (unsigned)n ? j : n;
      repro_torch::cell_accumulate(d2[o + t], F + row * df, df, scale, agg);
    }
    repro_torch::cell_finish(df, k, agg);
    O* y = out + ((size_t)bin * n + i) * 2 * df;
    for (int c = lane; c < 2 * df; c += 32) repro_torch::io::put(y + c, agg[c]);
    __syncwarp();   // the next row's cell_init rewrites agg
  }
}

template <typename T, typename O>
int launch_io(const T* f, const int* idx, const float* d2, O* out, int B,
              int n, int df, int k, float scale, int bm, cudaStream_t st) {
  dim3 grid((n + bm - 1) / bm, B);
  if (register_path(df) && bm <= kMaxRows) {
    knn_aggregate_kernel<T, O><<<grid, 32 * bm, 0, st>>>(f, idx, d2, out, n,
                                                         df, k, scale, bm);
    return (int)cudaGetLastError();
  }
  const long long smem = 4LL * shared_layout(n, df).total;
  auto shared = knn_aggregate_shared_kernel<T, O>;
  // The opt-in above 48 KB holds per device, so it is set on every such
  // launch (a cheap call) rather than cached for the process.
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        shared, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  shared<<<grid, kSharedThreads, (size_t)smem, st>>>(f, idx, d2, out, n, df,
                                                     k, scale, bm);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory one CTA needs at these shapes, on the
// path knn_aggregate_ex takes for them with
// kernels/knn_build.py:aggregate_plan's bm (the mirror of
// knn_build.aggregate_smem_bytes): none on the register path.
extern "C" long long knn_aggregate_smem_bytes(int n, int df) {
  return register_path(df) ? 0LL
                           : 4LL * (long long)shared_layout(n, df).total;
}

// f:(B,n,df) of the dtype in_dtype, idx:(B,n,k) i32, d2:(B,n,k) f32 ->
// out:(B,n,2df) of out_dtype (dtype_io.cuh: 0 = f32, 1 = bf16); all
// contiguous. bm query rows per CTA: at most 16 runs the register path
// where the shape allows (df <= 128), else the first version.
extern "C" int knn_aggregate_ex(const void* f, const int* idx,
                                const float* d2, void* out, int B, int n,
                                int df, int k, float scale, int bm,
                                int in_dtype, int out_dtype, void* stream) {
  if (B <= 0 || n <= 0) return (int)cudaGetLastError();
  if (bm < 1 || k < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  REPRO_DISPATCH_IO(in_dtype, out_dtype,
                    return launch_io(static_cast<const T*>(f), idx, d2,
                                     static_cast<O*>(out), B, n, df, k,
                                     scale, bm, st));
}

// The f32 form with the first versions' arguments, as
// kernels/source_ab.py and phase_split.py call it.
extern "C" int knn_aggregate_f32(const float* f, const int* idx,
                                 const float* d2, float* out, int B, int n,
                                 int df, int k, float scale, int bm,
                                 void* stream) {
  return knn_aggregate_ex(f, idx, d2, out, B, n, df, k, scale, bm,
                          repro_torch::io::kF32, repro_torch::io::kF32,
                          stream);
}
