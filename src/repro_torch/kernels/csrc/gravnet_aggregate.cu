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
// What a launch pays is latency: k rounds of a warp argmin per row. The
// first version (one CTA of 8 warps per 32 query rows: 4 CTAs at that
// shape) took 24 us: scalar staging, |s_j|^2 in a second pass, and the
// shared-memory cell 4 rows a warp in turn, each round a scan of the
// row, a 10-shuffle argmin and a knockout store.
//
// Design: the fused blocks' register cell (gravnet_cell_reg.cuh,
// included, not copied) fed S and F from device memory. One CTA of bm
// warps per (bm query rows, event), one warp per row, bm from
// kernels/gravnet.py:plan (4 to 16: the fewest rows whose CTAs still fit
// the card once, 32 CTAs at that shape). A CTA stages the event's S, F
// and mask in one round trip of cp.async copies (16 bytes where the
// operand's alignment and length allow, else 8 or 4), and each warp runs
// the cell with its row's distances in registers, divides the mean by k
// (the IEEE division) and writes the row's 2*d_f outputs from registers.
// No CTA repeats more than the staging, so smaller CTAs cost nothing
// extra. At the unfused paths' shape a launch takes 4.2 us on an NVIDIA
// H100 80GB HBM3 at 700 W, a CTA 0.6 us of staging and 2.0 of cell
// (kernels/phase_split.py; PERF.md). Past 512 hits or d_f 128 (the
// cell's registers) the launch runs the first version's kernel
// (gravnet_aggregate_shared_kernel, the shared-memory cell of
// gravnet_cell.cuh), a second hand-written path chosen by shape. Every sum runs in the plain version's order with
// products and sums rounded separately (-fmad=false), so
// kernels/ref.py:gravnet_aggregate_ref reproduces both.
//
// The bf16 forms (s and f of one type T, the output of type O): both
// kernels stage a bf16 S and F by ordinary loads, each value widened
// exactly into the same f32 shared memory (dtype_io.cuh), run the f32
// cell unchanged and round each output once where O is bf16, so every
// form is bitwise with the plain version.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "dtype_io.cuh"
#include "gravnet_cell.cuh"
#include "gravnet_cell_reg.cuh"

namespace {

using repro_torch::regcell::kMaxDfPerLane;

constexpr int kMaxRows = 16;     // query rows (warps) per CTA
constexpr int kMaxHits = 512;    // 16 candidates per lane
constexpr int kMaxDf = 32 * kMaxDfPerLane;

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// Whether a shape runs the register cell.
__host__ __device__ inline bool register_cell(int n, int df) {
  return n <= kMaxHits && df <= kMaxDf;
}

struct Layout {     // offsets, in floats (multiples of 4), into dynamic
  int s, f, msk, total;     // shared memory
};

__host__ __device__ inline Layout layout(int n, int ds, int df) {
  Layout L;
  int o = 0;
  L.s = o;   o += round4(n * ds);
  L.f = o;   o += round4(n * df);
  L.msk = o; o += round4(n);
  L.total = o;
  return L;
}

template <int V>
__device__ inline void cp_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (V == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(4 * V) : "memory");
}

// count floats of g into s (16-byte aligned), V floats a copy.
template <int V>
__device__ inline void stage(float* s, const float* g, int count) {
  for (int i = threadIdx.x * V; i < count; i += blockDim.x * V)
    cp_async<V>(s + i, g + i);
}

// The widest of 4, 2 and 1 floats a copy that divides count and to
// whose size g is aligned.
__device__ inline void stage_flat(float* s, const float* g, int count) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(g);
  if (a % 16 == 0 && count % 4 == 0)
    stage<4>(s, g, count);
  else if (a % 8 == 0 && count % 2 == 0)
    stage<2>(s, g, count);
  else
    stage<1>(s, g, count);
}

// CPL: candidates per lane (n <= 32 CPL). bm warps a CTA.
template <int CPL, typename T, typename O>
__global__ void __launch_bounds__(32 * kMaxRows)
gravnet_aggregate_kernel(const T* __restrict__ s, const T* __restrict__ f,
                         const float* __restrict__ mask,
                         O* __restrict__ out, int n, int ds, int df, int k,
                         float scale, int bm) {
  extern __shared__ __align__(16) float smem[];
  const Layout L = layout(n, ds, df);
  float* const S = smem + L.s;
  float* const F = smem + L.f;
  float* const msk = smem + L.msk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int event = blockIdx.y;
  const int i = blockIdx.x * bm + warp;

  // staging, one round trip: S, F and the mask by cp.async (bf16: S and
  // F by loads in flight together, widened)
  if constexpr (std::is_same_v<T, float>) {
    stage_flat(S, s + (size_t)event * n * ds, n * ds);
    stage_flat(F, f + (size_t)event * n * df, n * df);
  } else {
    const repro_torch::io::Widen op[2] = {
        repro_torch::io::flat(S, s + (size_t)event * n * ds, n * ds),
        repro_torch::io::flat(F, f + (size_t)event * n * df, n * df)};
    repro_torch::io::widen_all(op, threadIdx.x, blockDim.x);
  }
  stage_flat(msk, mask + (size_t)event * n, n);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // the cell, one warp per query row; the outputs from registers
  if (i < n) {
    float sum[kMaxDfPerLane], mx[kMaxDfPerLane];
    repro_torch::regcell::cell_row<CPL>(i, n, ds, df, k, scale, S, F, msk,
                                        sum, mx);
    O* const o = out + ((size_t)event * n + i) * 2 * df;
#pragma unroll
    for (int u = 0; u < kMaxDfPerLane; ++u) {
      const int c = lane + 32 * u;
      if (c < df) {
        repro_torch::io::put(o + c, sum[u] / (float)k);
        repro_torch::io::put(o + df + c, mx[u]);
      }
    }
  }
}

// ---------------------------------------------------------------------
// The first version, kept for the shapes the register cell does not
// take: one CTA of 256 threads (8 warps) per (bm query rows, event)
// stages the event's S, F and mask one scalar load a thread at a time,
// computes |s_j|^2, and runs the shared-memory cell of gravnet_cell.cuh
// 4 rows a warp (at bm = 32) with the row's distances in a warp-private
// n-float buffer.
constexpr int kSharedThreads = 256;
constexpr int kSharedWarps = kSharedThreads / 32;

struct SharedLayout {     // offsets, in floats, into dynamic shared memory
  int s, f, sq, msk, agg, d2, total;
};

__host__ __device__ inline SharedLayout shared_layout(int n, int ds,
                                                      int df) {
  SharedLayout L;
  int o = 0;
  L.s = o;   o += n * ds;
  L.f = o;   o += n * df;
  L.sq = o;  o += n;
  L.msk = o; o += n;
  L.agg = o; o += kSharedWarps * 2 * df;
  L.d2 = o;  o += kSharedWarps * n;
  L.total = o;
  return L;
}

template <typename T, typename O>
__global__ void __launch_bounds__(kSharedThreads)
gravnet_aggregate_shared_kernel(const T* __restrict__ s,
                                const T* __restrict__ f,
                                const float* __restrict__ mask,
                                O* __restrict__ out, int n, int ds, int df,
                                int k, float scale, int bm) {
  extern __shared__ float smem_shared[];
  float* const smem = smem_shared;
  const SharedLayout L = shared_layout(n, ds, df);
  float* S = smem + L.s;
  float* F = smem + L.f;
  float* sq = smem + L.sq;
  float* msk = smem + L.msk;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int event = blockIdx.y;
  const int row0 = blockIdx.x * bm;
  const int rows = min(bm, n - row0);

  for (int e = tid; e < n * ds; e += kSharedThreads)
    S[e] = repro_torch::io::widen(s[(size_t)event * n * ds + e]);
  for (int e = tid; e < n * df; e += kSharedThreads)
    F[e] = repro_torch::io::widen(f[(size_t)event * n * df + e]);
  for (int e = tid; e < n; e += kSharedThreads)
    msk[e] = mask[(size_t)event * n + e];
  __syncthreads();
  for (int j = tid; j < n; j += kSharedThreads) {
    float acc = 0.0f;
    for (int d = 0; d < ds; ++d) acc += S[j * ds + d] * S[j * ds + d];
    sq[j] = acc;
  }
  __syncthreads();

  float* d2row = smem + L.d2 + warp * n;
  float* agg = smem + L.agg + warp * 2 * df;
  for (int r = warp; r < rows; r += kSharedWarps) {
    const int i = row0 + r;
    repro_torch::gravnet_cell_row(i, n, ds, df, k, scale, S, sq, F, msk,
                                  d2row, agg);
    O* o = out + ((size_t)event * n + i) * 2 * df;
    for (int c = lane; c < 2 * df; c += 32) repro_torch::io::put(o + c, agg[c]);
    __syncwarp();   // the next row's cell rewrites agg
  }
}

template <typename Kernel, typename T, typename O>
int launch(Kernel kernel, int threads, long long smem, int B, int n,
           int bm, cudaStream_t stream, const T* s, const T* f,
           const float* mask, O* out, int ds, int df, int k, float scale) {
  // The opt-in above 48 KB holds per device, so it is set on every such
  // launch (a cheap call) rather than cached for the process.
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((n + bm - 1) / bm, B);
  kernel<<<grid, threads, (size_t)smem, stream>>>(s, f, mask, out, n, ds,
                                                  df, k, scale, bm);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory one CTA needs at these shapes, on the
// path gravnet_aggregate_ex takes for them with kernels/gravnet.py:plan's
// bm (the mirror of gravnet.smem_bytes).
extern "C" long long gravnet_aggregate_smem_bytes(int n, int ds, int df) {
  return 4LL * (register_cell(n, df) ? layout(n, ds, df).total
                                     : shared_layout(n, ds, df).total);
}

namespace {

template <typename T, typename O>
int launch_io(const T* s, const T* f, const float* mask, O* out, int B,
              int n, int ds, int df, int k, float scale, int bm,
              cudaStream_t st) {
  if (!register_cell(n, df) || bm > kMaxRows)
    return launch(gravnet_aggregate_shared_kernel<T, O>, kSharedThreads,
                  4LL * shared_layout(n, ds, df).total, B, n, bm, st, s, f,
                  mask, out, ds, df, k, scale);
  const long long smem = 4LL * layout(n, ds, df).total;
#define REPRO_LAUNCH(CPL)                                                   \
  return launch(gravnet_aggregate_kernel<CPL, T, O>, 32 * bm, smem, B, n,  \
                bm, st, s, f, mask, out, ds, df, k, scale)
  if (n <= 32) REPRO_LAUNCH(1);
  if (n <= 64) REPRO_LAUNCH(2);
  if (n <= 128) REPRO_LAUNCH(4);
  if (n <= 256) REPRO_LAUNCH(8);
  REPRO_LAUNCH(16);
#undef REPRO_LAUNCH
}

}  // namespace

// s:(B,n,ds) f:(B,n,df) of the dtype in_dtype, mask:(B,n) f32 ->
// out:(B,n,2df) of out_dtype (dtype_io.cuh: 0 = f32, 1 = bf16); all
// contiguous. bm query rows per CTA: at most 16 runs the register cell
// where the shape allows (n <= 512, df <= 128), else the first version.
extern "C" int gravnet_aggregate_ex(const void* s, const void* f,
                                    const float* mask, void* out, int B,
                                    int n, int ds, int df, int k,
                                    float scale, int bm, int in_dtype,
                                    int out_dtype, void* stream) {
  if (B <= 0 || n <= 0) return (int)cudaGetLastError();
  if (bm < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  REPRO_DISPATCH_IO(in_dtype, out_dtype,
                    return launch_io(static_cast<const T*>(s),
                                     static_cast<const T*>(f), mask,
                                     static_cast<O*>(out), B, n, ds, df, k,
                                     scale, bm, st));
}

// The f32 form with the first versions' arguments, as
// kernels/phase_split.py and source_ab.py call it.
extern "C" int gravnet_aggregate_f32(const float* s, const float* f,
                                     const float* mask, float* out, int B,
                                     int n, int ds, int df, int k,
                                     float scale, int bm, void* stream) {
  return gravnet_aggregate_ex(s, f, mask, out, B, n, ds, df, k, scale, bm,
                              repro_torch::io::kF32, repro_torch::io::kF32,
                              stream);
}
