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
// rows of this run's events. What it pays is one round trip to stage
// the bin and k dependent rounds of a warp argmin per row. The first
// version (one CTA of 8 warps per 32 query rows, 32 CTAs at that shape)
// took 18 us: scalar staging, |s_j|^2 in a second pass behind a second
// barrier, and gravnet_cell.cuh's shared-memory selection 4 rows a warp
// in turn, each round a scan of the row, a 10-shuffle argmin and a
// knockout store.
//
// Design: the selection half of the register cell (gravnet_cell_reg.cuh,
// included, not copied), with the segment predicate where the cell has
// its mask. One CTA of bm warps per (bm query rows, bin), one warp per
// row, bm from kernels/knn_build.py:build_plan (4 to 16: the fewest rows
// whose CTAs still fit the card once; 8 rows and 128 CTAs at that
// shape). A CTA stages the bin's S and segment ids in one round trip of
// cp.async copies (16 bytes where the operand's alignment and length
// allow, else 8 or 4); each warp keeps its row's distances in registers
// as keys (|s_j|^2 summed there, no second pass), runs k rounds of two
// __reduce_min_sync each, and lane t keeps round t's (j*, dmin) until
// the rounds end (or 32 of them have), when lanes t < k write them in
// one store each. The whole row is scanned, not the row's own event:
// a spent round then finds column 0 at 1e30, as the plain version does,
// and the candidates per lane are fixed at compile time by n anyway.
// Past 512 hits (16 candidates a lane) the launch runs the first
// version's kernel (knn_build_shared_kernel), a second hand-written path
// chosen by shape. Every sum runs in the plain version's order with
// products and sums rounded separately (-fmad=false), so
// kernels/ref.py:knn_build_ref reproduces both.
//
// The bf16 form (s bf16; idx int32 and d2 f32 as in the f32 form): both
// kernels stage a bf16 S by ordinary loads, each value widened exactly
// into the same f32 shared memory (dtype_io.cuh), so the selection and
// its outputs are the f32 form's on the widened coordinates, bitwise
// with the plain version.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "dtype_io.cuh"
#include "gravnet_cell.cuh"
#include "gravnet_cell_reg.cuh"

namespace {

constexpr int kMaxRows = 16;     // query rows (warps) per CTA
constexpr int kMaxHits = 512;    // 16 candidates per lane

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// Whether a shape runs the register cell.
__host__ __device__ inline bool register_cell(int n) { return n <= kMaxHits; }

struct Layout {     // offsets, in 4-byte words (multiples of 4), into
  int s, seg, total;        // dynamic shared memory
};

__host__ __device__ inline Layout layout(int n, int ds) {
  Layout L;
  int o = 0;
  L.s = o;   o += round4(n * ds);
  L.seg = o; o += round4(n);
  L.total = o;
  return L;
}

template <int V>
__device__ inline void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (V == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(4 * V) : "memory");
}

// count 4-byte words of g into s (16-byte aligned), V words a copy.
template <int V, typename T>
__device__ inline void stage(T* s, const T* g, int count) {
  for (int i = threadIdx.x * V; i < count; i += blockDim.x * V)
    cp_async<V>(s + i, g + i);
}

// The widest of 4, 2 and 1 words a copy that divides count and to whose
// size g is aligned.
template <typename T>
__device__ inline void stage_flat(T* s, const T* g, int count) {
  static_assert(sizeof(T) == 4, "4-byte words");
  const uintptr_t a = reinterpret_cast<uintptr_t>(g);
  if (a % 16 == 0 && count % 4 == 0)
    stage<4>(s, g, count);
  else if (a % 8 == 0 && count % 2 == 0)
    stage<2>(s, g, count);
  else
    stage<1>(s, g, count);
}

// CPL: candidates per lane (n <= 32 CPL). bm warps a CTA. T: s's type.
template <int CPL, typename T>
__global__ void __launch_bounds__(32 * kMaxRows)
knn_build_kernel(const T* __restrict__ s, const int* __restrict__ seg,
                 int* __restrict__ idx, float* __restrict__ d2, int n,
                 int ds, int k, int bm) {
  extern __shared__ __align__(16) float smem[];
  const Layout L = layout(n, ds);
  float* const S = smem + L.s;
  int* const sg = reinterpret_cast<int*>(smem + L.seg);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bin = blockIdx.y;
  const int i = blockIdx.x * bm + warp;

  // staging, one round trip: S and the segment ids by cp.async (a bf16
  // S by loads in flight, widened)
  if constexpr (std::is_same_v<T, float>) {
    stage_flat(S, s + (size_t)bin * n * ds, n * ds);
  } else {
    const repro_torch::io::Widen op[1] = {
        repro_torch::io::flat(S, s + (size_t)bin * n * ds, n * ds)};
    repro_torch::io::widen_all(op, threadIdx.x, blockDim.x);
  }
  stage_flat(sg, seg + (size_t)bin * n, n);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // the selection, one warp per query row; lane t keeps round t
  if (i < n) {
    const int si = sg[i];
    uint32_t d[CPL];
    repro_torch::regcell::load_row<CPL>(
        i, n, ds, S,
        [sg, si, i](int j) {
          const int sj = sg[j];
          return sj == si && j != i && sj >= 0;
        },
        d);
    uint32_t lv;
    int lc;
    repro_torch::regcell::lane_min(d, lv, lc);
    const size_t o = ((size_t)bin * n + i) * k;
    int kept_j = 0;
    float kept_d = 0.0f;
    for (int t = 0; t < k; ++t) {
      float dmin;
      int j;
      repro_torch::regcell::select_round(d, lv, lc, dmin, j);
      const int slot = t & 31;
      if (lane == slot) {
        kept_j = j;
        kept_d = dmin;
      }
      if ((slot == 31 || t == k - 1) && lane <= slot) {
        idx[o + (t - slot) + lane] = kept_j;
        d2[o + (t - slot) + lane] = kept_d;
      }
    }
  }
}

// ---------------------------------------------------------------------
// The first version, kept for the shapes the register cell does not
// take: one CTA of 256 threads (8 warps) per (bm query rows, bin)
// stages the bin's S and segment ids one scalar load a thread at a time,
// computes |s_j|^2, and runs gravnet_cell.cuh's selection 4 rows a warp
// (at bm = 32) with the row's distances in a warp-private n-float
// buffer.
constexpr int kSharedThreads = 256;
constexpr int kSharedWarps = kSharedThreads / 32;

struct SharedLayout {   // offsets, in 4-byte words, into dynamic shared
  int s, sq, seg, d2, total;   // memory
};

__host__ __device__ inline SharedLayout shared_layout(int n, int ds) {
  SharedLayout L;
  int o = 0;
  L.s = o;   o += n * ds;
  L.sq = o;  o += n;
  L.seg = o; o += n;
  L.d2 = o;  o += kSharedWarps * n;
  L.total = o;
  return L;
}

template <typename T>
__global__ void __launch_bounds__(kSharedThreads)
knn_build_shared_kernel(const T* __restrict__ s,
                        const int* __restrict__ seg, int* __restrict__ idx,
                        float* __restrict__ d2, int n, int ds, int k,
                        int bm) {
  extern __shared__ float smem_shared[];
  float* const smem = smem_shared;
  const SharedLayout L = shared_layout(n, ds);
  float* S = smem + L.s;
  float* sq = smem + L.sq;
  int* sg = reinterpret_cast<int*>(smem + L.seg);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int bin = blockIdx.y;
  const int row0 = blockIdx.x * bm;
  const int rows = min(bm, n - row0);

  for (int e = tid; e < n * ds; e += kSharedThreads)
    S[e] = repro_torch::io::widen(s[(size_t)bin * n * ds + e]);
  for (int e = tid; e < n; e += kSharedThreads) sg[e] = seg[(size_t)bin * n + e];
  __syncthreads();
  for (int j = tid; j < n; j += kSharedThreads) {
    float acc = 0.0f;
    for (int d = 0; d < ds; ++d) acc += S[j * ds + d] * S[j * ds + d];
    sq[j] = acc;
  }
  __syncthreads();

  float* d2row = smem + L.d2 + warp * n;
  for (int r = warp; r < rows; r += kSharedWarps) {
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

template <typename Kernel, typename T>
int launch(Kernel kernel, int threads, long long smem, int B, int n,
           int bm, cudaStream_t stream, const T* s, const int* seg,
           int* idx, float* d2, int ds, int k) {
  // The opt-in above 48 KB holds per device, so it is set on every such
  // launch (a cheap call) rather than cached for the process.
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((n + bm - 1) / bm, B);
  kernel<<<grid, threads, (size_t)smem, stream>>>(s, seg, idx, d2, n, ds,
                                                  k, bm);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_s(const T* s, const int* seg, int* idx, float* d2, int B, int n,
             int ds, int k, int bm, cudaStream_t st) {
  if (!register_cell(n) || bm > kMaxRows)
    return launch(knn_build_shared_kernel<T>, kSharedThreads,
                  4LL * shared_layout(n, ds).total, B, n, bm, st, s, seg,
                  idx, d2, ds, k);
  const long long smem = 4LL * layout(n, ds).total;
#define REPRO_LAUNCH(CPL)                                                  \
  return launch(knn_build_kernel<CPL, T>, 32 * bm, smem, B, n, bm, st, s, \
                seg, idx, d2, ds, k)
  if (n <= 32) REPRO_LAUNCH(1);
  if (n <= 64) REPRO_LAUNCH(2);
  if (n <= 128) REPRO_LAUNCH(4);
  if (n <= 256) REPRO_LAUNCH(8);
  REPRO_LAUNCH(16);
#undef REPRO_LAUNCH
}

}  // namespace

// Bytes of dynamic shared memory one CTA needs at these shapes, on the
// path knn_build_ex takes for them with kernels/knn_build.py:build_plan's
// bm (the mirror of knn_build.build_smem_bytes).
extern "C" long long knn_build_smem_bytes(int n, int ds) {
  return 4LL * (register_cell(n) ? layout(n, ds).total
                                 : shared_layout(n, ds).total);
}

// s:(B,n,ds) of the dtype in_dtype (dtype_io.cuh: 0 = f32, 1 = bf16),
// seg:(B,n) i32 -> idx:(B,n,k) i32, d2:(B,n,k) f32; all contiguous. bm
// query rows per CTA: at most 16 runs the register cell where the shape
// allows (n <= 512), else the first version.
extern "C" int knn_build_ex(const void* s, const int* seg, int* idx,
                            float* d2, int B, int n, int ds, int k, int bm,
                            int in_dtype, void* stream) {
  if (B <= 0 || n <= 0 || k <= 0) return (int)cudaGetLastError();
  if (bm < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (in_dtype == repro_torch::io::kF32)
    return launch_s(static_cast<const float*>(s), seg, idx, d2, B, n, ds, k,
                    bm, st);
  if (in_dtype == repro_torch::io::kBF16)
    return launch_s(static_cast<const repro_torch::io::bf16*>(s), seg, idx,
                    d2, B, n, ds, k, bm, st);
  return (int)cudaErrorInvalidValue;
}

// The f32 form with the first versions' arguments, as
// kernels/source_ab.py and phase_split.py call it.
extern "C" int knn_build_f32(const float* s, const int* seg, int* idx,
                             float* d2, int B, int n, int ds, int k, int bm,
                             void* stream) {
  return knn_build_ex(s, seg, idx, d2, B, n, ds, k, bm,
                      repro_torch::io::kF32, stream);
}
