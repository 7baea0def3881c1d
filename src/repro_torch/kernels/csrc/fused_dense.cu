// fused_dense: y = act(x @ w + b) in f32, for Hopper (sm_90a).
//
// Replaces: repro/kernels/fused_dense.py — fused_dense_pallas (the
// flattened and looped variants) and fused_dense_batched_pallas, whose
// batched form the wrapper row-packs into one (B*M, K) launch.
//
// Bound on this card: latency. The paths' products are (64-4096, K <= 256)
// by (K, N <= 192), mostly small (a GatedGCN dense is 2.5 MFLOP against
// 40 KB moved, tens of nanoseconds at either roofline), while a launch
// costs microseconds: what it pays is its round trips to device memory
// and each output's chain of K dependent adds. The attention graph's
// (4096, 64) -> 192 (0.1 GFLOP) is bound by operations, and there this
// kernel issues two instructions a term (no FMA, below) where a library
// GEMM issues one.
//
// Design: each CTA owns one output tile of (TR*TY) x (TC*TX), each thread
// a TR x TC block of it with independent accumulator chains. The plan
// (kernels/fused_dense.py:plan) picks the tile from (M, N): one output a
// thread in 16x8 tiles for the small products (144 CTAs for (256, K) ->
// 70), larger blocks once the CTAs would queue three deep on the SMs, and
// 4x4 blocks in 64x64 tiles for the attention dense. A CTA stages its
// whole x slab (tile rows x K) and w slab (K x tile columns) in one round
// trip for every K up to kStage: cp.async copies of 16, 8 or 4 bytes, the
// widest that the operand's alignment, row stride and row length allow
// (a row of K = 70 floats is 8-byte aligned, not 16), nothing read past
// an operand, then one barrier. A longer K walks slabs of kSlab, two
// buffers deep (the next slab loads while this one is summed). x is read
// through its row stride ldx >= K, so a row-strided view (the executor's
// own-K view of a lane-padded input) launches without a copy. Rows and
// columns past M and N are neither loaded nor stored.
//
// Numerics: full f32, no TF32, no tensor cores, no FMA (-fmad=false):
// each output sums its K products in order k = 0..K-1 from 0, each
// product and each sum rounded on its own, then adds the bias and applies
// the activation (activation.cuh) — the order of the plain version
// (kernels/ref.py:fused_dense_ref), which therefore reproduces this
// kernel's bits under none and relu; gelu and silu round as CUDA's tanhf
// and expf do, within the float32 row of it.
//
// The bf16 forms (x, w and b of one type T, the output of type O; the
// TPU kernel's bf16 x bf16 products accumulated in f32 and cast to
// out_dtype): a bf16 x or w slab is staged by ordinary loads, each value
// widened exactly into the same f32 slab (dtype_io.cuh), b widened where
// it is added, and the result rounded once to bf16 where O is bf16 (round
// to nearest even). The arithmetic between is the f32 form's, so every
// form is bitwise with the plain version. A bf16 product on the tensor
// cores would be faster at the attention dense and is not this kernel:
// it sums in another order.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "activation.cuh"
#include "dtype_io.cuh"

namespace {

constexpr int kStage = 256;  // K staged whole up to here
constexpr int kSlab = 64;    // above it: slabs of this depth, two buffers

// Depth of a staged slab, the x slab's row stride in shared memory (a
// multiple of 4 floats for 16-byte rows and float4 reads along k), and
// the floats of shared memory a CTA of a bm x bn tile needs.
__host__ __device__ inline int slab_depth(int K) {
  return K <= kStage ? K : kSlab;
}
__host__ __device__ inline int x_stride(int ks) { return ((ks + 3) & ~3) + 4; }
__host__ __device__ inline long long smem_floats(int bm, int bn, int K) {
  const int ks = slab_depth(K);
  const long long nbuf = K <= kStage ? 1 : 2;
  return nbuf * ((long long)bm * x_stride(ks) + (long long)ks * bn);
}

template <int BYTES>
__device__ inline void cp_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(BYTES)
               : "memory");
}
__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows x cols of g (row stride ldg) into s (row stride lds), V floats a
// copy; cols is a multiple of V and every row start V-float aligned.
template <int V, int NT>
__device__ inline void stage(float* s, int lds, const float* g,
                             long long ldg, int rows, int cols) {
  const int per_row = cols / V;
  for (int i = threadIdx.x; i < rows * per_row; i += NT) {
    const int r = i / per_row;
    const int c = (i - r * per_row) * V;
    cp_async<4 * V>(s + r * lds + c, g + r * ldg + c);
  }
}

template <int NT>
__device__ inline void stage_v(int v, float* s, int lds, const float* g,
                               long long ldg, int rows, int cols) {
  if (v == 4)
    stage<4, NT>(s, lds, g, ldg, rows, cols);
  else if (v == 2)
    stage<2, NT>(s, lds, g, ldg, rows, cols);
  else
    stage<1, NT>(s, lds, g, ldg, rows, cols);
}

template <int TC>
__device__ inline void load_cols(float (&v)[TC], const float* p) {
  if constexpr (TC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (TC == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
#pragma unroll
    for (int j = 0; j < TC; ++j) v[j] = p[j];
  }
}

__device__ inline float lane_of(const float4& a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}

template <int TR, int TC, int TY, int TX, typename T, typename O>
__global__ void __launch_bounds__(TX * TY)
fused_dense_kernel(const T* __restrict__ x, long long ldx,
                   const T* __restrict__ w, const T* __restrict__ b,
                   O* __restrict__ y, int M, int K, int N, int act,
                   int vx, int vw) {
  constexpr int BM = TR * TY, BN = TC * TX, NT = TX * TY;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ks = slab_depth(K);
  const int lds = x_stride(ks);
  const int buf = BM * lds + ks * BN;  // floats of one buffer
  const int nslab = K > 0 ? (K + ks - 1) / ks : 0;

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const int rows = min(BM, M - row0), cols = min(BN, N - col0);
  const T* xg = x + (long long)row0 * ldx;
  const T* wg = w + col0;

  // slab s into buffer s % 2: x rows [row0, +rows) x k [s*ks, +kt), w
  // rows k [s*ks, +kt) x columns [col0, +cols)
  auto load_slab = [&](int s) {
    float* xs = smem + (s & 1) * buf;
    const int k0 = s * ks, kt = min(ks, K - k0);
    if constexpr (std::is_same_v<T, float>) {
      stage_v<NT>(vx, xs, lds, xg + k0, ldx, rows, kt);
      stage_v<NT>(vw, xs + BM * lds, BN, wg + (long long)k0 * N, N, kt,
                  cols);
    } else {   // both slabs' loads in flight together, widened
      const repro_torch::io::Widen op[2] = {
          {xs, lds, xg + k0, ldx, rows, kt, vx},
          {xs + BM * lds, BN, wg + (long long)k0 * N, N, kt, cols, vw}};
      repro_torch::io::widen_all(op, threadIdx.x, NT);
    }
    cp_async_commit();
  };

  float acc[TR][TC];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = 0.0f;

  if (nslab > 0) load_slab(0);
  for (int s = 0; s < nslab; ++s) {
    if (s + 1 < nslab) {
      load_slab(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* xs = smem + (s & 1) * buf + ty * TR * lds;
    const float* ws = smem + (s & 1) * buf + BM * lds + tx * TC;
    const int kt = min(ks, K - s * ks);
    int k = 0;
    for (; k + 4 <= kt; k += 4) {
      float4 a[TR];
#pragma unroll
      for (int i = 0; i < TR; ++i)
        a[i] = *reinterpret_cast<const float4*>(xs + i * lds + k);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float wv[TC];
        load_cols<TC>(wv, ws + (k + u) * BN);
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          const float av = lane_of(a[i], u);
#pragma unroll
          for (int j = 0; j < TC; ++j) acc[i][j] = acc[i][j] + av * wv[j];
        }
      }
    }
    for (; k < kt; ++k) {
      float wv[TC];
      load_cols<TC>(wv, ws + k * BN);
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const float av = xs[i * lds + k];
#pragma unroll
        for (int j = 0; j < TC; ++j) acc[i][j] = acc[i][j] + av * wv[j];
      }
    }
    if (s + 1 < nslab) __syncthreads();  // before slab s + 2 overwrites it
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = ty * TR + i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int c = tx * TC + j;
      if (c >= cols) continue;
      float v = acc[i][j];
      if (b != nullptr) v += repro_torch::io::widen(b[col0 + c]);
      repro_torch::io::put(y + (long long)(row0 + r) * N + col0 + c,
                           repro_torch::activate(v, act));
    }
  }
}

// The tiles, indexed by the plan's variant: {TR, TC, TY, TX}.
constexpr int kTiles[][4] = {{1, 2, 8, 16},   // 0:  8 x 32, 128 threads
                             {2, 2, 8, 16},   // 1: 16 x 32, 128 threads
                             {2, 2, 16, 16},  // 2: 32 x 32, 256 threads
                             {4, 4, 16, 16},  // 3: 64 x 64, 256 threads
                             {1, 1, 16, 8}};  // 4: 16 x  8, 128 threads
constexpr int kVariants = sizeof(kTiles) / sizeof(kTiles[0]);

// The widest copy (4, 2 or 1 floats) that keeps every vector of a row
// inside the row and every source address aligned to its size.
int copy_width(const float* p, long long ld, int len) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  for (int v = 4; v > 1; v /= 2)
    if (a % (4 * v) == 0 && ld % v == 0 && len % v == 0) return v;
  return 1;
}
// The same for bf16: 8, 4, 2 or 1 elements.
int copy_width(const repro_torch::io::bf16* p, long long ld, int len) {
  return repro_torch::io::bf16_width(p, ld, len);
}

template <int TR, int TC, int TY, int TX, typename T, typename O>
int launch(const T* x, long long ldx, const T* w, const T* b, O* y, int M,
           int K, int N, int act, cudaStream_t stream) {
  constexpr int BM = TR * TY, BN = TC * TX;
  auto kern = fused_dense_kernel<TR, TC, TY, TX, T, O>;
  const long long smem = 4 * smem_floats(BM, BN, K);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  kern<<<grid, TX * TY, (size_t)smem, stream>>>(
      x, ldx, w, b, y, M, K, N, act, copy_width(x, ldx, K),
      copy_width(w, N, N));
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory a CTA of `variant` needs at depth K
// (the formula of kernels/fused_dense.py:smem_bytes).
extern "C" long long fused_dense_smem_bytes(int variant, int K) {
  if (variant < 0 || variant >= kVariants) return -1;
  const int* t = kTiles[variant];
  return 4 * smem_floats(t[0] * t[2], t[1] * t[3], K);
}

namespace {

template <typename T, typename O>
int launch_variant(const void* x, long long ldx, const void* w,
                   const void* b, void* y, int M, int K, int N, int act,
                   int variant, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const T* bt = static_cast<const T*>(b);
  O* yt = static_cast<O*>(y);
  switch (variant) {
    case 0: return launch<1, 2, 8, 16>(xt, ldx, wt, bt, yt, M, K, N, act, s);
    case 1: return launch<2, 2, 8, 16>(xt, ldx, wt, bt, yt, M, K, N, act, s);
    case 2: return launch<2, 2, 16, 16>(xt, ldx, wt, bt, yt, M, K, N, act, s);
    case 3: return launch<4, 4, 16, 16>(xt, ldx, wt, bt, yt, M, K, N, act, s);
    case 4: return launch<1, 1, 16, 8>(xt, ldx, wt, bt, yt, M, K, N, act, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x:(M,K) with row stride ldx >= K (any, for one row) and unit column
// stride, w:(K,N), b:(N,) or null, all of the dtype in_dtype; y:(M,N) of
// out_dtype (dtype_io.cuh: 0 = f32, 1 = bf16); w, b and y contiguous, on
// the device of `stream`. act: 0 = none, 1 = relu, 2 = gelu, 3 = silu
// (activation.cuh). variant: the tile (kTiles).
extern "C" int fused_dense_ex(const void* x, long long ldx, const void* w,
                              const void* b, void* y, int M, int K, int N,
                              int act, int variant, int in_dtype,
                              int out_dtype, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  if (K < 0 || (M > 1 && ldx < K)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  REPRO_DISPATCH_IO(in_dtype, out_dtype,
                    return launch_variant<T, O>(x, ldx, w, b, y, M, K, N,
                                                act, variant, s));
}
