// gravnet_block: one whole GravNet block per launch, f32, for Hopper
// (sm_90a).
//
// Replaces: repro/kernels/gravnet_block.py — gravnet_block_batched_pallas
// and gravnet_block_pallas (the latter is this kernel at B = 1).
//
//   S = x @ Ws + bs, F = x @ Wf + bf           (all n rows of the event)
//   agg = GravNet cell over the event           (gravnet_cell_reg.cuh)
//   y = act(concat(x, agg) @ Wo + bo)           (the CTA's query rows)
//   or, with concat_x = 0, y = act(agg @ Wo + bo): Wo is (2 d_f, d_out)
//   act: none, relu, gelu or silu (activation.cuh)
//
// Bound on this card: arithmetic, narrowly. At the fp path's shape,
// x (2,128,64), k = 8, d_s = 4, d_f = 22, the block needs about 5.1 M
// operations (77 ns at the 67 TFLOP/s f32 rate, outside the tensor
// cores) against about 167 KB moved (x, mask, weights, output: 50 ns at
// 3.35 TB/s). What each launch actually pays is latency: the chain of
// dependent steps inside one CTA. The first version (one CTA of 8 warps
// per 32 query rows, 8 CTAs at the fp path's 2 events) took 52 us:
// the staging one scalar load a thread at a time, S and F one output a
// thread with a 64-long chain behind an integer division, the
// shared-memory cell 4 rows a warp in turn (each round a scan of the
// row, a 10-shuffle argmin and a knockout store), and the output dense
// one output a thread (kernels/phase_split.py, PERF.md).
//
// Design: the int8 twin's (gravnet_block_int8.cu) in f32. One CTA of 16
// warps per (16 query rows, event), one warp per query row: 16 CTAs at
// the fp path's 2 events, one per SM. Every CTA needs S and F of all n
// rows of its event, so its chain starts with the whole event:
//   1. one round trip: x, the mask, the weights and the biases as
//      cp.async copies into shared memory, 16 bytes where the operand's
//      alignment, row stride and row length allow, else 8 or 4 (x and the
//      weights into rows padded to 4 floats, read as float4), in two
//      groups: Wo and bo land while S, F and the cell run;
//   2. S and F of all n rows, register-tiled: each thread owns 4 rows by
//      4 columns (1 row by 4 where that fills the CTA once), each output
//      with its own chain summed in k order; the ILP comes from the
//      independent outputs, and each value read from shared memory
//      serves 4 of them;
//   3. the cell, one warp per query row with its distance row in
//      registers (gravnet_cell_reg.cuh), the mean divided by k (the IEEE
//      division), and the warp's row of h = concat(x_i, agg_i) written
//      once to shared memory;
//   4. the output dense of the CTA's rows, 4 rows by 1 column a thread
//      (each Wo value read from shared memory serves 4 rows), every sum
//      in k order; only y is written to device memory.
// At the fp path's shape a launch takes 14 us on an NVIDIA H100 80GB
// HBM3 at 700 W, a CTA's phases 2.7, 4.5, 3.9 and 2.7 us
// (kernels/phase_split.py; PERF.md). Of nine register tilings those two
// were the fastest or tied at every path shape. Splitting S and F over a
// thread-block cluster of the event's CTAs, shared through distributed
// shared memory, was slower at every path shape: the cluster's two
// barriers and the remote copies cost more than the S/F work they save.
// The cell's candidates per lane are a template parameter (1, 2, 4, 8 or
// 16: n up to 32, 64, 128, 256 or 512); the widths and k are arguments.
// Past 512 hits or d_f 128 (the cell's registers), or where this plan's
// shared memory does not fit and the first version's does, the launch
// runs the first version's kernel (gravnet_block_shared_kernel, the
// shared-memory cell of gravnet_cell.cuh, 32 query rows a CTA): a second
// hand-written path chosen by shape (kernels/gravnet_block.py:plan).
// Both are scalar f32 in the plain version's order with products and
// sums rounded separately (-fmad=false), no TF32 and no tensor cores: a
// chain of dependent steps gains nothing from them, and they would cost
// the bitwise contract. kernels/ref.py:gravnet_block_ref reproduces both
// under none and relu; under gelu and silu the last step rounds as
// CUDA's tanhf and expf do (the float32 row).
//
// The bf16 forms (x, the weights and the biases of one type T, the output
// of type O): both kernels stage a bf16 operand by ordinary loads, each
// value widened exactly into the same f32 shared memory (dtype_io.cuh),
// and round each output once where O is bf16; the arithmetic is the f32
// form's, so every form is bitwise with the plain version.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "activation.cuh"
#include "dtype_io.cuh"
#include "gravnet_cell.cuh"
#include "gravnet_cell_reg.cuh"

namespace {

using repro_torch::regcell::kMaxDfPerLane;

constexpr int kThreads = 512;
constexpr int kMaxRows = kThreads / 32;   // query rows per CTA: a warp each
constexpr int kMaxHits = 512;    // 16 candidates per lane
constexpr int kMaxDf = 32 * kMaxDfPerLane;
constexpr long long kSmemLimit = 232448;   // 227 KB a block on Hopper
// register tiles, in outputs a thread: S and F (kSfRows rows, or 1, by
// kSfCols columns), the output dense (kOutRows by kOutCols)
constexpr int kSfRows = 4, kSfCols = 4;
constexpr int kOutRows = 4, kOutCols = 1;

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

struct Layout {     // offsets, in floats, into dynamic shared memory; each
                    // a multiple of 4 (16 bytes)
  int ldx, ldws, ldwf, ldwo, ldh;   // row strides
  int xs, s, f, msk, ws, wf, wo, bs, bf, bo, h, total;
};

// cx: the columns of x in a row of h, dh (concat_x) or 0
__host__ __device__ inline Layout layout(int n, int dh, int ds, int df,
                                         int dout, int cx) {
  const int dcat = cx + 2 * df;
  Layout L;
  L.ldx = round4(dh) + 4;   // float4 rows, a thread's rows on other banks
  L.ldws = round4(ds);
  L.ldwf = round4(df);
  L.ldwo = round4(dout);
  L.ldh = round4(dcat) + 4;
  int o = 0;
  L.xs = o;  o += round4((n + kSfRows - 1) / kSfRows * kSfRows * L.ldx);
  L.s = o;   o += round4(n * ds);
  L.f = o;   o += round4(n * df);
  L.msk = o; o += round4(n);
  L.ws = o;  o += dh * L.ldws;
  L.wf = o;  o += dh * L.ldwf;
  L.wo = o;  o += dcat * L.ldwo;
  L.bs = o;  o += round4(ds);
  L.bf = o;  o += round4(df);
  L.bo = o;  o += round4(dout);
  L.h = o;   o += kMaxRows * L.ldh;
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

template <int V>
__device__ inline void stage(float* s, int lds, const float* g, int ldg,
                             int rows, int cols) {
  const int per_row = cols / V;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row, c = (i - r * per_row) * V;
    cp_async<V>(s + r * lds + c, g + (size_t)r * ldg + c);
  }
}

// rows x cols of g (row stride ldg) into s (row stride lds, a multiple of
// 4, 16-byte aligned): copies of the widest of 4, 2 and 1 floats that
// keeps every copy inside a row and its source aligned to its size.
__device__ inline void stage_rows(float* s, int lds, const float* g,
                                  int ldg, int rows, int cols) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(g);
  if (a % 16 == 0 && ldg % 4 == 0 && cols % 4 == 0)
    stage<4>(s, lds, g, ldg, rows, cols);
  else if (a % 8 == 0 && ldg % 2 == 0 && cols % 2 == 0)
    stage<2>(s, lds, g, ldg, rows, cols);
  else
    stage<1>(s, lds, g, ldg, rows, cols);
}

template <int TC>
__device__ inline void load_cols(float (&v)[TC], const float* p) {
  if constexpr (TC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    static_assert(TC == 1, "tiles of 1 or 4 columns");
    v[0] = *p;
  }
}

__device__ inline float lane_of(const float4& a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}

// acc[i][j] = sum over k < K, in order from 0, of a[i * lda + k] *
// w[k * ldw + j], each product and sum rounded (the plain version's
// _dot_last). a and w in shared memory, 16-byte aligned, lda and ldw
// multiples of 4.
template <int TR, int TC>
__device__ inline void tile_dot(float (&acc)[TR][TC],
                                const float* __restrict__ a, int lda,
                                const float* __restrict__ w, int ldw,
                                int K) {
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = 0.0f;
  int k = 0;
  for (; k + 4 <= K; k += 4) {
    float4 av[TR];
#pragma unroll
    for (int i = 0; i < TR; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + i * lda + k);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float wv[TC];
      load_cols<TC>(wv, w + (k + u) * ldw);
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const float x = lane_of(av[i], u);
#pragma unroll
        for (int j = 0; j < TC; ++j) acc[i][j] = acc[i][j] + x * wv[j];
      }
    }
  }
  for (; k < K; ++k) {
    float wv[TC];
    load_cols<TC>(wv, w + k * ldw);
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const float x = a[i * lda + k];
#pragma unroll
      for (int j = 0; j < TC; ++j) acc[i][j] = acc[i][j] + x * wv[j];
    }
  }
}

// CPL: candidates per lane (n <= 32 CPL).
template <int CPL, typename T, typename O>
__global__ void __launch_bounds__(kThreads)
gravnet_block_kernel(const T* __restrict__ x,
                     const float* __restrict__ mask,
                     const T* __restrict__ ws, const T* __restrict__ bs,
                     const T* __restrict__ wf, const T* __restrict__ bf,
                     const T* __restrict__ wo, const T* __restrict__ bo,
                     O* __restrict__ y, int n, int dh, int ds, int df,
                     int dout, int k, float scale, int act, int cx,
                     int bm) {
  extern __shared__ __align__(16) float smem[];
  const int dcat = cx + 2 * df;
  const Layout L = layout(n, dh, ds, df, dout, cx);
  float* const xs = smem + L.xs;
  float* const S = smem + L.s;
  float* const F = smem + L.f;
  float* const msk = smem + L.msk;
  float* const Ws = smem + L.ws;
  float* const Wf = smem + L.wf;
  float* const Wo = smem + L.wo;
  float* const Bs = smem + L.bs;
  float* const Bf = smem + L.bf;
  float* const Bo = smem + L.bo;
  float* const H = smem + L.h;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int event = blockIdx.y;
  const int row0 = blockIdx.x * bm;
  const int rows = min(bm, n - row0);

  // 1. staging, one round trip: x, the mask, the weights and the biases
  // into shared memory by cp.async, in two groups: what S and F read,
  // then Wo and bo, which land while S, F and the cell run (bf16: the
  // mask by cp.async, the rest by loads in flight together, widened)
  const T* const xe = x + (size_t)event * n * dh;
  if constexpr (std::is_same_v<T, float>) {
    stage_rows(xs, L.ldx, xe, dh, n, dh);
    stage_rows(msk, 0, mask + (size_t)event * n, 0, 1, n);
    stage_rows(Ws, L.ldws, ws, ds, dh, ds);
    stage_rows(Wf, L.ldwf, wf, df, dh, df);
    stage_rows(Bs, 0, bs, 0, 1, ds);
    stage_rows(Bf, 0, bf, 0, 1, df);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    stage_rows(Wo, L.ldwo, wo, dout, dcat, dout);
    stage_rows(Bo, 0, bo, 0, 1, dout);
  } else {
    stage_rows(msk, 0, mask + (size_t)event * n, 0, 1, n);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    using repro_torch::io::bf16_width;
    using repro_torch::io::flat;
    const repro_torch::io::Widen op[7] = {
        {xs, L.ldx, xe, dh, n, dh, bf16_width(xe, dh, dh)},
        {Ws, L.ldws, ws, ds, dh, ds, bf16_width(ws, ds, ds)},
        {Wf, L.ldwf, wf, df, dh, df, bf16_width(wf, df, df)},
        {Wo, L.ldwo, wo, dout, dcat, dout, bf16_width(wo, dout, dout)},
        flat(Bs, bs, ds), flat(Bf, bf, df), flat(Bo, bo, dout)};
    repro_torch::io::widen_all(op, tid, kThreads);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncthreads();

  // 2. S and F of every row of the event: TR rows by kSfCols columns a
  // thread, the column groups of S, then of F (columns past d_s and d_f
  // are summed over the padding and never stored)
  constexpr int TC = kSfCols;
  const int nts = (ds + TC - 1) / TC, ng = nts + (df + TC - 1) / TC;
  auto s_and_f = [&](auto tr) {
    constexpr int TR = decltype(tr)::value;
    for (int u = tid; u < (n + TR - 1) / TR * ng; u += kThreads) {
      const int g = u % ng, r0 = u / ng * TR;
      const bool is_s = g < nts;
      const int c0 = TC * (is_s ? g : g - nts);
      const int ld = is_s ? ds : df;
      float acc[TR][TC];
      tile_dot<TR, TC>(acc, xs + r0 * L.ldx, L.ldx,
                       (is_s ? Ws : Wf) + c0, is_s ? L.ldws : L.ldwf, dh);
      float* const out = is_s ? S : F;
      const float* const bias = is_s ? Bs : Bf;
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j)
          if (r0 + i < n && c0 + j < ld)
            out[(r0 + i) * ld + c0 + j] = acc[i][j] + bias[c0 + j];
    }
  };
  if (n * ng <= kThreads)
    s_and_f(std::integral_constant<int, 1>{});
  else
    s_and_f(std::integral_constant<int, kSfRows>{});
  __syncthreads();

  // 3. one warp per query row: the cell, then the row's h = concat(x_i,
  // [sum / k, max]) (without x_i when cx = 0) into shared memory
  if (warp < rows) {
    float sum[kMaxDfPerLane], mx[kMaxDfPerLane];
    repro_torch::regcell::cell_row<CPL>(row0 + warp, n, ds, df, k, scale,
                                        S, F, msk, sum, mx);
    float* const hrow = H + warp * L.ldh;
    const float* const xrow = xs + (row0 + warp) * L.ldx;
    for (int q = lane; q < cx; q += 32) hrow[q] = xrow[q];
#pragma unroll
    for (int u = 0; u < kMaxDfPerLane; ++u) {
      const int c = lane + 32 * u;
      if (c < df) {
        hrow[cx + c] = sum[u] / (float)k;
        hrow[cx + df + c] = mx[u];
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // 4. y = act(h_i @ Wo + bo) for the CTA's rows, kOutRows rows by
  // kOutCols columns a thread: each Wo value read from shared memory
  // serves kOutRows rows (rows past the CTA's read h's spare rows and are
  // never stored)
  const int ncg = (dout + kOutCols - 1) / kOutCols;
  for (int u = tid; u < (rows + kOutRows - 1) / kOutRows * ncg;
       u += kThreads) {
    const int r0 = u / ncg * kOutRows, c0 = kOutCols * (u % ncg);
    float acc[kOutRows][kOutCols];
    tile_dot<kOutRows, kOutCols>(acc, H + r0 * L.ldh, L.ldh, Wo + c0,
                                 L.ldwo, dcat);
#pragma unroll
    for (int i = 0; i < kOutRows; ++i) {
#pragma unroll
      for (int j = 0; j < kOutCols; ++j) {
        if (r0 + i < rows && c0 + j < dout)
          repro_torch::io::put(
              y + ((size_t)event * n + row0 + r0 + i) * dout + c0 + j,
              repro_torch::activate(acc[i][j] + Bo[c0 + j], act));
      }
    }
  }
}

// ---------------------------------------------------------------------
// The first version, kept for the shapes the register cell does not
// take: one CTA of 256 threads (8 warps) per (32 query rows, event)
// stages the event and the weights one scalar load a thread at a time,
// computes S, F and |s_j|^2 for all n rows one output a thread, runs the
// shared-memory cell of gravnet_cell.cuh 4 rows a warp with the row's
// distances in a warp-private n-float buffer, and the output dense one
// output a thread.
constexpr int kSharedThreads = 256;
constexpr int kSharedWarps = kSharedThreads / 32;

struct SharedLayout {     // offsets, in floats, into dynamic shared memory
  int xs, s, f, sq, msk, ws, bs, wf, bf, wo, bo, agg, d2, total;
};

__host__ __device__ inline SharedLayout shared_layout(int n, int dh, int ds,
                                                      int df, int dout,
                                                      int bm, int cx) {
  const int dcat = cx + 2 * df;
  SharedLayout L;
  int o = 0;
  L.xs = o;  o += n * dh;
  L.s = o;   o += n * ds;
  L.f = o;   o += n * df;
  L.sq = o;  o += n;
  L.msk = o; o += n;
  L.ws = o;  o += dh * ds;
  L.bs = o;  o += ds;
  L.wf = o;  o += dh * df;
  L.bf = o;  o += df;
  L.wo = o;  o += dcat * dout;
  L.bo = o;  o += dout;
  L.agg = o; o += bm * 2 * df;
  L.d2 = o;  o += kSharedWarps * n;
  L.total = o;
  return L;
}

template <typename T, typename O>
__global__ void __launch_bounds__(kSharedThreads)
gravnet_block_shared_kernel(const T* __restrict__ x,
                            const float* __restrict__ mask,
                            const T* __restrict__ ws,
                            const T* __restrict__ bs,
                            const T* __restrict__ wf,
                            const T* __restrict__ bf,
                            const T* __restrict__ wo,
                            const T* __restrict__ bo, O* __restrict__ y,
                            int n, int dh, int ds, int df, int dout, int k,
                            float scale, int act, int cx, int bm) {
  extern __shared__ float smem_shared[];
  float* const smem = smem_shared;
  const int dcat = cx + 2 * df;
  const SharedLayout L = shared_layout(n, dh, ds, df, dout, bm, cx);
  float* xs = smem + L.xs;
  float* S = smem + L.s;
  float* F = smem + L.f;
  float* sq = smem + L.sq;
  float* msk = smem + L.msk;
  float* Ws = smem + L.ws;
  float* Bs = smem + L.bs;
  float* Wf = smem + L.wf;
  float* Bf = smem + L.bf;
  float* Wo = smem + L.wo;
  float* Bo = smem + L.bo;
  float* agg = smem + L.agg;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int event = blockIdx.y;
  const int row0 = blockIdx.x * bm;
  const int rows = min(bm, n - row0);
  const T* xe = x + (size_t)event * n * dh;
  using repro_torch::io::widen;

  // stage the event and the weights
  for (int e = tid; e < n * dh; e += kSharedThreads) xs[e] = widen(xe[e]);
  for (int e = tid; e < n; e += kSharedThreads)
    msk[e] = mask[(size_t)event * n + e];
  for (int e = tid; e < dh * ds; e += kSharedThreads) Ws[e] = widen(ws[e]);
  for (int e = tid; e < dh * df; e += kSharedThreads) Wf[e] = widen(wf[e]);
  for (int e = tid; e < ds; e += kSharedThreads) Bs[e] = widen(bs[e]);
  for (int e = tid; e < df; e += kSharedThreads) Bf[e] = widen(bf[e]);
  for (int e = tid; e < dcat * dout; e += kSharedThreads)
    Wo[e] = widen(wo[e]);
  for (int e = tid; e < dout; e += kSharedThreads) Bo[e] = widen(bo[e]);
  __syncthreads();

  // prologue: S and F for every row of the event
  const int dsf = ds + df;
  for (int e = tid; e < n * dsf; e += kSharedThreads) {
    const int j = e / dsf, c = e % dsf;
    const bool is_s = c < ds;
    const float* W = is_s ? Ws : Wf;
    const int cc = is_s ? c : c - ds;
    const int ld = is_s ? ds : df;
    float acc = 0.0f;
    for (int kk = 0; kk < dh; ++kk) acc += xs[j * dh + kk] * W[kk * ld + cc];
    if (is_s) S[j * ds + cc] = acc + Bs[cc];
    else F[j * df + cc] = acc + Bf[cc];
  }
  __syncthreads();
  for (int j = tid; j < n; j += kSharedThreads) {
    float acc = 0.0f;
    for (int d = 0; d < ds; ++d) acc += S[j * ds + d] * S[j * ds + d];
    sq[j] = acc;
  }
  __syncthreads();

  // body: one warp per query row
  float* d2row = smem + L.d2 + warp * n;
  for (int r = warp; r < rows; r += kSharedWarps)
    repro_torch::gravnet_cell_row(row0 + r, n, ds, df, k, scale, S, sq, F,
                                  msk, d2row, agg + r * 2 * df);
  __syncthreads();

  // epilogue: y = act(concat(x_i, agg_i) @ Wo + bo), or act(agg_i @ Wo
  // + bo) when cx = 0
  for (int e = tid; e < rows * dout; e += kSharedThreads) {
    const int r = e / dout, c = e % dout;
    const int i = row0 + r;
    float acc = 0.0f;
    int kk = 0;
    for (int q = 0; q < cx; ++q, ++kk) acc += xs[i * dh + q] * Wo[kk * dout + c];
    for (int q = 0; q < 2 * df; ++q, ++kk)
      acc += agg[r * 2 * df + q] * Wo[kk * dout + c];
    repro_torch::io::put(y + ((size_t)event * n + i) * dout + c,
                         repro_torch::activate(acc + Bo[c], act));
  }
}

// Whether a launch of bm query rows a CTA runs the register cell (else
// the first version): kernels/gravnet_block.py:plan's rule.
bool register_cell(int n, int dh, int ds, int df, int dout, int bm,
                   int cx) {
  return bm >= 1 && bm <= kMaxRows && n <= kMaxHits && df <= kMaxDf &&
         4LL * layout(n, dh, ds, df, dout, cx).total <= kSmemLimit;
}

template <typename Kernel, typename T, typename O>
int launch(Kernel kernel, int threads, long long smem, int B, int n,
           int bm, cudaStream_t stream, const T* x, const float* mask,
           const T* ws, const T* bs, const T* wf, const T* bf, const T* wo,
           const T* bo, O* y, int dh, int ds, int df, int dout, int k,
           float scale, int act, int cx) {
  // The opt-in above 48 KB holds per device, so it is set on every such
  // launch (a cheap call) rather than cached for the process.
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((n + bm - 1) / bm, B);
  kernel<<<grid, threads, (size_t)smem, stream>>>(
      x, mask, ws, bs, wf, bf, wo, bo, y, n, dh, ds, df, dout, k, scale, act,
      cx, bm);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory one CTA of bm query rows needs at these
// shapes, on the path that gravnet_block_f32_ex takes for them.
extern "C" long long gravnet_block_smem_bytes(int n, int dh, int ds, int df,
                                              int dout, int bm,
                                              int concat_x) {
  const int cx = concat_x ? dh : 0;
  if (register_cell(n, dh, ds, df, dout, bm, cx))
    return 4LL * layout(n, dh, ds, df, dout, cx).total;
  return 4LL * shared_layout(n, dh, ds, df, dout, bm, cx).total;
}

namespace {

template <typename T, typename O>
int launch_io(const void* const* w, const float* mask, void* y, int B,
              int n, int dh, int ds, int df, int dout, int k, float scale,
              int act, int concat_x, int bm, cudaStream_t st) {
  const T* x = static_cast<const T*>(w[0]);
  const T* ws = static_cast<const T*>(w[1]);
  const T* bs = static_cast<const T*>(w[2]);
  const T* wf = static_cast<const T*>(w[3]);
  const T* bf = static_cast<const T*>(w[4]);
  const T* wo = static_cast<const T*>(w[5]);
  const T* bo = static_cast<const T*>(w[6]);
  O* yt = static_cast<O*>(y);
  const int cx = concat_x ? dh : 0;
  const long long smem =
      gravnet_block_smem_bytes(n, dh, ds, df, dout, bm, concat_x);
  if (!register_cell(n, dh, ds, df, dout, bm, cx))
    return launch(gravnet_block_shared_kernel<T, O>, kSharedThreads, smem,
                  B, n, bm, st, x, mask, ws, bs, wf, bf, wo, bo, yt, dh, ds,
                  df, dout, k, scale, act, cx);
#define REPRO_LAUNCH(CPL)                                                   \
  return launch(gravnet_block_kernel<CPL, T, O>, kThreads, smem, B, n, bm, \
                st, x, mask, ws, bs, wf, bf, wo, bo, yt, dh, ds, df, dout,  \
                k, scale, act, cx)
  if (n <= 32) REPRO_LAUNCH(1);
  if (n <= 64) REPRO_LAUNCH(2);
  if (n <= 128) REPRO_LAUNCH(4);
  if (n <= 256) REPRO_LAUNCH(8);
  REPRO_LAUNCH(16);
#undef REPRO_LAUNCH
}

}  // namespace

// x:(B,n,dh) mask:(B,n) ws:(dh,ds) bs:(ds,) wf:(dh,df) bf:(df,)
// wo:(dh+2df,dout), or (2df,dout) when concat_x = 0, bo:(dout,) ->
// y:(B,n,dout); all contiguous, x, the weights and the biases of the
// dtype in_dtype, the mask f32, y of out_dtype (dtype_io.cuh: 0 = f32,
// 1 = bf16). act: 0 = none, 1 = relu, 2 = gelu, 3 = silu. bm query rows
// per CTA: at most 16 runs the register cell where the shape allows
// (register_cell), else the first version.
extern "C" int gravnet_block_ex(const void* x, const float* mask,
                                const void* ws, const void* bs,
                                const void* wf, const void* bf,
                                const void* wo, const void* bo, void* y,
                                int B, int n, int dh, int ds, int df,
                                int dout, int k, float scale, int act,
                                int concat_x, int bm, int in_dtype,
                                int out_dtype, void* stream) {
  if (B <= 0 || n <= 0) return (int)cudaGetLastError();
  if (bm < 1) return (int)cudaErrorInvalidValue;
  const void* const w[] = {x, ws, bs, wf, bf, wo, bo};
  const cudaStream_t st = (cudaStream_t)stream;
  REPRO_DISPATCH_IO(in_dtype, out_dtype,
                    return launch_io<T, O>(w, mask, y, B, n, dh, ds, df,
                                           dout, k, scale, act, concat_x,
                                           bm, st));
}

// The entry of the sources before the concat_x option: the f32 block
// with concat(x, agg), as kernels/phase_split.py and source_ab.py call
// it.
extern "C" int gravnet_block_f32(const float* x, const float* mask,
                                 const float* ws, const float* bs,
                                 const float* wf, const float* bf,
                                 const float* wo, const float* bo, float* y,
                                 int B, int n, int dh, int ds, int df,
                                 int dout, int k, float scale, int act,
                                 int bm, void* stream) {
  return gravnet_block_ex(x, mask, ws, bs, wf, bf, wo, bo, y, B, n, dh, ds,
                          df, dout, k, scale, act, 1, bm,
                          repro_torch::io::kF32, repro_torch::io::kF32,
                          stream);
}
