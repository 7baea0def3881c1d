// gravnet_block: one whole GravNet block per launch, f32, for Hopper
// (sm_90a).
//
// Replaces: repro/kernels/gravnet_block.py — gravnet_block_batched_pallas
// and gravnet_block_pallas (the latter is this kernel at B = 1).
//
//   S = x @ Ws + bs, F = x @ Wf + bf           (prologue, all n rows)
//   agg = GravNet cell over the event           (gravnet_cell.cuh)
//   y = act(concat(x, agg) @ Wo + bo)           (epilogue, bm query rows)
//
// Bound on this card: arithmetic, narrowly. At the main path's shape,
// x (2,128,64), k = 8, d_s = 4, d_f = 22, the block needs about 5.1 M
// operations (77 ns at the 67 TFLOP/s f32 rate, outside the tensor
// cores) against about 167 KB moved (x, mask, weights, output: 50 ns at
// 3.35 TB/s). What each launch actually pays is latency: a short chain
// of dependent shared-memory reductions per row (k rounds of a warp
// argmin) on a handful of CTAs.
//
// Design: one CTA of 256 threads (8 warps) per (row block of bm query
// rows, event). The CTA stages the whole event's x, the mask and all
// weights in shared memory (about 92 KB at the main path's shape, so it
// asks for dynamic shared memory above 48 KB); S and F for all n rows
// and |s_j|^2 stay there too — neither reaches device memory. Each
// warp runs the cell for one query row at a time, with the row's
// distances in a warp-private n-float buffer rather than a bm x n tile,
// and the row minimum found by a butterfly of shuffles. The epilogue
// reads concat(x_i, agg_i) from shared memory, so the only write to
// device memory is y. Row blocks of one event recompute the prologue,
// which is cheap at these widths and keeps CTAs independent: bm = 32
// gives 4 CTAs per event at n = 128. Every sum runs in the plain
// version's order with products and sums rounded separately
// (-fmad=false), so kernels/ref.py:gravnet_block_ref reproduces it.
#include <cuda_runtime.h>

#include "gravnet_cell.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Layout {     // offsets, in floats, into dynamic shared memory
  int xs, s, f, sq, msk, ws, bs, wf, bf, wo, bo, agg, d2, total;
};

__host__ __device__ inline Layout layout(int n, int dh, int ds, int df,
                                         int dout, int bm) {
  const int dcat = dh + 2 * df;
  Layout L;
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
  L.d2 = o;  o += kWarps * n;
  L.total = o;
  return L;
}

__global__ void __launch_bounds__(kThreads)
gravnet_block_kernel(const float* __restrict__ x,
                     const float* __restrict__ mask,
                     const float* __restrict__ ws,
                     const float* __restrict__ bs,
                     const float* __restrict__ wf,
                     const float* __restrict__ bf,
                     const float* __restrict__ wo,
                     const float* __restrict__ bo, float* __restrict__ y,
                     int n, int dh, int ds, int df, int dout, int k,
                     float scale, int relu, int bm) {
  extern __shared__ float smem[];
  const int dcat = dh + 2 * df;
  const Layout L = layout(n, dh, ds, df, dout, bm);
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
  const float* xe = x + (size_t)event * n * dh;

  // stage the event and the weights
  for (int e = tid; e < n * dh; e += kThreads) xs[e] = xe[e];
  for (int e = tid; e < n; e += kThreads) msk[e] = mask[(size_t)event * n + e];
  for (int e = tid; e < dh * ds; e += kThreads) Ws[e] = ws[e];
  for (int e = tid; e < dh * df; e += kThreads) Wf[e] = wf[e];
  for (int e = tid; e < ds; e += kThreads) Bs[e] = bs[e];
  for (int e = tid; e < df; e += kThreads) Bf[e] = bf[e];
  for (int e = tid; e < dcat * dout; e += kThreads) Wo[e] = wo[e];
  for (int e = tid; e < dout; e += kThreads) Bo[e] = bo[e];
  __syncthreads();

  // prologue: S and F for every row of the event
  const int dsf = ds + df;
  for (int e = tid; e < n * dsf; e += kThreads) {
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
  for (int j = tid; j < n; j += kThreads) {
    float acc = 0.0f;
    for (int d = 0; d < ds; ++d) acc += S[j * ds + d] * S[j * ds + d];
    sq[j] = acc;
  }
  __syncthreads();

  // body: one warp per query row
  float* d2row = smem + L.d2 + warp * n;
  for (int r = warp; r < rows; r += kWarps)
    repro_torch::gravnet_cell_row(row0 + r, n, ds, df, k, scale, S, sq, F,
                                  msk, d2row, agg + r * 2 * df);
  __syncthreads();

  // epilogue: y = act(concat(x_i, agg_i) @ Wo + bo)
  for (int e = tid; e < rows * dout; e += kThreads) {
    const int r = e / dout, c = e % dout;
    const int i = row0 + r;
    float acc = 0.0f;
    int kk = 0;
    for (int q = 0; q < dh; ++q, ++kk) acc += xs[i * dh + q] * Wo[kk * dout + c];
    for (int q = 0; q < 2 * df; ++q, ++kk)
      acc += agg[r * 2 * df + q] * Wo[kk * dout + c];
    float v = acc + Bo[c];
    if (relu) v = v > 0.0f ? v : 0.0f;
    y[((size_t)event * n + i) * dout + c] = v;
  }
}

}  // namespace

// Bytes of dynamic shared memory one CTA needs at these shapes.
extern "C" long long gravnet_block_smem_bytes(int n, int dh, int ds, int df,
                                              int dout, int bm) {
  return (long long)layout(n, dh, ds, df, dout, bm).total *
         (long long)sizeof(float);
}

// x:(B,n,dh) mask:(B,n) ws:(dh,ds) bs:(ds,) wf:(dh,df) bf:(df,)
// wo:(dh+2df,dout) bo:(dout,) -> y:(B,n,dout); all f32, contiguous.
extern "C" int gravnet_block_f32(const float* x, const float* mask,
                                 const float* ws, const float* bs,
                                 const float* wf, const float* bf,
                                 const float* wo, const float* bo, float* y,
                                 int B, int n, int dh, int ds, int df,
                                 int dout, int k, float scale, int act,
                                 int bm, void* stream) {
  const long long smem = gravnet_block_smem_bytes(n, dh, ds, df, dout, bm);
  // The opt-in above 48 KB holds per device, so it is set on every such
  // launch (a cheap call) rather than cached for the process.
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gravnet_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (B > 0 && n > 0) {
    dim3 grid((n + bm - 1) / bm, B);
    gravnet_block_kernel<<<grid, kThreads, (size_t)smem,
                           (cudaStream_t)stream>>>(
        x, mask, ws, bs, wf, bf, wo, bo, y, n, dh, ds, df, dout, k, scale, act,
        bm);
  }
  return (int)cudaGetLastError();
}
