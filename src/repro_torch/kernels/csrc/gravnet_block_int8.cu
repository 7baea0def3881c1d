// gravnet_block_int8: one whole quantized GravNet block per launch, for
// Hopper (sm_90a). The serve default's block (the mixed precision policy).
//
// Replaces: repro/kernels/gravnet_block.py —
// gravnet_block_int8_batched_pallas and gravnet_block_int8_pallas (the
// latter is this kernel at B = 1), cell _gravnet_block_int8_cell.
//
//   xq  = clip(rint(x / x_scale), +-127)                 (int8)
//   S   = (xq @ Ws_q) * (x_scale * ws_scale[c]) + bs       (exact int32
//   F   = (xq @ Wf_q) * (x_scale * wf_scale[c]) + bf        sums, f32)
//   agg = GravNet cell over the event                   (gravnet_cell.cuh)
//   agg = clip(rint(agg / agg_scale), +-127) * agg_scale   (int8 grid)
//   hq  = clip(rint(concat(x, agg) / h_scale), +-127)      (int8)
//   y   = act((hq @ Wo_q) * (h_scale * wo_scale[c]) + bo)  (f32)
//
// Bound on this card: memory, narrowly. At the main path's shape,
// x (2,128,64), k = 8, d_s = 4, d_f = 22, the launch moves about 141 KB
// (f32 x and y, the mask, int8 weights, scales: 42 ns at 3.35 TB/s)
// and needs about 0.94 M f32 operations (14 ns at the 67 TFLOP/s rate
// outside the tensor cores) and 4.4 M int8 operations (2 ns at 1,979
// TOPS). What each launch pays is latency: one CTA's chain of
// dependent shared-memory reductions.
//
// Design: the f32 block's (gravnet_block.cu): one CTA of 256 threads
// (8 warps) per (row block of bm query rows, event); the whole event's
// x, its int8 quantization, the mask, the int8 weights, their scales
// and the biases in dynamic shared memory (about 79 KB at the main
// path's shape); S, F and |s_j|^2 for all n rows there too; one warp
// per query row for the cell; the snapped aggregate and the quantized
// h of the bm query rows in shared memory; only y is written to device
// memory. The dots are int8 x int8 products into int32, exact in any
// order, so they equal the plain version's
// (kernels/ref.py:gravnet_block_int8_ref) bitwise; every f32 step keeps
// the reference's order of rounded operations (-fmad=false), each
// quantization divides by its scale (an IEEE division) and rounds with
// rintf, ties to even. The three activation scales are float arguments,
// as the reference bakes them as constants. The int8 output form of the
// reference (out_scale) is not ported: no path of the reference uses it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "gravnet_cell.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Layout {     // f32 offsets in floats, int8 offsets in bytes
  int xs, s, f, sq, msk, bs, bf, bo, wss, wfs, wos, agg, d2, nfloat;
  int xq, ws, wf, wo, hq, total_bytes;
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
  L.bs = o;  o += ds;
  L.bf = o;  o += df;
  L.bo = o;  o += dout;
  L.wss = o; o += ds;
  L.wfs = o; o += df;
  L.wos = o; o += dout;
  L.agg = o; o += bm * 2 * df;
  L.d2 = o;  o += kWarps * n;
  L.nfloat = o;
  int q = o * 4;
  L.xq = q;  q += n * dh;
  L.ws = q;  q += dh * ds;
  L.wf = q;  q += dh * df;
  L.wo = q;  q += dcat * dout;
  L.hq = q;  q += bm * dcat;
  L.total_bytes = q;
  return L;
}

__device__ inline int8_t quant(float v, float scale) {
  return (int8_t)(int)fminf(fmaxf(rintf(v / scale), -127.0f), 127.0f);
}

__global__ void __launch_bounds__(kThreads)
gravnet_block_int8_kernel(
    const float* __restrict__ x, const float* __restrict__ mask,
    const int8_t* __restrict__ ws, const float* __restrict__ bs,
    const int8_t* __restrict__ wf, const float* __restrict__ bf,
    const int8_t* __restrict__ wo, const float* __restrict__ bo,
    const float* __restrict__ ws_scale, const float* __restrict__ wf_scale,
    const float* __restrict__ wo_scale, float* __restrict__ y, int n, int dh,
    int ds, int df, int dout, int k, float scale, float x_scale,
    float agg_scale, float h_scale, int relu, int bm) {
  extern __shared__ float smem[];
  const int dcat = dh + 2 * df;
  const Layout L = layout(n, dh, ds, df, dout, bm);
  int8_t* const bytes = reinterpret_cast<int8_t*>(smem);
  float* xs = smem + L.xs;
  float* S = smem + L.s;
  float* F = smem + L.f;
  float* sq = smem + L.sq;
  float* msk = smem + L.msk;
  float* Bs = smem + L.bs;
  float* Bf = smem + L.bf;
  float* Bo = smem + L.bo;
  float* Wss = smem + L.wss;
  float* Wfs = smem + L.wfs;
  float* Wos = smem + L.wos;
  float* agg = smem + L.agg;
  int8_t* xq = bytes + L.xq;
  int8_t* Ws = bytes + L.ws;
  int8_t* Wf = bytes + L.wf;
  int8_t* Wo = bytes + L.wo;
  int8_t* hq = bytes + L.hq;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int event = blockIdx.y;
  const int row0 = blockIdx.x * bm;
  const int rows = min(bm, n - row0);
  const float* xe = x + (size_t)event * n * dh;

  // stage the event, quantized on the way in, and the weights
  for (int e = tid; e < n * dh; e += kThreads) {
    const float v = xe[e];
    xs[e] = v;
    xq[e] = quant(v, x_scale);
  }
  for (int e = tid; e < n; e += kThreads) msk[e] = mask[(size_t)event * n + e];
  for (int e = tid; e < dh * ds; e += kThreads) Ws[e] = ws[e];
  for (int e = tid; e < dh * df; e += kThreads) Wf[e] = wf[e];
  for (int e = tid; e < dcat * dout; e += kThreads) Wo[e] = wo[e];
  for (int e = tid; e < ds; e += kThreads) { Bs[e] = bs[e]; Wss[e] = ws_scale[e]; }
  for (int e = tid; e < df; e += kThreads) { Bf[e] = bf[e]; Wfs[e] = wf_scale[e]; }
  for (int e = tid; e < dout; e += kThreads) { Bo[e] = bo[e]; Wos[e] = wo_scale[e]; }
  __syncthreads();

  // prologue: int8 S and F dots for every row of the event, dequantized
  const int dsf = ds + df;
  for (int e = tid; e < n * dsf; e += kThreads) {
    const int j = e / dsf, c = e % dsf;
    const bool is_s = c < ds;
    const int8_t* W = is_s ? Ws : Wf;
    const int cc = is_s ? c : c - ds;
    const int ld = is_s ? ds : df;
    int acc = 0;
    for (int kk = 0; kk < dh; ++kk)
      acc += (int)xq[j * dh + kk] * (int)W[kk * ld + cc];
    if (is_s) S[j * ds + cc] = (float)acc * (x_scale * Wss[cc]) + Bs[cc];
    else F[j * df + cc] = (float)acc * (x_scale * Wfs[cc]) + Bf[cc];
  }
  __syncthreads();
  for (int j = tid; j < n; j += kThreads) {
    float acc = 0.0f;
    for (int d = 0; d < ds; ++d) acc += S[j * ds + d] * S[j * ds + d];
    sq[j] = acc;
  }
  __syncthreads();

  // body: one warp per query row, f32
  float* d2row = smem + L.d2 + warp * n;
  for (int r = warp; r < rows; r += kWarps)
    repro_torch::gravnet_cell_row(row0 + r, n, ds, df, k, scale, S, sq, F,
                                  msk, d2row, agg + r * 2 * df);
  __syncthreads();

  // snap agg to its int8 grid and quantize h = concat(x_i, agg_i)
  for (int e = tid; e < rows * dcat; e += kThreads) {
    const int r = e / dcat, q = e % dcat;
    float v;
    if (q < dh) {
      v = xs[(row0 + r) * dh + q];
    } else {
      const float a = agg[r * 2 * df + (q - dh)];
      v = fminf(fmaxf(rintf(a / agg_scale), -127.0f), 127.0f) * agg_scale;
    }
    hq[e] = quant(v, h_scale);
  }
  __syncthreads();

  // epilogue: y = act((hq_i @ Wo_q) * (h_scale * wo_scale[c]) + bo)
  for (int e = tid; e < rows * dout; e += kThreads) {
    const int r = e / dout, c = e % dout;
    int acc = 0;
    for (int q = 0; q < dcat; ++q)
      acc += (int)hq[r * dcat + q] * (int)Wo[q * dout + c];
    float v = (float)acc * (h_scale * Wos[c]) + Bo[c];
    if (relu) v = v > 0.0f ? v : 0.0f;
    y[((size_t)event * n + row0 + r) * dout + c] = v;
  }
}

}  // namespace

// Bytes of dynamic shared memory one CTA needs at these shapes.
extern "C" long long gravnet_block_int8_smem_bytes(int n, int dh, int ds,
                                                   int df, int dout, int bm) {
  return (long long)layout(n, dh, ds, df, dout, bm).total_bytes;
}

// x:(B,n,dh) f32, mask:(B,n) f32, ws:(dh,ds) wf:(dh,df) wo:(dh+2df,dout)
// int8, bs/bf/bo and the *_scale vectors f32 of their output widths ->
// y:(B,n,dout) f32; all contiguous.
extern "C" int gravnet_block_int8(
    const float* x, const float* mask, const int8_t* ws, const float* bs,
    const int8_t* wf, const float* bf, const int8_t* wo, const float* bo,
    const float* ws_scale, const float* wf_scale, const float* wo_scale,
    float* y, int B, int n, int dh, int ds, int df, int dout, int k,
    float scale, float x_scale, float agg_scale, float h_scale, int act,
    int bm, void* stream) {
  const long long smem = gravnet_block_int8_smem_bytes(n, dh, ds, df, dout,
                                                       bm);
  // The opt-in above 48 KB holds per device, so it is set on every such
  // launch (a cheap call) rather than cached for the process.
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gravnet_block_int8_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (B > 0 && n > 0) {
    dim3 grid((n + bm - 1) / bm, B);
    gravnet_block_int8_kernel<<<grid, kThreads, (size_t)smem,
                                (cudaStream_t)stream>>>(
        x, mask, ws, bs, wf, bf, wo, bo, ws_scale, wf_scale, wo_scale, y, n,
        dh, ds, df, dout, k, scale, x_scale, agg_scale, h_scale, act, bm);
  }
  return (int)cudaGetLastError();
}
