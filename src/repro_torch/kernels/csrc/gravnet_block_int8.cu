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
//   agg = GravNet cell over the event                (gravnet_cell_reg.cuh)
//   agg = clip(rint(agg / agg_scale), +-127) * agg_scale   (int8 grid)
//   hq  = clip(rint(concat(x, agg) / h_scale), +-127)      (int8)
//         (or of agg alone, concat_x = 0: Wo_q is (2 d_f, d_out))
//   y   = act((hq @ Wo_q) * (h_scale * wo_scale[c]) + bo)  (f32)
//   out = y, or clip(rint(y / out_scale), +-127)      (int8, out_int8)
//   act: none, relu, gelu or silu (activation.cuh)
//
// Bound on this card: latency. At the main path's shape, x (2,128,64),
// k = 8, d_s = 4, d_f = 22, the launch moves about 141 KB (42 ns at
// 3.35 TB/s) and needs about 0.94 M f32 operations (14 ns at 67 TFLOP/s)
// and 4.4 M int8 operations (2 ns at 1,979 TOPS). The first version
// (one CTA of 32 query rows per event quarter, 8 CTAs) took 64 us, all
// of it dependent chains inside each CTA (clock64 stamps, H100,
// kernels/phase_split.py): 13 us staging x one load at a time behind
// each value's division, 11 us of scalar S/F dots, 23 us of cell (4 rows
// per warp, each round a scan, a 10-shuffle argmin and a knockout through
// shared memory), 5 us of h quantization and 10 us of scalar output dots.
//
// Design: one CTA of 16 warps per (16 query rows, event), one warp per
// query row: 16 CTAs at the main path's 2 events (the first version had
// 8), one per SM, so a launch takes as long as one CTA's chain. Every CTA
// needs S and F of all n rows of its event, so its chain starts with the
// whole event: more, smaller CTAs would each repeat that work and be no
// shorter. The chain:
//   1. one round trip: the int8 weights (16-byte) and the mask, biases
//      and scales (4-byte) as cp.async copies into shared memory, x as
//      16-byte vector loads into registers;
//   2. x quantized once per CTA into xq (row-major, a row stride of
//      16 mod 32 bytes: conflict-free fragment loads), without an f32
//      division per value (int8_quant.cuh); the weights transposed in
//      shared memory, their depth zero-padded to the MMA's 32, so that
//      every MMA fragment is one 32-bit load;
//   3. S and F of all n rows on the int8 tensor cores (mma.sync
//      m16n8k32, mma_s8.cuh), 16 x 8 tiles spread over the warps, then
//      dequantized;
//   4. the cell, one warp per query row with its distance row in
//      registers (gravnet_cell_reg.cuh), then the warp's row of h,
//      snapped and quantized from registers;
//   5. the output dense of the CTA's rows on the int8 tensor cores, 8
//      columns per warp; only y is written to device memory.
// The cell's candidates per lane are a template parameter (1, 2, 4, 8 or
// 16: n up to 32, 64, 128, 256 or 512); the widths and k are arguments.
// The int32 sums are exact in any order, and every f32 step keeps the reference's order of
// rounded operations (-fmad=false), so the kernel equals its plain
// version (kernels/ref.py:gravnet_block_int8_ref) bitwise under none and
// relu: each division (the quantizations, the snap, the mean's / k, the
// int8 output's / out_scale) rounds as the IEEE division does, and
// rounding is half to even. Under gelu and silu the last step rounds as
// CUDA's tanhf and expf do (the float32 row; an int8 output a step away
// at most). The activation scales are float arguments, as the reference
// bakes them as constants.
//
// x may be bf16 (the TPU kernel reads it as f32, x.astype(jnp.float32)):
// it is loaded as bf16, 8 bytes a vector of 4, widened exactly
// (dtype_io.cuh) and quantized and concatenated as the f32 x is, so the
// form is bitwise with the plain version; the output stays f32 or int8.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "activation.cuh"
#include "dtype_io.cuh"
#include "gravnet_cell_reg.cuh"
#include "int8_quant.cuh"
#include "mma_s8.cuh"

namespace {

using repro_torch::mma_load_a;
using repro_torch::mma_load_b;
using repro_torch::mma_s8_16x8x32;
using repro_torch::quotient;
using repro_torch::quotient_exact;
using repro_torch::round_clip_s8;
using repro_torch::regcell::kMaxDfPerLane;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 16;     // query rows per CTA: one MMA row tile
constexpr int kMaxHits = 512;    // 16 candidates per lane
constexpr int kXV = 4;           // x vectors in flight per thread

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

struct Layout {     // byte offsets into dynamic shared memory
  int ldx, ldh;     // row strides of xq and hq: a multiple of 32, plus 16
  int xq, hq, wsft, wot;       // int8, the weights transposed
  int rws, rwf, rwo;  // the weights as they lie in device memory, each
  int s, f;           // 16-byte aligned; S and F reuse their space
  int xs, msk, bs, bf, bo, wss, wfs, wos;    // f32
  int total;
};

// cx: the columns of x in a row of h, dh (concat_x) or 0
__host__ __device__ inline Layout layout(int n, int dh, int ds, int df,
                                         int dout, int bm, int cx) {
  const int dcat = cx + 2 * df;
  Layout L;
  L.ldx = round_up(dh, 32) + 16;
  L.ldh = round_up(dcat, 32) + 16;
  int o = 0;
  L.xq = o;   o += round_up(n, 16) * L.ldx;
  L.hq = o;   o += kMaxRows * L.ldh;
  L.wsft = o; o += (round_up(ds, 8) + round_up(df, 8)) * L.ldx;
  L.wot = o;  o += round_up(dout, 8) * L.ldh;
  L.rws = o;
  L.rwf = L.rws + round_up(dh * ds, 16);
  L.rwo = L.rwf + round_up(dh * df, 16);
  const int raw_end = L.rwo + round_up(dcat * dout, 16);
  L.s = o;
  L.f = L.s + 4 * n * ds;
  const int sf_end = round_up(L.f + 4 * n * df, 16);
  o = raw_end > sf_end ? raw_end : sf_end;
  L.xs = o;  o += 4 * round_up(bm * dh, 4);
  L.msk = o; o += 4 * round_up(n, 4);
  L.bs = o;  o += 4 * ds;
  L.bf = o;  o += 4 * df;
  L.bo = o;  o += 4 * dout;
  L.wss = o; o += 4 * ds;
  L.wfs = o; o += 4 * df;
  L.wos = o; o += 4 * dout;
  L.total = o;
  return L;
}

__device__ inline void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src) : "memory");
}

__device__ inline void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src) : "memory");
}

// nbytes of src to dst (16-byte aligned): cp.async 16-byte copies where
// src is aligned, the tail (or an unaligned src) byte by byte.
__device__ inline void stage_bytes(int8_t* dst, const int8_t* src,
                                   int nbytes) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int nv = nbytes >> 4;
    for (int e = threadIdx.x; e < nv; e += kThreads)
      cp_async16(dst + 16 * e, src + 16 * e);
    done = nv << 4;
  }
  for (int e = done + threadIdx.x; e < nbytes; e += kThreads) dst[e] = src[e];
}

__device__ inline void stage_f32(float* dst, const float* src, int n) {
  for (int e = threadIdx.x; e < n; e += kThreads) cp_async4(dst + e, src + e);
}

// The transposed, depth-padded copy of a row-major (K, N) int8 matrix:
// row c of wt (stride ld) holds column c, zeros from K up to kpad.
__device__ inline void transpose(int8_t* wt, int ld, const int8_t* w, int K,
                                 int N, int kpad) {
  const int words = kpad / 4;
  for (int e = threadIdx.x; e < N * words; e += kThreads) {
    const int kw = e / N, c = e - kw * N, k = 4 * kw;   // lanes on columns
    uint32_t v = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (k + i < K) v |= (uint32_t)(uint8_t)w[(k + i) * N + c] << (8 * i);
    *reinterpret_cast<uint32_t*>(wt + c * ld + k) = v;
  }
}

// 1.0 / (double)s of the launch's divisors (int8_quant.cuh), rounded on
// the host
struct Recips {
  double x, h, agg, k, out;
};

// One warp's row of hq: h = concat(x_i, agg_i snapped to the agg_scale
// grid), without x_i when cx = 0, quantized with h_scale; agg_i =
// [sum / k, max] from the cell.
// With kDivide the divisions are f32 divisions, else int8_quant.cuh's
// quotients; returns false where a quotient fell outside their range (the
// caller then writes the row again with kDivide).
template <bool kDivide>
__device__ inline bool write_h_row(int8_t* __restrict__ hrow,
                                   const float* __restrict__ xrow,
                                   const float (&sum)[kMaxDfPerLane],
                                   const float (&mx)[kMaxDfPerLane], int cx,
                                   int df, int k, float agg_scale,
                                   float h_scale, const Recips& rc) {
  bool ok = true;
  auto div = [&](float v, float s, double rd) {
    if (kDivide) return v / s;
    const float q = quotient(v, rd);
    ok = ok && quotient_exact(v, q);
    return q;
  };
  auto snap = [&](float a) {
    return fminf(fmaxf(rintf(div(a, agg_scale, rc.agg)), -127.0f), 127.0f) *
           agg_scale;
  };
  const int lane = threadIdx.x & 31;
  for (int q = lane; q < cx; q += 32)
    hrow[q] = round_clip_s8(div(xrow[q], h_scale, rc.h));
#pragma unroll
  for (int u = 0; u < kMaxDfPerLane; ++u) {
    const int c = lane + 32 * u;
    if (c < df) {
      const float mean = div(sum[u], (float)k, rc.k);
      hrow[cx + c] = round_clip_s8(div(snap(mean), h_scale, rc.h));
      hrow[cx + df + c] = round_clip_s8(div(snap(mx[u]), h_scale, rc.h));
    }
  }
  return ok;
}

// CPL: candidates per lane (n <= 32 CPL). T: x's type, float or bf16.
template <int CPL, typename T>
__global__ void __launch_bounds__(kThreads)
gravnet_block_int8_kernel(
    const T* __restrict__ x, const float* __restrict__ mask,
    const int8_t* __restrict__ ws, const float* __restrict__ bs,
    const int8_t* __restrict__ wf, const float* __restrict__ bf,
    const int8_t* __restrict__ wo, const float* __restrict__ bo,
    const float* __restrict__ ws_scale, const float* __restrict__ wf_scale,
    const float* __restrict__ wo_scale, void* __restrict__ y, int n,
    int dh, int ds, int df, int dout, int k, float scale, float x_scale,
    float agg_scale, float h_scale, float out_scale, int act, int cx,
    int out_int8, int bm, Recips rc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int dcat = cx + 2 * df;
  const Layout L = layout(n, dh, ds, df, dout, bm, cx);
  int8_t* const xq = reinterpret_cast<int8_t*>(smem + L.xq);
  int8_t* const hq = reinterpret_cast<int8_t*>(smem + L.hq);
  int8_t* const WsfT = reinterpret_cast<int8_t*>(smem + L.wsft);
  int8_t* const WoT = reinterpret_cast<int8_t*>(smem + L.wot);
  int8_t* const Ws = reinterpret_cast<int8_t*>(smem + L.rws);
  int8_t* const Wf = reinterpret_cast<int8_t*>(smem + L.rwf);
  int8_t* const Wo = reinterpret_cast<int8_t*>(smem + L.rwo);
  float* const S = reinterpret_cast<float*>(smem + L.s);
  float* const F = reinterpret_cast<float*>(smem + L.f);
  float* const xs = reinterpret_cast<float*>(smem + L.xs);
  float* const msk = reinterpret_cast<float*>(smem + L.msk);
  float* const Bs = reinterpret_cast<float*>(smem + L.bs);
  float* const Bf = reinterpret_cast<float*>(smem + L.bf);
  float* const Bo = reinterpret_cast<float*>(smem + L.bo);
  float* const Wss = reinterpret_cast<float*>(smem + L.wss);
  float* const Wfs = reinterpret_cast<float*>(smem + L.wfs);
  float* const Wos = reinterpret_cast<float*>(smem + L.wos);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int event = blockIdx.y;
  const int row0 = blockIdx.x * bm;
  const int rows = min(bm, n - row0);
  const T* xe = x + (size_t)event * n * dh;

  // 1. staging, one round trip: the weights, mask, biases and scales into
  // shared memory by cp.async, x into registers (vectors of 4 values:
  // 16 bytes of f32, 8 of bf16, widened)
  const bool xvec = dh % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0;
  const int nxv = xvec ? n * dh / 4 : 0;
  float4 xr[kXV];
  auto load_x = [&](int base) {
#pragma unroll
    for (int u = 0; u < kXV; ++u) {
      const int e = base + u * kThreads + tid;
      if (e < nxv) xr[u] = repro_torch::io::load4(xe, e);
    }
  };
  // quantizes the batch loaded at `base`, by f32 divisions when `divide`
  // is std::true_type; returns false where a quotient of int8_quant.cuh
  // fell outside its range (the caller then quantizes again, dividing)
  auto quant_x = [&](int base, auto divide) {
    constexpr bool kDivide = decltype(divide)::value;
    bool ok = true;
#pragma unroll
    for (int u = 0; u < kXV; ++u) {
      const int e = base + u * kThreads + tid;
      if (e < nxv) {
        const int row = 4 * e / dh, col = 4 * e - row * dh;
        const float v[4] = {xr[u].x, xr[u].y, xr[u].z, xr[u].w};
        uint32_t p = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float q;
          if (kDivide) {
            q = v[i] / x_scale;
          } else {
            q = quotient(v[i], rc.x);
            ok = ok && quotient_exact(v[i], q);
          }
          p |= (uint32_t)(uint8_t)round_clip_s8(q) << (8 * i);
        }
        *reinterpret_cast<uint32_t*>(xq + row * L.ldx + col) = p;
        const int r = row - row0;
        if (r >= 0 && r < rows)
          *reinterpret_cast<float4*>(xs + r * dh + col) = xr[u];
      }
    }
    return ok;
  };
  stage_bytes(Ws, ws, dh * ds);
  stage_bytes(Wf, wf, dh * df);
  stage_bytes(Wo, wo, dcat * dout);
  stage_f32(msk, mask + (size_t)event * n, n);
  stage_f32(Bs, bs, ds);
  stage_f32(Wss, ws_scale, ds);
  stage_f32(Bf, bf, df);
  stage_f32(Wfs, wf_scale, df);
  stage_f32(Bo, bo, dout);
  stage_f32(Wos, wo_scale, dout);
  load_x(0);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // 2. x quantized into xq, and the weights transposed with their depth
  // zero-padded: S's columns in rows 0 .. ds of WsfT, F's from row
  // 8 * ceil(ds / 8), Wo's in WoT. xq's rows n .. 16-padded and columns
  // dh .. 32-padded stay unwritten: they meet the zero depth, and those
  // rows' outputs are never stored.
  for (int base = 0; base < nxv; base += kXV * kThreads) {
    if (base > 0) load_x(base);
    if (!quant_x(base, std::false_type{})) quant_x(base, std::true_type{});
  }
  if (!xvec) {
    for (int e = tid; e < n * dh; e += kThreads) {
      const int row = e / dh, col = e - row * dh;
      const float v = repro_torch::io::widen(xe[e]);
      xq[row * L.ldx + col] = round_clip_s8(v / x_scale);
      const int r = row - row0;
      if (r >= 0 && r < rows) xs[r * dh + col] = v;
    }
  }
  const int nts = (ds + 7) / 8, ntf = (df + 7) / 8;
  const int kx = round_up(dh, 32), kh = round_up(dcat, 32);
  transpose(WsfT, L.ldx, Ws, dh, ds, kx);
  transpose(WsfT + 8 * nts * L.ldx, L.ldx, Wf, dh, df, kx);
  transpose(WoT, L.ldh, Wo, dcat, dout, kh);
  __syncthreads();

  // 3. S and F of every row of the event, on the int8 tensor cores: the
  // (16-row, 8-column) tiles of S, then of F, spread over the warps (S and
  // F overwrite the raw weights, read in 2)
  for (int u = warp; u < (n + 15) / 16 * (nts + ntf); u += kWarps) {
    const int nt = u % (nts + ntf), mt = u / (nts + ntf);
    int acc[4] = {0, 0, 0, 0};
    for (int k0 = 0; k0 < kx; k0 += 32) {
      uint32_t a[4], b[2];
      mma_load_a(a, xq, L.ldx, 16 * mt, k0);
      mma_load_b(b, WsfT, L.ldx, 8 * nt, k0);
      mma_s8_16x8x32(acc, a, b);
    }
    const bool is_s = nt < nts;
    const int c0 = 8 * (is_s ? nt : nt - nts);
    const int ld = is_s ? ds : df;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * mt + g + 8 * h;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int c = c0 + 2 * t + jj;
        if (r >= n || c >= ld) continue;
        const float v = (float)acc[2 * h + jj];
        if (is_s) S[r * ds + c] = v * (x_scale * Wss[c]) + Bs[c];
        else F[r * df + c] = v * (x_scale * Wfs[c]) + Bf[c];
      }
    }
  }
  __syncthreads();

  // 4. one warp per query row: the cell, then the row's h = concat(x_i,
  // agg_i snapped to its int8 grid) (agg_i alone when cx = 0), quantized
  // into hq
  for (int r = warp; r < rows; r += kWarps) {
    float sum[kMaxDfPerLane], mx[kMaxDfPerLane];
    repro_torch::regcell::cell_row<CPL>(row0 + r, n, ds, df, k, scale, S,
                                        F, msk, sum, mx);
    int8_t* hrow = hq + r * L.ldh;
    const float* xrow = xs + r * dh;
    if (!write_h_row<false>(hrow, xrow, sum, mx, cx, df, k, agg_scale,
                            h_scale, rc))
      write_h_row<true>(hrow, xrow, sum, mx, cx, df, k, agg_scale, h_scale,
                        rc);
  }
  // hq's rows past `rows` and columns dcat .. 32-padded stay unwritten,
  // as xq's do
  __syncthreads();

  // 5. y = act((hq_i @ Wo_q) * (h_scale * wo_scale[c]) + bo) on the int8
  // tensor cores: the CTA's rows by 8 output columns per warp; with
  // out_int8, y / out_scale rounded to int8 (the division itself where
  // int8_quant.cuh's quotient is out of its range)
  for (int nt = warp; nt < (dout + 7) / 8; nt += kWarps) {
    int acc[4] = {0, 0, 0, 0};
    for (int k0 = 0; k0 < kh; k0 += 32) {
      uint32_t a[4], b[2];
      mma_load_a(a, hq, L.ldh, 0, k0);
      mma_load_b(b, WoT, L.ldh, 8 * nt, k0);
      mma_s8_16x8x32(acc, a, b);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = g + 8 * h;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int c = 8 * nt + 2 * t + jj;
        if (r >= rows || c >= dout) continue;
        const float v = repro_torch::activate(
            (float)acc[2 * h + jj] * (h_scale * Wos[c]) + Bo[c], act);
        const size_t o = ((size_t)event * n + row0 + r) * dout + c;
        if (out_int8) {
          float q = quotient(v, rc.out);
          if (!quotient_exact(v, q)) q = v / out_scale;
          static_cast<int8_t*>(y)[o] = round_clip_s8(q);
        } else {
          static_cast<float*>(y)[o] = v;
        }
      }
    }
  }
}

template <int CPL, typename T>
int launch(const T* x, const float* mask, const int8_t* ws,
           const float* bs, const int8_t* wf, const float* bf,
           const int8_t* wo, const float* bo, const float* ws_scale,
           const float* wf_scale, const float* wo_scale, void* y, int B,
           int n, int dh, int ds, int df, int dout, int k, float scale,
           float x_scale, float agg_scale, float h_scale, float out_scale,
           int act, int cx, int out_int8, int bm, long long smem,
           cudaStream_t stream) {
  auto kernel = gravnet_block_int8_kernel<CPL, T>;
  // The opt-in above 48 KB holds per device, so it is set on every such
  // launch (a cheap call) rather than cached for the process.
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const Recips rc = {1.0 / (double)x_scale, 1.0 / (double)h_scale,
                     1.0 / (double)agg_scale, 1.0 / (double)(float)k,
                     1.0 / (double)out_scale};
  dim3 grid((n + bm - 1) / bm, B);
  kernel<<<grid, kThreads, (size_t)smem, stream>>>(
      x, mask, ws, bs, wf, bf, wo, bo, ws_scale, wf_scale, wo_scale, y, n,
      dh, ds, df, dout, k, scale, x_scale, agg_scale, h_scale, out_scale,
      act, cx, out_int8, bm, rc);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory one CTA needs at these shapes.
extern "C" long long gravnet_block_int8_smem_bytes(int n, int dh, int ds,
                                                   int df, int dout, int bm,
                                                   int concat_x) {
  return (long long)layout(n, dh, ds, df, dout, bm, concat_x ? dh : 0).total;
}

namespace {

template <typename T>
int launch_x(const T* x, const float* mask, const int8_t* ws,
             const float* bs, const int8_t* wf, const float* bf,
             const int8_t* wo, const float* bo, const float* ws_scale,
             const float* wf_scale, const float* wo_scale, void* y, int B,
             int n, int dh, int ds, int df, int dout, int k, float scale,
             float x_scale, float agg_scale, float h_scale, int act,
             int concat_x, int out_int8, float out_scale, int bm,
             cudaStream_t st) {
  const long long smem = gravnet_block_int8_smem_bytes(n, dh, ds, df, dout,
                                                       bm, concat_x);
  const int cx = concat_x ? dh : 0;
#define REPRO_LAUNCH(CPL)                                                  \
  return launch<CPL>(x, mask, ws, bs, wf, bf, wo, bo, ws_scale, wf_scale,  \
                     wo_scale, y, B, n, dh, ds, df, dout, k, scale,        \
                     x_scale, agg_scale, h_scale, out_scale, act, cx,      \
                     out_int8, bm, smem, st)
  if (n <= 32) REPRO_LAUNCH(1);
  if (n <= 64) REPRO_LAUNCH(2);
  if (n <= 128) REPRO_LAUNCH(4);
  if (n <= 256) REPRO_LAUNCH(8);
  REPRO_LAUNCH(16);
#undef REPRO_LAUNCH
}

}  // namespace

// x:(B,n,dh) of the dtype x_dtype (dtype_io.cuh: 0 = f32, 1 = bf16),
// mask:(B,n) f32, ws:(dh,ds) wf:(dh,df) int8, wo int8 (dh+2df,dout), or
// (2df,dout) when concat_x = 0, bs/bf/bo and the *_scale vectors f32 of
// their output widths -> y:(B,n,dout), f32, or int8 requantized with
// out_scale when out_int8 = 1; all contiguous. act: 0 = none, 1 = relu,
// 2 = gelu, 3 = silu. bm query rows per CTA, 1 <= bm <= 16; n <= 512 and
// df <= 128 (the cell's registers), else cudaErrorInvalidValue.
extern "C" int gravnet_block_int8_ex(
    const void* x, const float* mask, const int8_t* ws, const float* bs,
    const int8_t* wf, const float* bf, const int8_t* wo, const float* bo,
    const float* ws_scale, const float* wf_scale, const float* wo_scale,
    void* y, int B, int n, int dh, int ds, int df, int dout, int k,
    float scale, float x_scale, float agg_scale, float h_scale, int act,
    int concat_x, int out_int8, float out_scale, int bm, int x_dtype,
    void* stream) {
  if (bm < 1 || bm > kMaxRows || n > kMaxHits || df > 32 * kMaxDfPerLane)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || n <= 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
#define REPRO_X(T)                                                          \
  return launch_x(static_cast<const T*>(x), mask, ws, bs, wf, bf, wo, bo,  \
                  ws_scale, wf_scale, wo_scale, y, B, n, dh, ds, df, dout, \
                  k, scale, x_scale, agg_scale, h_scale, act, concat_x,    \
                  out_int8, out_scale, bm, st)
  if (x_dtype == repro_torch::io::kF32) REPRO_X(float);
  if (x_dtype == repro_torch::io::kBF16) REPRO_X(repro_torch::io::bf16);
#undef REPRO_X
  return (int)cudaErrorInvalidValue;
}

// The entry of the sources before the concat_x and out_int8 options: the
// block over concat(x, agg) with an f32 output, as kernels/phase_split.py
// calls it.
extern "C" int gravnet_block_int8(
    const float* x, const float* mask, const int8_t* ws, const float* bs,
    const int8_t* wf, const float* bf, const int8_t* wo, const float* bo,
    const float* ws_scale, const float* wf_scale, const float* wo_scale,
    float* y, int B, int n, int dh, int ds, int df, int dout, int k,
    float scale, float x_scale, float agg_scale, float h_scale, int act,
    int bm, void* stream) {
  return gravnet_block_int8_ex(x, mask, ws, bs, wf, bf, wo, bo, ws_scale,
                               wf_scale, wo_scale, y, B, n, dh, ds, df, dout,
                               k, scale, x_scale, agg_scale, h_scale, act, 1,
                               0, 1.0f, bm, repro_torch::io::kF32, stream);
}
