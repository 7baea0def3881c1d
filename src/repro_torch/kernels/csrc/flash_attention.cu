// flash_attention: blockwise (streaming-softmax) attention, f32, for
// Hopper (sm_90a).
//
// Replaces: repro/kernels/flash_attention.py — flash_attention_pallas
// (_flash_kernel). It runs every `attention` op of a deployed graph
// (core/pipeline.py:_Executor._attention, through kernels/ops.py).
//
//   o[b,r] = sum_c softmax_c(q[b,r].k[b,c] / sqrt(D), causal: c <= r) v[b,c]
//
// computed as the TPU kernel computes it: per block of bq query rows, the
// kv blocks of bk keys in increasing order, carrying the running max m
// (from -1e30), the running denominator l and the accumulator acc; a
// masked score is -1e30 (not -inf); under causal a kv block with
// ki*bk > qi*bq + bq - 1 is skipped; o = acc / max(l, 1e-30). S and T are
// padded to the blocks by kernels/ops.py, and the padded rows and keys
// take part exactly as they do on the TPU.
//
// Bound on this card: operations. At the LM prefill cell (BH 8, S = T =
// 512, D 64, causal) a launch does about 4*BH*S*T*D/2 = 0.27 G f32
// products and sums (4.0 us at 67 TFLOP/s) and moves 4 MB (1.3 us at
// 3.35 TB/s); at OLMo-1B's heads (16, 4096, 4096, 128) 69 G operations,
// 1.03 ms. This first version stays on the scalar f32 pipes (no tensor
// cores) and pays a shuffle and a shared-memory load per product, so it
// runs well above that bound.
//
// Design: the TPU's sequential kv grid axis, with (m, l, acc) in VMEM
// scratch between grid steps, becomes a loop inside one CTA, which owns
// one (bh, q block) and walks its kv blocks up to the diagonal. Each kv
// block's K and V tiles are staged in shared memory; acc (bq x D), m and
// l live in shared memory too, so no thread keeps a row of D floats in
// registers. 8 warps; warp w owns the rows w, w + 8, ... of the block.
// For one row and one kv block:
//   - scores, a key per lane: lane c computes q.k[c] over d = 0..D-1 in
//     order (q[d] broadcast from the lane that holds it, k read from a
//     tile of row stride D + 1, free of bank conflicts), then * scale and
//     the causal fill; keys c, c + 32, ... go to the same lane;
//   - the row max by a warp shuffle reduction (exact in any order);
//   - p = expf(s - m_new) on the key's lane, alpha = expf(m - m_new);
//   - the row sum of p: each lane sums its keys in increasing order from
//     0, then a butterfly over the lanes (xor 16, 8, 4, 2, 1), whose
//     every step gives both partners the same sum;
//   - p . v with D split over the lanes (column d on lane d % 32): each
//     key's p broadcast by a shuffle, summed over the keys in increasing
//     order from 0; then acc = acc * alpha + pv and l = l * alpha + sum.
// Every product and sum is rounded on its own (-fmad=false), so
// kernels/ref.py:flash_attention_blocked_ref, which replays this order,
// reproduces the kernel's bits wherever expf agrees with torch.exp.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxD = 128;
constexpr int kMaxKpl = 8;            // keys per lane: bk <= 256
constexpr unsigned kFull = 0xffffffffu;
constexpr float kMaskFill = -1e30f;   // the TPU kernel's masked score
constexpr float kMinDenom = 1e-30f;   // its floor on l

// Dynamic shared memory, in floats: K tile (bk x (D + 1)), V tile
// (bk x D), acc (bq x D), m and l (bq each).
__host__ __device__ inline long long smem_floats(int bq, int bk, int d) {
  return (long long)bk * (d + 1) + (long long)bk * d + (long long)bq * d +
         2LL * bq;
}

template <int KPL>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int s_len, int t_len, int d, int bq, int bk,
                       int causal, float scale) {
  extern __shared__ float smem[];
  float* ks = smem;                         // bk x (d + 1)
  float* vs = ks + bk * (d + 1);            // bk x d
  float* acc = vs + bk * d;                 // bq x d
  float* ms = acc + bq * d;                 // bq
  float* ls = ms + bq;                      // bq

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int qi = blockIdx.x;
  const int b = blockIdx.y;
  const int row0 = qi * bq;
  const float* qb = q + ((size_t)b * s_len + row0) * d;
  const float* kb = k + (size_t)b * t_len * d;
  const float* vb = v + (size_t)b * t_len * d;

  for (int i = tid; i < bq * d; i += kThreads) acc[i] = 0.0f;
  for (int r = tid; r < bq; r += kThreads) {
    ms[r] = kMaskFill;
    ls[r] = 0.0f;
  }

  const int nk = t_len / bk;
  const int nk_run = causal ? min(nk, (row0 + bq - 1) / bk + 1) : nk;
  for (int ki = 0; ki < nk_run; ++ki) {
    const int col0 = ki * bk;
    __syncthreads();   // the previous block's tiles are no longer read
    for (int i = tid; i < bk * d; i += kThreads) {
      const int c = i / d;
      const int dd = i - c * d;
      ks[c * (d + 1) + dd] = kb[(size_t)(col0 + c) * d + dd];
      vs[i] = vb[(size_t)col0 * d + i];
    }
    __syncthreads();

    for (int r = warp; r < bq; r += kWarps) {
      const int row = row0 + r;
      // this row of q, column d on lane d % 32
      float qreg[kMaxD / 32];
#pragma unroll
      for (int j = 0; j < kMaxD / 32; ++j) {
        const int dd = j * 32 + lane;
        qreg[j] = dd < d ? qb[(size_t)r * d + dd] : 0.0f;
      }
      // scores: key c = m * 32 + lane on this lane
      float s[KPL];
#pragma unroll
      for (int m = 0; m < KPL; ++m) s[m] = 0.0f;
#pragma unroll
      for (int j = 0; j < kMaxD / 32; ++j) {
        if (j * 32 >= d) break;
        const int dn = min(32, d - j * 32);
        for (int dl = 0; dl < dn; ++dl) {
          const float qd = __shfl_sync(kFull, qreg[j], dl);
          const int dd = j * 32 + dl;
#pragma unroll
          for (int m = 0; m < KPL; ++m) {
            const int c = m * 32 + lane;
            if (c < bk) s[m] = s[m] + qd * ks[c * (d + 1) + dd];
          }
        }
      }
      float mx = __int_as_float(0xff800000);   // -inf
#pragma unroll
      for (int m = 0; m < KPL; ++m) {
        const int c = m * 32 + lane;
        if (c < bk) {
          s[m] = s[m] * scale;
          if (causal && col0 + c > row) s[m] = kMaskFill;
          mx = fmaxf(mx, s[m]);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_prev = ms[r];
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int m = 0; m < KPL; ++m) {
        const int c = m * 32 + lane;
        if (c < bk) {
          s[m] = expf(s[m] - m_new);   // s now holds p
          psum = psum + s[m];
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum = psum + __shfl_xor_sync(kFull, psum, off);
      // p . v, column j * 32 + lane on this lane
      float pv[kMaxD / 32];
#pragma unroll
      for (int j = 0; j < kMaxD / 32; ++j) pv[j] = 0.0f;
#pragma unroll
      for (int m = 0; m < KPL; ++m) {
        const int cn = min(32, bk - m * 32);
        for (int cl = 0; cl < cn; ++cl) {
          const float pc = __shfl_sync(kFull, s[m], cl);
          const float* vrow = vs + (m * 32 + cl) * d;
#pragma unroll
          for (int j = 0; j < kMaxD / 32; ++j) {
            const int dd = j * 32 + lane;
            if (dd < d) pv[j] = pv[j] + pc * vrow[dd];
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kMaxD / 32; ++j) {
        const int dd = j * 32 + lane;
        if (dd < d) acc[r * d + dd] = acc[r * d + dd] * alpha + pv[j];
      }
      __syncwarp();
      if (lane == 0) {
        ms[r] = m_new;
        ls[r] = ls[r] * alpha + psum;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  float* ob = o + ((size_t)b * s_len + row0) * d;
  for (int i = tid; i < bq * d; i += kThreads)
    ob[i] = acc[i] / fmaxf(ls[i / d], kMinDenom);
}

template <int KPL>
int launch(const float* q, const float* k, const float* v, float* o, int BH,
           int s_len, int t_len, int d, int bq, int bk, int causal,
           float scale, cudaStream_t stream) {
  const long long smem = smem_floats(bq, bk, d) * 4LL;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<KPL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (BH > 0 && s_len > 0) {
    dim3 grid(s_len / bq, BH);
    flash_attention_kernel<KPL><<<grid, kThreads, (size_t)smem, stream>>>(
        q, k, v, o, s_len, t_len, d, bq, bk, causal, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory one CTA needs for (bq, bk, d).
extern "C" long long flash_attention_smem_bytes(int bq, int bk, int d) {
  return smem_floats(bq, bk, d) * 4LL;
}

// q:(BH,S,D), k/v:(BH,T,D), o:(BH,S,D), all f32 and contiguous;
// S % bq == 0, T % bk == 0, 1 <= bk <= 256, 1 <= D <= 128. Returns
// cudaErrorInvalidValue for shapes outside that, else cudaGetLastError().
extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, float* o, int BH,
                                   int s_len, int t_len, int d, int bq,
                                   int bk, int causal, float scale,
                                   void* stream) {
  if (bq < 1 || bk < 1 || bk > 32 * kMaxKpl || d < 1 || d > kMaxD ||
      s_len % bq != 0 || t_len % bk != 0 || t_len < 1)
    return (int)cudaErrorInvalidValue;
  const int kpl = (bk + 31) / 32;
  cudaStream_t st = (cudaStream_t)stream;
  switch (kpl) {
    case 1: return launch<1>(q, k, v, o, BH, s_len, t_len, d, bq, bk,
                             causal, scale, st);
    case 2: return launch<2>(q, k, v, o, BH, s_len, t_len, d, bq, bk,
                             causal, scale, st);
    case 3:
    case 4: return launch<4>(q, k, v, o, BH, s_len, t_len, d, bq, bk,
                             causal, scale, st);
    default: return launch<8>(q, k, v, o, BH, s_len, t_len, d, bq, bk,
                              causal, scale, st);
  }
}
