// flash_attention: blockwise (streaming-softmax) attention for Hopper
// (sm_90a), f32 or bf16 in and out, f32 inside.
//
// Replaces: repro/kernels/flash_attention.py — flash_attention_pallas
// (_flash_kernel). It runs every `attention` op of a deployed graph
// (core/pipeline.py:_Executor._attention, through kernels/ops.py).
//
//   o[b,r] = sum_c softmax_c(q[b,r].k[b,c] / sqrt(D), causal: c <= r) v[b,c]
//
// with the TPU kernel's conventions: the running max m starts at -1e30, a
// causally masked score is -1e30 (not -inf), o = acc / max(l, 1e-30). The
// blocks change only the rounding: a causal row sees the keys c <= r of
// the (padded) K, whatever the tiles, so the kernel tiles as it likes and
// kernels/ops.py pads S and T to the caller's (bq, bk) as the reference's
// wrapper does. bf16 q/k/v are widened to f32 when a tile is loaded; the
// output is rounded to bf16 at the store.
//
// Bound on this card: operations. At the LM prefill cell (BH 8, S = T =
// 512, D 64, causal) a launch does about 4*BH*S*T*D/2 = 0.27 G f32
// operations (4.0 us at 67 TFLOP/s) and moves 4 MB (1.3 us at 3.35 TB/s);
// at OLMo-1B's heads (16, 4096, 4096, 128) 69 G operations, 1.03 ms. The
// tensor cores have no full-f32 product (TF32 keeps about three digits),
// so both products stay on the FMA pipes.
//
// Design: the two products are built as a SIMT GEMM is built:
//
//   - a CTA of 4*BQ threads owns BQ query rows (one bh), BQ in {32, 64,
//     128}; its Q rows are loaded once to shared memory;
//   - thread (rg, cg) = (tid / 16, tid % 16) owns rows 4rg..4rg+3, keys
//     cg + 16j of every kv tile of BK keys (BK in {32, 64, 128}) in the
//     score block, and columns 4cg + 64jj + e of the output, so the 16
//     lanes of a half warp share a row: the row max is a 4-step xor
//     shuffle among them, each lane keeps its own part of l (summed over
//     the 16 lanes once, at the end), and alpha rescales the register
//     accumulator where it lies;
//   - scores: for every 4 columns of D, a 16-byte shared load of each of
//     the 4 rows of q and of each key's k (K at row stride D + 4, so the 8
//     lanes of a load phase hit 8 different bank groups), then 16 FMAs per
//     key; p goes to shared memory 32 keys at a time (transposed, 16-byte
//     stores), and p.v reads a float4 of p (4 rows) and float4s of a V row
//     per key, 4 FMAs per loaded value pair;
//   - K and V tiles are double-buffered with cp.async (16-byte copies,
//     f32 with D % 4 == 0 and aligned rows), so the next tile loads while
//     this one is computed; other inputs (bf16, odd D) load synchronously,
//     widened to f32; a plan whose two stages do not fit 227 KB keeps one;
//   - enough CTAs: the grid runs the q tiles longest first (under causal
//     the last tile walks the most keys), and where BH x S/BQ CTAs cannot
//     fill the card the wrapper splits the kv tiles over `nsplit` CTAs per
//     q tile; each writes its unnormalised (m, l, acc) to a workspace and
//     flash_attention_combine merges them: o = sum_s acc_s e^(m_s - m) /
//     max(sum_s l_s e^(m_s - m), 1e-30), m = max_s m_s.
//
// Built without -fmad=false: every product-and-sum is one FMA, so the
// kernel is no longer bitwise equal to kernels/ref.py's
// flash_attention_blocked_ref; it is held to the float32 row of
// tests/_numerics.py against it (bf16: the bfloat16 row).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kMaskFill = -1e30f;   // the TPU kernel's masked score
constexpr float kMinDenom = 1e-30f;   // its floor on l
constexpr int kTM = 4;                // rows per thread
constexpr int kCG = 16;               // lanes that share a row
constexpr int kPK = 32;               // keys of p staged per pass
constexpr int kMaxD = 128;
constexpr int kMaxSplit = 16;
constexpr long long kSmemLimit = 232448;

// The kernel's tile for a requested block: the smallest of 32, 64, 128
// that holds it, else 128; the head width rounds up to 64 or 128.
__host__ __device__ inline int plan_block(int b) {
  return b <= 32 ? 32 : (b <= 64 ? 64 : 128);
}
__host__ __device__ inline int plan_width(int d) { return d <= 64 ? 64 : 128; }

// Floats of shared memory: Q (BQ x (DP + 4)), `stages` K tiles
// (BK x (DP + 4)) and V tiles (BK x DP), p (kPK x (BQ + 4)).
__host__ __device__ constexpr long long plan_floats(int bq, int bk, int dp,
                                                    int stages) {
  return (long long)bq * (dp + 4) + (long long)stages * bk * (dp + 4) +
         (long long)stages * bk * dp + (long long)kPK * (bq + 4);
}

__host__ __device__ constexpr int plan_stages(int bq, int bk, int dp) {
  return plan_floats(bq, bk, dp, 2) * 4 <= kSmemLimit ? 2 : 1;
}

// CTAs of a plan that one SM holds by shared memory (228 KB, 1 KB more
// per CTA), capped at 2: the register budget __launch_bounds__ asks for.
__host__ __device__ constexpr int plan_min_blocks(int bq, int bk, int dp) {
  return bq * 4 <= 256 &&
                 2 * (plan_floats(bq, bk, dp, plan_stages(bq, bk, dp)) * 4 +
                      1024) <= 233472
             ? 2
             : 1;
}

template <typename T>
__device__ inline float widen(T x);
template <>
__device__ inline float widen<float>(float x) { return x; }
template <>
__device__ inline float widen<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ inline T narrow(float x);
template <>
__device__ inline float narrow<float>(float x) { return x; }
template <>
__device__ inline __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as torch's cast
}

__device__ inline void cp_async16(float* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + nrows) of src (L rows of d values) into dst at row
// stride ld. `vec`: T is f32, d % 4 == 0 and the rows are 16-byte
// aligned, so each 4 values are one cp.async (the caller commits);
// rows past L are zeros. Else every value of columns [0, dp) is loaded
// and widened here, zeros past d and past L.
template <typename T, int NT>
__device__ inline void load_tile(float* dst, int ld, const T* src, int r0,
                                 int nrows, int L, int d, int dp,
                                 bool vec) {
  if constexpr (sizeof(T) == 4) {
    if (vec) {
      const int c4 = d >> 2;
      for (int i = threadIdx.x; i < nrows * c4; i += NT) {
        const int r = i / c4;
        const int c = (i - r * c4) * 4;
        float* p = dst + r * ld + c;
        if (r0 + r < L)
          cp_async16(p, src + (size_t)(r0 + r) * d + c);
        else
          *reinterpret_cast<float4*>(p) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      return;
    }
  }
  for (int i = threadIdx.x; i < nrows * dp; i += NT) {
    const int r = i / dp;
    const int c = i - r * dp;
    dst[r * ld + c] =
        (r0 + r < L && c < d) ? widen<T>(src[(size_t)(r0 + r) * d + c]) : 0.f;
  }
}

// The kv tiles [t_begin, t_end) of one q tile of one bh, for a grid of
// BH * nsplit * ceil(S / BQ) CTAs, the longest q tiles first.
template <typename T, int BQ, int BK, int DP>
__global__ void __launch_bounds__(BQ * 4, plan_min_blocks(BQ, BK, DP))
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                       int bh_n, int s_len, int t_len, int d, int causal,
                       float scale, int chunk, int nsplit, int stages,
                       int vec) {
  constexpr int NT = BQ * 4;
  constexpr int TN = BK / kCG;   // keys per thread
  constexpr int TC = DP / kCG;   // output columns per thread
  constexpr int QLD = DP + 4;
  constexpr int KLD = DP + 4;
  constexpr int VLD = DP;
  constexpr int PLD = BQ + 4;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + BQ * QLD;
  float* vs = ks + stages * BK * KLD;
  float* ps = vs + stages * BK * VLD;

  const int nqt = (s_len + BQ - 1) / BQ;
  int lin = blockIdx.x;
  const int bh = lin % bh_n;
  lin /= bh_n;
  const int sp = lin % nsplit;
  const int qt = nqt - 1 - lin / nsplit;
  const int q0 = qt * BQ;
  const int last_row = min(q0 + BQ, s_len) - 1;
  const int kv_end = causal ? min(t_len, last_row + 1) : t_len;
  const int nkt = (kv_end + BK - 1) / BK;
  const int t_begin = sp * chunk;
  const int t_end = min(nkt, t_begin + chunk);
  if (t_begin >= t_end) return;   // this split has no tile of the row

  const int tid = threadIdx.x;
  const int cg = tid % kCG;
  const int rg = tid / kCG;
  const T* qb = q + (size_t)bh * s_len * d;
  const T* kb = k + (size_t)bh * t_len * d;
  const T* vb = v + (size_t)bh * t_len * d;
  const bool vc = vec != 0;

  load_tile<T, NT>(qs, QLD, qb, q0, BQ, s_len, d, DP, vc);
  load_tile<T, NT>(ks, KLD, kb, t_begin * BK, BK, t_len, d, DP, vc);
  load_tile<T, NT>(vs, VLD, vb, t_begin * BK, BK, t_len, d, DP, vc);
  cp_async_commit();

  float acc[kTM][TC];
  float m[kTM], l[kTM];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    m[i] = kMaskFill;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < TC; ++c) acc[i][c] = 0.f;
  }
  const int dk = (d + 3) & ~3;

  for (int t = t_begin; t < t_end; ++t) {
    const int buf = stages == 2 ? ((t - t_begin) & 1) : 0;
    const bool more = t + 1 < t_end;
    if (stages == 2 && more) {
      const int nb = buf ^ 1;
      load_tile<T, NT>(ks + nb * BK * KLD, KLD, kb, (t + 1) * BK, BK, t_len,
                       d, DP, vc);
      load_tile<T, NT>(vs + nb * BK * VLD, VLD, vb, (t + 1) * BK, BK, t_len,
                       d, DP, vc);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* kt = ks + buf * BK * KLD;
    const float* vt = vs + buf * BK * VLD;

    // scores of rows 4rg + i, keys cg + 16j
    float s[kTM][TN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d0 = 0; d0 < dk; d0 += 4) {
      float4 qv[kTM];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (rg * kTM + i) * QLD +
                                                 d0);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float4 kv =
            *reinterpret_cast<const float4*>(kt + (cg + kCG * j) * KLD + d0);
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);
        }
      }
    }

    // scale, masks, the online softmax
    const int col0 = t * BK;
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int r = q0 + rg * kTM + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = col0 + cg + kCG * j;
        float x = s[i][j] * scale;
        if (c >= t_len)
          x = -INFINITY;               // past the keys: weighs nothing
        else if (causal && c > r)
          x = kMaskFill;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = kCG / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      m[i] = m_new;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        s[i][j] = expf(s[i][j] - m_new);   // s now holds p
        psum += s[i][j];
      }
      l[i] = l[i] * alpha + psum;
#pragma unroll
      for (int c = 0; c < TC; ++c) acc[i][c] *= alpha;
    }

    // p . v, kPK keys per pass through shared memory
#pragma unroll
    for (int c0 = 0; c0 < BK; c0 += kPK) {
#pragma unroll
      for (int jj = 0; jj < kPK / kCG; ++jj) {
        const int j = c0 / kCG + jj;
        *reinterpret_cast<float4*>(ps + (cg + kCG * jj) * PLD + rg * kTM) =
            make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      }
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < kPK; ++c) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(ps + c * PLD + rg * kTM);
        const float* vrow = vt + (c0 + c) * VLD + 4 * cg;
#pragma unroll
        for (int jj = 0; jj < TC / 4; ++jj) {
          const float4 v4 = *reinterpret_cast<const float4*>(vrow + 64 * jj);
          const float pr[kTM] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int i = 0; i < kTM; ++i) {
            acc[i][4 * jj + 0] = fmaf(pr[i], v4.x, acc[i][4 * jj + 0]);
            acc[i][4 * jj + 1] = fmaf(pr[i], v4.y, acc[i][4 * jj + 1]);
            acc[i][4 * jj + 2] = fmaf(pr[i], v4.z, acc[i][4 * jj + 2]);
            acc[i][4 * jj + 3] = fmaf(pr[i], v4.w, acc[i][4 * jj + 3]);
          }
        }
      }
      __syncthreads();   // p and this tile's buffers are free again
    }
    if (stages == 1 && more) {
      load_tile<T, NT>(ks, KLD, kb, (t + 1) * BK, BK, t_len, d, DP, vc);
      load_tile<T, NT>(vs, VLD, vb, (t + 1) * BK, BK, t_len, d, DP, vc);
      cp_async_commit();
    }
  }

  // the row sums over the 16 lanes, then the output or the partials
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int off = kCG / 2; off > 0; off >>= 1)
      l[i] += __shfl_xor_sync(kFull, l[i], off);
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = q0 + rg * kTM + i;
    if (r >= s_len) continue;
    if (nsplit == 1) {
      const float den = fmaxf(l[i], kMinDenom);
      T* orow = o + ((size_t)bh * s_len + r) * d;
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        const int col = 64 * (c / 4) + 4 * cg + (c % 4);
        if (col < d) orow[col] = narrow<T>(acc[i][c] / den);
      }
    } else {
      const size_t row = ((size_t)sp * bh_n + bh) * s_len + r;
      float* arow = ws_acc + row * d;
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        const int col = 64 * (c / 4) + 4 * cg + (c % 4);
        if (col < d) arow[col] = acc[i][c];
      }
      if (cg == 0) {
        ws_ml[row * 2] = m[i];
        ws_ml[row * 2 + 1] = l[i];
      }
    }
  }
}

// Merges the nsplit partials of each (bh, row): one warp per row.
template <typename T>
__global__ void __launch_bounds__(256)
flash_attention_combine(const float* __restrict__ ws_acc,
                        const float* __restrict__ ws_ml, T* __restrict__ o,
                        int bh_n, int s_len, int t_len, int d, int bq,
                        int bk, int causal, int chunk, int nsplit) {
  const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (w >= (long long)bh_n * s_len) return;
  const int bh = (int)(w / s_len);
  const int r = (int)(w - (long long)bh * s_len);
  const int q0 = (r / bq) * bq;
  const int last_row = min(q0 + bq, s_len) - 1;
  const int kv_end = causal ? min(t_len, last_row + 1) : t_len;
  const int nkt = (kv_end + bk - 1) / bk;
  const int ns = min(nsplit, (nkt + chunk - 1) / chunk);
  float mt = -INFINITY;
  for (int sp = 0; sp < ns; ++sp)
    mt = fmaxf(mt, ws_ml[(((size_t)sp * bh_n + bh) * s_len + r) * 2]);
  float wgt[kMaxSplit];
  float den = 0.f;
#pragma unroll
  for (int sp = 0; sp < kMaxSplit; ++sp) {
    wgt[sp] = 0.f;
    if (sp < ns) {
      const size_t row = ((size_t)sp * bh_n + bh) * s_len + r;
      wgt[sp] = expf(ws_ml[row * 2] - mt);
      den += ws_ml[row * 2 + 1] * wgt[sp];
    }
  }
  den = fmaxf(den, kMinDenom);
  T* orow = o + ((size_t)bh * s_len + r) * d;
  for (int c = lane; c < d; c += 32) {
    float a = 0.f;
#pragma unroll
    for (int sp = 0; sp < kMaxSplit; ++sp)
      if (sp < ns)
        a += ws_acc[(((size_t)sp * bh_n + bh) * s_len + r) * d + c] * wgt[sp];
    orow[c] = narrow<T>(a / den);
  }
}

template <typename T, int BQ, int BK, int DP>
int launch_plan(const T* q, const T* k, const T* v, T* o, float* ws_acc,
                float* ws_ml, int bh_n, int s_len, int t_len, int d,
                int causal, float scale, int chunk, int nsplit, int vec,
                cudaStream_t stream) {
  const int stages = plan_stages(BQ, BK, DP);
  const long long smem = plan_floats(BQ, BK, DP, stages) * 4LL;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, BQ, BK, DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long nqt = (s_len + BQ - 1) / BQ;
  const long long ctas = nqt * nsplit * bh_n;
  if (ctas > 0) {
    flash_attention_kernel<T, BQ, BK, DP>
        <<<(unsigned)ctas, BQ * 4, (size_t)smem, stream>>>(
        q, k, v, o, ws_acc, ws_ml, bh_n, s_len, t_len, d, causal, scale,
        chunk, nsplit, stages, vec);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || nsplit == 1) return (int)err;
    const long long threads = (long long)bh_n * s_len * 32;
    flash_attention_combine<T><<<(unsigned)((threads + 255) / 256), 256, 0,
                                 stream>>>(ws_acc, ws_ml, o, bh_n, s_len,
                                           t_len, d, BQ, BK, causal, chunk,
                                           nsplit);
  }
  return (int)cudaGetLastError();
}

template <typename T, int BQ, int BK>
int launch_width(const T* q, const T* k, const T* v, T* o, float* ws_acc,
                 float* ws_ml, int bh_n, int s_len, int t_len, int d,
                 int causal, float scale, int chunk, int nsplit, int vec,
                 cudaStream_t st) {
  if (plan_width(d) == 64)
    return launch_plan<T, BQ, BK, 64>(q, k, v, o, ws_acc, ws_ml, bh_n, s_len,
                                      t_len, d, causal, scale, chunk, nsplit,
                                      vec, st);
  return launch_plan<T, BQ, BK, 128>(q, k, v, o, ws_acc, ws_ml, bh_n, s_len,
                                     t_len, d, causal, scale, chunk, nsplit,
                                     vec, st);
}

template <typename T, int BQ>
int launch_bk(int bk, const T* q, const T* k, const T* v, T* o,
              float* ws_acc, float* ws_ml, int bh_n, int s_len, int t_len,
              int d, int causal, float scale, int chunk, int nsplit, int vec,
              cudaStream_t st) {
  switch (plan_block(bk)) {
    case 32:
      return launch_width<T, BQ, 32>(q, k, v, o, ws_acc, ws_ml, bh_n, s_len,
                                     t_len, d, causal, scale, chunk, nsplit,
                                     vec, st);
    case 64:
      return launch_width<T, BQ, 64>(q, k, v, o, ws_acc, ws_ml, bh_n, s_len,
                                     t_len, d, causal, scale, chunk, nsplit,
                                     vec, st);
    default:
      return launch_width<T, BQ, 128>(q, k, v, o, ws_acc, ws_ml, bh_n, s_len,
                                      t_len, d, causal, scale, chunk, nsplit,
                                      vec, st);
  }
}

template <typename T>
int launch(const T* q, const T* k, const T* v, T* o, float* ws_acc,
           float* ws_ml, int bh_n, int s_len, int t_len, int d, int bq,
           int bk, int causal, float scale, int chunk, int nsplit,
           void* stream) {
  if (bq < 1 || bk < 1 || d < 1 || d > kMaxD || t_len < 1 || s_len < 0 || bh_n < 0 || chunk < 1 ||
      nsplit < 1 || nsplit > kMaxSplit ||
      (nsplit > 1 && (ws_acc == nullptr || ws_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  const uintptr_t addr = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v;
  const int vec = sizeof(T) == 4 && d % 4 == 0 && addr % 16 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (plan_block(bq)) {
    case 32:
      return launch_bk<T, 32>(bk, q, k, v, o, ws_acc, ws_ml, bh_n, s_len,
                              t_len, d, causal, scale, chunk, nsplit, vec, st);
    case 64:
      return launch_bk<T, 64>(bk, q, k, v, o, ws_acc, ws_ml, bh_n, s_len,
                              t_len, d, causal, scale, chunk, nsplit, vec, st);
    default:
      return launch_bk<T, 128>(bk, q, k, v, o, ws_acc, ws_ml, bh_n, s_len,
                               t_len, d, causal, scale, chunk, nsplit, vec,
                               st);
  }
}

}  // namespace

// Bytes of dynamic shared memory one CTA needs for the plan that serves
// (bq, bk, d): Q, one or two stages of K and V, and p, all f32.
extern "C" long long flash_attention_smem_bytes(int bq, int bk, int d) {
  const int pq = plan_block(bq), pk = plan_block(bk), dp = plan_width(d);
  return plan_floats(pq, pk, dp, plan_stages(pq, pk, dp)) * 4LL;
}

// q:(BH,S,D), k/v:(BH,T,D), o:(BH,S,D), contiguous, all f32
// (flash_attention_f32) or all bf16 (flash_attention_bf16); bq, bk >= 1
// pick the tiles (plan_block), 1 <= D <= 128, T >= 1. With nsplit > 1 the kv tiles of a q
// tile are cut into runs of `chunk` tiles, one CTA each, and ws_acc
// (nsplit*BH*S*D f32) and ws_ml (nsplit*BH*S*2 f32) hold the partials
// until the combine pass. Returns cudaErrorInvalidValue for arguments
// outside that, else cudaGetLastError().
extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, float* o, float* ws_acc,
                                   float* ws_ml, int bh_n, int s_len,
                                   int t_len, int d, int bq, int bk,
                                   int causal, float scale, int chunk,
                                   int nsplit, void* stream) {
  return launch<float>(q, k, v, o, ws_acc, ws_ml, bh_n, s_len, t_len, d, bq,
                       bk, causal, scale, chunk, nsplit, stream);
}

extern "C" int flash_attention_bf16(const __nv_bfloat16* q,
                                    const __nv_bfloat16* k,
                                    const __nv_bfloat16* v, __nv_bfloat16* o,
                                    float* ws_acc, float* ws_ml, int bh_n,
                                    int s_len, int t_len, int d, int bq,
                                    int bk, int causal, float scale,
                                    int chunk, int nsplit, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, ws_acc, ws_ml, bh_n, s_len, t_len,
                               d, bq, bk, causal, scale, chunk, nsplit,
                               stream);
}
