// edge_aggregate: masked segment sum / mean of per-edge messages into
// their destination nodes, f32, for Hopper (sm_90a).
//
// Replaces: repro/kernels/edge_aggregate.py — edge_aggregate_batched_pallas
// and edge_aggregate_pallas (the latter is this kernel at B = 1). It runs
// in every message-passing layer of the GatedGCN and GraphSAGE routes.
//
//   out[b,i] = sum over e with dst[b,e] = i of mask[b,e] * msg[b,e]
//   (mean: divided by max(sum over the same e of mask[b,e], 1))
//
// taken over e in increasing order. An edge whose dst lies outside
// [0, n) contributes nothing, as the TPU kernel's one-hot rows do. A
// masked edge is multiplied by its 0, not skipped, as in the reference.
// No atomics on floats: every sum has one fixed order.
//
// Bound on this card: latency, far from either roofline. Per event of
// the serve routes (E = 256 edges, n = 64 nodes, d = 70) a launch moves
// E*d*4 + E*8 + n*d*4 = 92 KB (0.027 us at 3.35 TB/s) and does 2*E*d
// f32 operations (0.0005 us at 67 TFLOP/s). What it pays is its
// dependent round trips to device memory and its barriers.
//
// Design: one CTA of 256 threads per (block of cw columns, block of bm
// destination rows, event); the plan (kernels/edge_aggregate.py:plan)
// picks cw and bm. Every CTA
//   1. loads the event's dst, as a row key (-1 off this CTA's rows), and
//      mask into shared memory, all threads, coalesced, in one round
//      trip, and issues cp.async copies of its column slice of the
//      event's messages (E x cw, when it fits in shared memory; else the
//      walk reads them from device memory), which land while it sorts;
//   2. counting-sorts the edges by row, all 8 warps at once: warp w owns
//      the contiguous edges [w*L, (w+1)*L) and takes them 32 a round.
//      __match_any_sync groups the lanes of one row; each edge's rank is
//      the count of its row's earlier edges in the warp, tab[row][w]
//      before this round, plus its rank among the lower lanes of its
//      group; the group's lowest lane then adds the group's size to
//      tab[row][w] (only warp w writes that entry). One exclusive scan of
//      tab in (row, warp) order makes each entry the first slot of warp
//      w's edges of that row, and each row's segment [tab[row][0],
//      tab[row+1][0]): warp 0 alone, each lane two rows' 16 counts in
//      registers (16-byte loads and stores), one shuffle scan over the
//      lanes' totals. Every thread then places its edges at
//      tab[row][w] + rank. Warp order is e order and ranks follow
//      lanes, so each row's edges lie in increasing e; no global load
//      inside the sort;
//   3. walks the segments: each thread takes one (row, column pair) (a
//      float2 where d is even, else one column), its edge ids and masks
//      from shared memory, four edges' loads issued before their sums:
//      acc = acc + mask[e] * msg[e, c], each product and sum rounded on
//      its own (-fmad=false), the count likewise; mean divides by
//      max(count, 1).
// kernels/ref.py:edge_aggregate_ref replays that order.
//
// A launch takes at most the edges whose sort fits in shared memory
// (kernels/edge_aggregate.py:max_edges). A longer edge list is walked in
// chunks of consecutive edges, one launch each
// (edge_aggregate.py:chunk_plan): every launch but the last leaves its
// f32 sums (and, for mean, its f32 counts) in a scratch buffer, every
// launch after the first starts each sum (and count) from those the one
// before left (carry), so every sum keeps its order over all E edges, and
// the last launch alone writes the output, dividing a mean once and
// rounding once.
//
// The bf16 forms (messages of type T, the output of type O): a bf16
// message slice is staged by ordinary loads, each value widened exactly
// into the same f32 shared memory (dtype_io.cuh), or read from device
// memory and widened in the walk; the sums, the counts and the scratch
// between chunks stay f32, and the output is rounded once where O is
// bf16. Every form is bitwise with the plain version, which sums in f32
// and rounds at the end.
#include <cuda_runtime.h>
#include <stdint.h>

#include "dtype_io.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kMaxRows = 64;  // destination rows of a CTA, at most

// Dynamic shared memory, in 4-byte words: the count table (kMaxRows x
// kWarps + 4: the scan's rows and its total, 16-byte aligned), the staged
// messages (e x cw), then keys, masks, ranks and the sorted edge ids (e
// each).
__host__ __device__ inline long long smem_words(int e, int cw, int staged) {
  return kMaxRows * kWarps + 4 + (staged ? (long long)e * cw : 0) + 4LL * e;
}

template <int BYTES>
__device__ inline void cp_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(BYTES)
               : "memory");
}

// e x cols of g (row stride d) into s (row stride cw), V floats a copy.
template <int V>
__device__ inline void stage(float* s, int cw, const float* g, int d, int e,
                             int cols) {
  const int per_row = cols / V;
  for (int i = threadIdx.x; i < e * per_row; i += kThreads) {
    const int r = i / per_row;
    const int c = (i - r * per_row) * V;
    cp_async<4 * V>(s + r * cw + c, g + (long long)r * d + c);
  }
}

// In-place exclusive scan of the count table tab[row][kWarps] in (row,
// warp) order by one warp: lane l holds rows 2l and 2l + 1 (kMaxRows in
// all; rows past the CTA's hold zeros), so the entry after the last row,
// tab[rows][0], receives the total.
__device__ inline void scan_table(int* tab) {
  static_assert(kWarps == 8 && kMaxRows == 64, "two rows of 8 per lane");
  const int lane = threadIdx.x & 31;
  int4* t4 = reinterpret_cast<int4*>(tab) + lane * 4;
  int c[16];  // row 2l's 8 counts, then row 2l + 1's
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int4 v = t4[i];
    c[4 * i] = v.x;
    c[4 * i + 1] = v.y;
    c[4 * i + 2] = v.z;
    c[4 * i + 3] = v.w;
  }
  int s = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int t = c[i];
    c[i] = s;
    s += t;
  }
  int incl = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  const int base = incl - s;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    t4[i] = make_int4(base + c[4 * i], base + c[4 * i + 1],
                      base + c[4 * i + 2], base + c[4 * i + 3]);
  if (lane == 31) tab[kMaxRows * kWarps] = incl;
}

template <int P>
__device__ inline void load_p(float (&v)[P], const float* p) {
  if constexpr (P == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = *p;
  }
}

template <int P>
__device__ inline void load_p(float (&v)[P], const repro_torch::io::bf16* p) {
  if constexpr (P == 2) {
    const float2 t =
        repro_torch::io::widen2(*reinterpret_cast<const uint32_t*>(p));
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = repro_torch::io::widen(*p);
  }
}

// Step 3: each (row, column group of P) of the CTA's tile sums its
// segment in e order. src(e) is the address of edge e's first column of
// this CTA's slice; the next columns follow it. out and part are (B, n,
// d), cnt_in and cnt_out (B, n), each indexed from the CTA's first row
// and column (o0, r0) rather than through a pointer to it, so that they
// keep the kernel's __restrict__ (a derived pointer that may be null
// loses it, and an unstaged f32 walk's loads then stop overlapping: the
// launch slows by more than half on the H100). LAST writes out (divided
// by the count for mean), else the f32 sums go to part; either way the
// counts go to cnt_out where it is given; CARRY starts from part and
// cnt_in. Both are template flags (as run-time flags they cost the same
// slowdown). A chunked call runs its first chunk as LAST into part with
// no division, its middle ones CARRY, its last CARRY and LAST
// (edge_aggregate.py): the kind it never takes, neither flag, showed the
// same slowdown in f32.
template <int P, bool CARRY, bool LAST, typename Src, typename O>
__device__ inline void walk(const int* perm, const float* km,
                            const int* tab, Src src, O* __restrict__ out,
                            float* __restrict__ part,
                            const float* __restrict__ cnt_in,
                            float* __restrict__ cnt_out, long long o0,
                            long long r0, int d, int rows, int cols,
                            int mean) {
  const int per_row = cols / P;
  for (int idx = threadIdx.x; idx < rows * per_row; idx += kThreads) {
    const int r = idx / per_row;
    const int c = (idx - r * per_row) * P;
    const long long off = o0 + (long long)r * d + c;
    float acc[P];
    float cnt = CARRY && cnt_in != nullptr ? cnt_in[r0 + r] : 0.0f;
#pragma unroll
    for (int j = 0; j < P; ++j) acc[j] = CARRY ? part[off + j] : 0.0f;
    const int hi = tab[(r + 1) * kWarps];
    for (int p = tab[r * kWarps]; p < hi; p += 4) {
      float v[4][P], m[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (p + u < hi) {
          const int e = perm[p + u];
          m[u] = km[e];
          load_p<P>(v[u], src(e) + c);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (p + u < hi) {
#pragma unroll
          for (int j = 0; j < P; ++j) acc[j] = acc[j] + m[u] * v[u][j];
          cnt = cnt + m[u];
        }
      }
    }
    if constexpr (LAST) {
#pragma unroll
      for (int j = 0; j < P; ++j)
        repro_torch::io::put(out + off + j,
                             mean ? acc[j] / fmaxf(cnt, 1.0f) : acc[j]);
    } else {
#pragma unroll
      for (int j = 0; j < P; ++j) part[off + j] = acc[j];
    }
    // every column group of the row writes the same count
    if (cnt_out != nullptr) cnt_out[r0 + r] = cnt;
  }
}

// A bf16 message slice: ordinary loads, four vectors a thread in flight,
// each value widened.
__device__ inline void stage_msg(float* ms, int cw,
                                 const repro_torch::io::bf16* g, int d,
                                 int e, int cols) {
  const repro_torch::io::Widen op[1] = {
      {ms, cw, g, d, e, cols, repro_torch::io::bf16_width(g, d, cols)}};
  repro_torch::io::widen_all(op, threadIdx.x, kThreads);
}

// An f32 message slice: cp.async copies of 16, 8 or 4 bytes.
__device__ inline void stage_msg(float* ms, int cw, const float* g, int d,
                                 int e, int cols) {
  if (d % 4 == 0 && cw % 4 == 0)
    stage<4>(ms, cw, g, d, e, cols);
  else if (d % 2 == 0 && cw % 2 == 0)
    stage<2>(ms, cw, g, d, e, cols);
  else
    stage<1>(ms, cw, g, d, e, cols);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <typename T, typename O, bool CARRY, bool LAST>
__global__ void __launch_bounds__(kThreads)
edge_aggregate_kernel(const T* __restrict__ msg,
                      const int* __restrict__ dst,
                      const float* __restrict__ mask, O* __restrict__ out,
                      float* __restrict__ part,
                      const float* __restrict__ cnt_in,
                      float* __restrict__ cnt_out, int e_count,
                      int e_stride, int n, int d, int bm, int cw,
                      int staged, int mean) {
  extern __shared__ float4 smem4[];
  int* tab = reinterpret_cast<int*>(smem4);               // 64*W + 4
  float* ms = reinterpret_cast<float*>(tab + kMaxRows * kWarps + 4);
  int* key = reinterpret_cast<int*>(ms) + (staged ? e_count * cw : 0);
  float* km = reinterpret_cast<float*>(key + e_count);  // e
  int* rank = key + 2 * e_count;                          // e
  int* perm = key + 3 * e_count;                          // e

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z;
  const int row0 = blockIdx.y * bm, c0 = blockIdx.x * cw;
  const int rows = min(bm, n - row0), cols = min(cw, d - c0);
  const T* msg_b = msg + (long long)b * e_stride * d + c0;
  const int* dst_b = dst + (long long)b * e_stride;
  const float* mask_b = mask + (long long)b * e_stride;

  // 1. one round trip: keys and masks, the message slice
  for (int e = tid; e < e_count; e += kThreads) {
    const int v = dst_b[e];
    const float m = mask_b[e];
    key[e] = (v >= row0 && v < row0 + rows) ? v - row0 : -1;
    km[e] = m;
  }
  if (staged) stage_msg(ms, cw, msg_b, d, e_count, cols);
  for (int i = tid; i < kMaxRows * kWarps + 4; i += kThreads) tab[i] = 0;
  __syncthreads();

  // 2. the counting sort: warp w's edges [lo, hi), 32 a round
  const int span = (e_count + 32 * kWarps - 1) / (32 * kWarps) * 32;
  const int lo = warp * span, hi = min(lo + span, e_count);
  const unsigned below = (1u << lane) - 1u;
  for (int base = lo; base < hi; base += 32) {
    const int e = base + lane;
    const int k = e < hi ? key[e] : -1;
    const unsigned grp = __match_any_sync(kFull, k);
    if (k >= 0) rank[e] = tab[k * kWarps + warp] + __popc(grp & below);
    __syncwarp();
    if (k >= 0 && lane == __ffs(grp) - 1) tab[k * kWarps + warp] += __popc(grp);
    __syncwarp();
  }
  __syncthreads();
  if (warp == 0) scan_table(tab);
  __syncthreads();
  for (int e = tid; e < e_count; e += kThreads) {
    const int k = key[e];
    if (k >= 0) perm[tab[k * kWarps + e / span] + rank[e]] = e;
  }
  if (staged) asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // 3. the segment walk
  const long long o0 = ((long long)b * n + row0) * d + c0;
  const long long r0 = (long long)b * n + row0;
  if (staged) {
    auto src = [ms, cw](int e) { return ms + e * cw; };
    if (d % 2 == 0)
      walk<2, CARRY, LAST>(perm, km, tab, src, out, part, cnt_in, cnt_out,
                           o0, r0, d, rows, cols, mean);
    else
      walk<1, CARRY, LAST>(perm, km, tab, src, out, part, cnt_in, cnt_out,
                           o0, r0, d, rows, cols, mean);
  } else {
    // column pairs where d is even and the messages lie at an even
    // element (a contiguous view may start anywhere)
    const bool pairs =
        d % 2 == 0 && reinterpret_cast<uintptr_t>(msg) % (2 * sizeof(T)) == 0;
    auto src = [msg_b, d](int e) { return msg_b + (long long)e * d; };
    if (pairs)
      walk<2, CARRY, LAST>(perm, km, tab, src, out, part, cnt_in, cnt_out,
                           o0, r0, d, rows, cols, mean);
    else
      walk<1, CARRY, LAST>(perm, km, tab, src, out, part, cnt_in, cnt_out,
                           o0, r0, d, rows, cols, mean);
  }
}

}  // namespace

// Bytes of dynamic shared memory one CTA needs at these shapes.
extern "C" long long edge_aggregate_smem_bytes(int e, int cw, int staged) {
  return smem_words(e, cw, staged) * 4LL;
}

namespace {

template <typename T, typename O, bool CARRY, bool LAST>
int launch_io(const T* msg, const int* dst, const float* mask, O* out,
              float* part, const float* cnt_in, float* cnt_out, int B,
              int e, int e_stride, int n, int d, int bm, int cw, int staged,
              int mean, cudaStream_t stream) {
  const long long smem = edge_aggregate_smem_bytes(e, cw, staged);
  auto kernel = edge_aggregate_kernel<T, O, CARRY, LAST>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((d + cw - 1) / cw, (n + bm - 1) / bm, B);
  kernel<<<grid, kThreads, (size_t)smem, stream>>>(
      msg, dst, mask, out, part, cnt_in, cnt_out, e, e_stride, n, d, bm, cw,
      staged, mean);
  return (int)cudaGetLastError();
}

// The launch of a chunk's kind: (carry, last) as template flags.
template <typename T, typename O>
int launch_chunk(const T* msg, const int* dst, const float* mask, O* out,
                 float* part, const float* cnt_in, float* cnt_out, int B,
                 int e, int e_stride, int n, int d, int bm, int cw,
                 int staged, int mean, int carry, int last,
                 cudaStream_t st) {
#define REPRO_CHUNK(C, L)                                                  \
  return launch_io<T, O, C, L>(msg, dst, mask, out, part, cnt_in, cnt_out, \
                               B, e, e_stride, n, d, bm, cw, staged, mean, \
                               st)
  if (last) {
    if (carry) REPRO_CHUNK(true, true);
    REPRO_CHUNK(false, true);
  }
  if (carry) REPRO_CHUNK(true, false);
#undef REPRO_CHUNK
  return (int)cudaErrorInvalidValue;   // a first chunk runs as last
}

}  // namespace

// msg:(B,e,d) of the dtype in_dtype, dst:(B,e) i32, mask:(B,e) f32 ->
// out:(B,n,d) of out_dtype (dtype_io.cuh: 0 = f32, 1 = bf16); the e
// edges of graph b start at msg + b*e_stride*d, dst + b*e_stride and
// mask + b*e_stride (e_stride >= e: a chunk of a longer list), rows of d
// contiguous. bm <= 64 rows and cw columns per CTA (cw even where d is);
// staged != 0 stages each CTA's message slice in shared memory. mean != 0
// divides by the masked in-degree. A chunk: carry != 0 starts each sum
// from part:(B,n,d) f32 and, for mean, each count from cnt_in:(B,n) f32;
// last == 0 leaves the sums in part instead of writing out (carry must
// then be set: a first chunk runs as last, into an f32 out); cnt_out, if
// not null, receives the counts. out, part, cnt_in and cnt_out are four
// buffers.
extern "C" int edge_aggregate_ex(const void* msg, const int* dst,
                                 const float* mask, void* out, float* part,
                                 const float* cnt_in, float* cnt_out, int B,
                                 int e, int e_stride, int n, int d, int bm,
                                 int cw, int staged, int mean, int carry,
                                 int last, int in_dtype, int out_dtype,
                                 void* stream) {
  if (B <= 0 || n <= 0 || d <= 0) return (int)cudaGetLastError();
  if (bm <= 0 || bm > kMaxRows || cw <= 0 || (d % 2 == 0 && cw % 2 != 0) ||
      e_stride < e || ((carry || !last) && part == nullptr) ||
      (!last && !carry) || (mean && carry && cnt_in == nullptr) ||
      (mean && !last && cnt_out == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  REPRO_DISPATCH_IO(in_dtype, out_dtype,
                    return launch_chunk(static_cast<const T*>(msg), dst,
                                        mask, static_cast<O*>(out), part,
                                        cnt_in, cnt_out, B, e, e_stride, n,
                                        d, bm, cw, staged, mean, carry,
                                        last, st));
}
