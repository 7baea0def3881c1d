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
// No atomics: every sum has one fixed order.
//
// Bound on this card: latency, far from either roofline. Per event of
// the serve routes (E = 256 edges, n = 64 nodes, d = 70) a launch moves
// E*d*4 + E*8 + n*d*4 = 92 KB (0.027 us at 3.35 TB/s) and does 2*E*d
// f32 operations (0.0005 us at 67 TFLOP/s). What it pays is one warp's
// sweep over the event's edges and each thread's short dependent chain
// of loads along its node's segment.
//
// Design: the TPU kernel's (bm, E) one-hot slab times the (E, d)
// messages becomes a segment reduction over a CSR that each CTA builds
// in shared memory. One CTA of 256 threads per (block of bm destination
// rows, event). Warp 0 sweeps the event's dst 32 edges at a time, twice:
// __match_any_sync groups the lanes that share a destination row, and
// the group's lowest lane adds the group's size to that row's counter
// (first sweep: counts, then a warp scan into row offsets; second sweep:
// each edge goes to its row's offset + the edges of that row already
// placed + its rank among the lower lanes of its group). So each row's
// edges lie in increasing e, a counting sort with no atomics. The CTA's
// threads then take (row, column) pairs and walk their row's segment:
// acc = acc + mask[e] * msg[e, c], each product and sum rounded on its
// own (-fmad=false), the count likewise; mean divides by max(count, 1).
// kernels/ref.py:edge_aggregate_ref replays that order.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// Dynamic shared memory, in 4-byte words: perm and mask (e each), the
// row offsets (bm + 1) and the running counters (bm).
__host__ __device__ inline long long smem_words(int e, int bm) {
  return 2LL * e + 2LL * bm + 1;
}

// The row of edge e within this CTA's block, or -1: past the edge list,
// or a dst outside [row0, row0 + rows).
__device__ inline int row_key(const int* dst, int e, int e_count, int row0,
                              int rows) {
  if (e >= e_count) return -1;
  const int v = dst[e];
  return (v >= row0 && v < row0 + rows) ? v - row0 : -1;
}

__global__ void __launch_bounds__(kThreads)
edge_aggregate_kernel(const float* __restrict__ msg,
                      const int* __restrict__ dst,
                      const float* __restrict__ mask,
                      float* __restrict__ out, int e_count, int n, int d,
                      int bm, int mean) {
  extern __shared__ int smem[];
  int* perm = smem;                                        // e_count
  float* km = reinterpret_cast<float*>(smem + e_count);    // e_count
  int* off = smem + 2 * e_count;                           // bm + 1
  int* run = off + bm + 1;                                 // bm

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * bm;
  const int rows = min(bm, n - row0);
  const int* dst_b = dst + (size_t)b * e_count;

  for (int e = tid; e < e_count; e += kThreads)
    km[e] = mask[(size_t)b * e_count + e];
  for (int r = tid; r < rows; r += kThreads) run[r] = 0;
  __syncthreads();

  if (tid < 32) {
    // sweep 1: edges per row
    for (int base = 0; base < e_count; base += 32) {
      const int key = row_key(dst_b, base + lane, e_count, row0, rows);
      const unsigned grp = __match_any_sync(kFull, key);
      if (key >= 0 && lane == __ffs(grp) - 1) run[key] += __popc(grp);
      __syncwarp();
    }
    // exclusive scan of the counts into row offsets
    int carry = 0;
    for (int base = 0; base < rows; base += 32) {
      const int r = base + lane;
      const int c = r < rows ? run[r] : 0;
      int incl = c;
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += t;
      }
      if (r < rows) off[r] = carry + incl - c;
      carry += __shfl_sync(kFull, incl, 31);
    }
    if (lane == 0) off[rows] = carry;
    __syncwarp();
    for (int r = lane; r < rows; r += 32) run[r] = off[r];
    __syncwarp();
    // sweep 2: each edge after the earlier edges of its row
    for (int base = 0; base < e_count; base += 32) {
      const int e = base + lane;
      const int key = row_key(dst_b, e, e_count, row0, rows);
      const unsigned grp = __match_any_sync(kFull, key);
      if (key >= 0) perm[run[key] + __popc(grp & ((1u << lane) - 1u))] = e;
      __syncwarp();
      if (key >= 0 && lane == __ffs(grp) - 1) run[key] += __popc(grp);
      __syncwarp();
    }
  }
  __syncthreads();

  const float* msg_b = msg + (size_t)b * e_count * d;
  float* out_b = out + ((size_t)b * n + row0) * d;
  for (int idx = tid; idx < rows * d; idx += kThreads) {
    const int r = idx / d;
    const int c = idx - r * d;
    float acc = 0.0f, cnt = 0.0f;
    for (int p = off[r]; p < off[r + 1]; ++p) {
      const int e = perm[p];
      const float m = km[e];
      acc = acc + m * msg_b[(size_t)e * d + c];
      cnt = cnt + m;
    }
    out_b[idx] = mean ? acc / fmaxf(cnt, 1.0f) : acc;
  }
}

}  // namespace

// Bytes of dynamic shared memory one CTA needs at these shapes.
extern "C" long long edge_aggregate_smem_bytes(int e, int bm) {
  return smem_words(e, bm) * 4LL;
}

// msg:(B,e,d) f32, dst:(B,e) i32, mask:(B,e) f32 -> out:(B,n,d) f32;
// all contiguous. mean != 0 divides by the masked in-degree.
extern "C" int edge_aggregate_f32(const float* msg, const int* dst,
                                  const float* mask, float* out, int B,
                                  int e, int n, int d, int bm, int mean,
                                  void* stream) {
  const long long smem = edge_aggregate_smem_bytes(e, bm);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        edge_aggregate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (B > 0 && n > 0) {
    dim3 grid((n + bm - 1) / bm, B);
    edge_aggregate_kernel<<<grid, kThreads, (size_t)smem,
                            (cudaStream_t)stream>>>(msg, dst, mask, out, e,
                                                    n, d, bm, mean);
  }
  return (int)cudaGetLastError();
}
