// The GravNet aggregation cell with its distance row in registers, run
// by one warp per query row. Used by the kernels that run the whole cell:
// gravnet_block_int8.cu, gravnet_block.cu and gravnet_aggregate.cu, up to
// 512 hits and d_f 128; the ragged knn_build.cu runs its selection half
// (load_row with a segment predicate, select_round) up to 512 hits, and
// knn_aggregate.cu repeats cell_row's round body on knn_build's (idx, d2)
// up to d_f 128. Past those the f32 kernels and the kNN pair run the
// shared-memory cell of gravnet_cell.cuh.
//
// It computes what gravnet_cell.cuh's gravnet_cell_row computes, with
// the same semantics (repro/kernels/gravnet.py:_gravnet_cell):
//   d2_j = (|s_i|^2 + |s_j|^2) - 2 s_i.s_j, the dot summed over d in
//   order, clamped at 0; 1e30 for a candidate that is not valid (the
//   row itself, a masked or padding row);
//   k rounds: (dmin, j*) = the row minimum, ties to the lowest column;
//   d2_j* = 1e30 (knockout: once the valid candidates are spent, the
//   rounds keep finding the lowest column at 1e30);
//   w = exp(-scale dmin) if dmin < 0.5e30 else 0; mean += w f_j*;
//   max = max(max, w f_j*) on valid rounds;
//   out = [mean / k, (max <= -0.5e30 ? 0 : max)].
// Every f32 operation is the shared-memory cell's, in its order, so the
// two give the same bits; the division of the mean by k is left to the
// caller (the IEEE division in the f32 kernels, int8_quant.cuh's
// quotient in the int8 block).
//
// What changes is the selection. Lane l keeps the candidates j = l + 32c
// (c < CPL, n <= 32 CPL) as the unsigned bits of their distances, and
// its own minimum with its column. A distance is non-negative, so its
// bits order as the floats do once -0 (which fmaxf(v, 0) may return) is
// mapped to +0; 1e30 orders after every real distance, and a column
// j >= n carries 0xffffffff and is never chosen. A round is two
// __reduce_min_sync: the smallest key, then the lowest column holding
// it; the lane that owns the winner knocks it out and rescans its CPL
// registers, the others keep their minimum. The shared-memory cell
// spent a scan of the row, a 5-step shuffle argmin of 10 shuffles and a
// knockout store per round.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {
namespace regcell {

constexpr float kBig = 1e30f;
constexpr uint32_t kNone = 0xffffffffu;   // a column j >= n
constexpr int kMaxDfPerLane = 4;          // d_f <= 128
constexpr int kMaxDsInRegisters = 8;      // s_i's first 8 dims in registers

// The key of a non-negative distance: its bits, with -0 as +0.
__device__ inline uint32_t key_of(float v) {
  const uint32_t u = __float_as_uint(v);
  return u == 0x80000000u ? 0u : u;
}

// The lane's minimum key and its column, ties to the lowest column
// (columns rise with c, and a strict < keeps the first).
template <int CPL>
__device__ inline void lane_min(const uint32_t (&d)[CPL], uint32_t& lv,
                                int& lc) {
  const int lane = threadIdx.x & 31;
  lv = d[0];
  lc = lane;
#pragma unroll
  for (int c = 1; c < CPL; ++c)
    if (d[c] < lv) { lv = d[c]; lc = lane + 32 * c; }
}

// The row's candidates for query row i: column j is a candidate where
// valid(j) holds, else 1e30. s:(n,ds) in shared memory; sq_i = |s_i|^2.
// |s_j|^2 is summed here, in the order of gravnet_cell.cuh's caller
// (0 + s0 s0 + s1 s1 + ...).
template <int CPL, typename Valid>
__device__ inline void load_row(int i, int n, int ds,
                                const float* __restrict__ s, Valid valid,
                                uint32_t (&d)[CPL]) {
  const int lane = threadIdx.x & 31;
  float si[kMaxDsInRegisters];
  float sqi = 0.0f;
#pragma unroll
  for (int q = 0; q < kMaxDsInRegisters; ++q) {
    si[q] = q < ds ? s[i * ds + q] : 0.0f;
    if (q < ds) sqi += si[q] * si[q];
  }
  for (int q = kMaxDsInRegisters; q < ds; ++q) sqi += s[i * ds + q] * s[i * ds + q];
  const uint32_t big = __float_as_uint(kBig);
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int j = lane + 32 * c;
    if (j >= n) { d[c] = kNone; continue; }
    float dot = 0.0f, sqj = 0.0f;
#pragma unroll
    for (int q = 0; q < kMaxDsInRegisters; ++q) {
      if (q < ds) {
        const float sj = s[j * ds + q];
        dot += si[q] * sj;
        sqj += sj * sj;
      }
    }
    for (int q = kMaxDsInRegisters; q < ds; ++q) {
      const float sj = s[j * ds + q];
      dot += s[i * ds + q] * sj;
      sqj += sj * sj;
    }
    const float v = fmaxf((sqi + sqj) - 2.0f * dot, 0.0f);
    d[c] = valid(j) ? key_of(v) : big;
  }
}

// The cell's form: j is a candidate where msk:(n,) (in shared memory) is
// above 0 and j != i.
template <int CPL>
__device__ inline void load_row(int i, int n, int ds,
                                const float* __restrict__ s,
                                const float* __restrict__ msk,
                                uint32_t (&d)[CPL]) {
  load_row<CPL>(i, n, ds, s,
                [msk, i](int j) { return !(msk[j] <= 0.0f || j == i); }, d);
}

// One round: (dmin, j) of the row minimum, ties to the lowest column,
// the same in every lane; column j is then knocked out to 1e30.
template <int CPL>
__device__ inline void select_round(uint32_t (&d)[CPL], uint32_t& lv,
                                    int& lc, float& dmin, int& j) {
  const int lane = threadIdx.x & 31;
  const uint32_t m = __reduce_min_sync(0xffffffffu, lv);
  j = (int)__reduce_min_sync(0xffffffffu, lv == m ? (uint32_t)lc : kNone);
  dmin = __uint_as_float(m);
  if (lane == (j & 31)) {
    const int cj = j >> 5;
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      if (c == cj) d[c] = __float_as_uint(kBig);
    lane_min(d, lv, lc);
  }
}

// The whole cell for query row i. s:(n,ds) f:(n,df) msk:(n,) in shared
// memory. On return lane l holds the outputs of the columns
// c = l + 32u (u < ceil(df / 32)): the mean's sum over the k rounds,
// sum[u] (not yet divided by k), and the max, mx[u].
template <int CPL>
__device__ inline void cell_row(int i, int n, int ds, int df, int k,
                                float scale, const float* __restrict__ s,
                                const float* __restrict__ f,
                                const float* __restrict__ msk,
                                float (&sum)[kMaxDfPerLane],
                                float (&mx)[kMaxDfPerLane]) {
  const int lane = threadIdx.x & 31;
  uint32_t d[CPL];
  load_row<CPL>(i, n, ds, s, msk, d);
  uint32_t lv;
  int lc;
  lane_min(d, lv, lc);
#pragma unroll
  for (int u = 0; u < kMaxDfPerLane; ++u) {
    sum[u] = 0.0f;
    mx[u] = -kBig;
  }
#pragma unroll 8
  for (int t = 0; t < k; ++t) {
    float dmin;
    int j;
    select_round(d, lv, lc, dmin, j);
    const bool valid = dmin < kBig * 0.5f;
    const float w = valid ? expf(-scale * dmin) : 0.0f;
    // every lane accumulates, a lane past df on column df - 1: its
    // outputs are never read, and the loop needs no branch
#pragma unroll
    for (int u = 0; u < kMaxDfPerLane; ++u) {
      if (32 * u >= df) break;
      const float wf = w * f[j * df + min(lane + 32 * u, df - 1)];
      sum[u] = sum[u] + wf;
      if (valid) mx[u] = fmaxf(mx[u], wf);
    }
  }
#pragma unroll
  for (int u = 0; u < kMaxDfPerLane; ++u)
    if (mx[u] <= -kBig * 0.5f) mx[u] = 0.0f;
}

}  // namespace regcell
}  // namespace repro_torch
