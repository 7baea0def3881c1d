// The GravNet aggregation cell, run by one warp per query row.
//
// Counterpart of repro/kernels/gravnet.py:_gravnet_cell and of its two
// halves in repro/kernels/knn_build.py (_knn_select_cell,
// _knn_agg_cell). Every kernel runs it only past the limits of the
// register-resident cell (gravnet_cell_reg.cuh), which computes the same
// bits: the f32 block and the standalone aggregation the whole cell
// (gravnet_cell_row) past 512 hits or d_f 128, the ragged knn_build its
// selection steps past 512 hits, knn_aggregate its accumulation steps
// past d_f 128. Below them they and the int8 block run the register
// cell.
//
// The TPU kernel selected each neighbour with a one-hot matmul because
// the TPU had no gather; here the selected row is a direct indexed load
// (an f32 one-hot product has one non-zero term, so the values are the
// same).
//
// Per query row i, against the n rows of its event:
//   d2_j = (|s_i|^2 + |s_j|^2) - 2 s_i.s_j, clamped at 0; 1e30 for
//   candidates that are not valid (self, masked or padding rows, or
//   another segment);
//   k rounds: (dmin, j*) = row minimum, ties to the lowest column;
//   d2_j* = 1e30 (knockout);
//   w = exp(-scale dmin) if dmin < 0.5e30 else 0; mean += w f_j*;
//   max = max(max, w f_j*) on valid rounds;
//   out = [mean / k, (max <= -0.5e30 ? 0 : max)].
#pragma once
#include <cuda_runtime.h>

namespace repro_torch {

constexpr float kBig = 1e30f;

// d2 of rows i and j, the dot summed over d in order, clamped at 0.
// s:(n,ds) and sq:(n,) |s_j|^2, in shared memory.
__device__ inline float cell_d2(int i, int j, int ds,
                                const float* __restrict__ s,
                                const float* __restrict__ sq) {
  float dot = 0.0f;
  for (int d = 0; d < ds; ++d) dot += s[i * ds + d] * s[j * ds + d];
  const float v = (sq[i] + sq[j]) - 2.0f * dot;
  return fmaxf(v, 0.0f);
}

// One selection round over the warp-private distance row d2row[0, n):
// (bv, bj) = the row minimum and its column, ties to the lowest column,
// the same in every lane; the column is then knocked out.
__device__ inline void cell_select(int n, float* __restrict__ d2row,
                                   float& bv, int& bj) {
  const int lane = threadIdx.x & 31;
  bv = __int_as_float(0x7f800000);         // +inf
  bj = 0x7fffffff;
  for (int j = lane; j < n; j += 32) {     // j rises: strict < keeps
    const float v = d2row[j];              // the lowest column of a tie
    if (v < bv) { bv = v; bj = j; }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
    const int oj = __shfl_xor_sync(0xffffffffu, bj, off);
    if (ov < bv || (ov == bv && oj < bj)) { bv = ov; bj = oj; }
  }
  // column bj is only ever read by lane bj % 32, which knocks it out
  if (lane == (bj & 31)) d2row[bj] = kBig;
  __syncwarp();
}

// out:(2 df) = [0, -1e30], the accumulators of one row.
__device__ inline void cell_init(int df, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  for (int c = lane; c < df; c += 32) {
    out[c] = 0.0f;
    out[df + c] = -kBig;
  }
  __syncwarp();
}

// Adds one neighbour, at distance dmin with features fj:(df), to the
// row's accumulators. Each lane owns the columns c = lane (mod 32).
__device__ inline void cell_accumulate(float dmin,
                                       const float* __restrict__ fj,
                                       int df, float scale,
                                       float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const bool valid = dmin < kBig * 0.5f;
  const float w = valid ? expf(-scale * dmin) : 0.0f;
  for (int c = lane; c < df; c += 32) {
    const float wf = w * fj[c];
    out[c] = out[c] + wf;
    if (valid) out[df + c] = fmaxf(out[df + c], wf);
  }
}

// out = [mean / k, max or 0 when no round was valid].
__device__ inline void cell_finish(int df, int k, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  for (int c = lane; c < df; c += 32) {
    out[c] = out[c] / (float)k;
    if (out[df + c] <= -kBig * 0.5f) out[df + c] = 0.0f;
  }
  __syncwarp();
}

// The whole cell for query row i. s:(n,ds) f:(n,df) sq:(n,) |s_j|^2,
// msk:(n,) — all in shared memory; a row whose mask is <= 0 is no
// candidate. d2row: n floats of scratch owned by this warp. out: 2*df
// floats.
__device__ inline void gravnet_cell_row(
    int i, int n, int ds, int df, int k, float scale,
    const float* __restrict__ s, const float* __restrict__ sq,
    const float* __restrict__ f, const float* __restrict__ msk,
    float* __restrict__ d2row, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  for (int j = lane; j < n; j += 32) {
    const float v = cell_d2(i, j, ds, s, sq);
    d2row[j] = (msk[j] <= 0.0f || j == i) ? kBig : v;
  }
  cell_init(df, out);      // its __syncwarp also orders the d2row writes
  for (int t = 0; t < k; ++t) {
    float dmin;
    int j;
    cell_select(n, d2row, dmin, j);
    cell_accumulate(dmin, f + j * df, df, scale, out);
  }
  cell_finish(df, k, out);
}

}  // namespace repro_torch
