// The GravNet aggregation cell for one query row, run by one warp.
//
// Counterpart of repro/kernels/gravnet.py:_gravnet_cell, shared by every
// kernel of the port that aggregates over learned-space neighbours (the
// fused block now; the standalone gravnet_aggregate and the ragged kNN
// kernels later), as the Pallas kernels share _gravnet_cell.
//
// The TPU kernel selected each neighbour with a one-hot matmul because
// the TPU had no gather; here the selected row is a direct indexed load
// from shared memory (an f32 one-hot product has one non-zero term, so
// the values are the same).
//
// Per query row i, against the n rows of its event:
//   d2_j = (|s_i|^2 + |s_j|^2) - 2 s_i.s_j, clamped at 0; 1e30 for j == i
//   and for rows whose mask is <= 0;
//   k rounds: (dmin, j*) = row minimum, ties to the lowest column;
//   w = exp(-scale dmin) if dmin < 0.5e30 else 0; mean += w f_j*;
//   max = max(max, w f_j*) on valid rounds; d2_j* = 1e30;
//   out = [mean / k, (max <= -0.5e30 ? 0 : max)].
#pragma once
#include <cuda_runtime.h>

namespace repro_torch {

constexpr float kBig = 1e30f;

// s:(n,ds) f:(n,df) sq:(n,) |s_j|^2, msk:(n,) — all in shared memory.
// d2row: n floats of scratch owned by this warp. out: 2*df floats.
__device__ inline void gravnet_cell_row(
    int i, int n, int ds, int df, int k, float scale,
    const float* __restrict__ s, const float* __restrict__ sq,
    const float* __restrict__ f, const float* __restrict__ msk,
    float* __restrict__ d2row, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  for (int j = lane; j < n; j += 32) {
    float dot = 0.0f;
    for (int d = 0; d < ds; ++d) dot += s[i * ds + d] * s[j * ds + d];
    float v = (sq[i] + sq[j]) - 2.0f * dot;
    v = fmaxf(v, 0.0f);
    d2row[j] = (msk[j] <= 0.0f || j == i) ? kBig : v;
  }
  for (int c = lane; c < df; c += 32) {
    out[c] = 0.0f;
    out[df + c] = -kBig;
  }
  __syncwarp();

  for (int t = 0; t < k; ++t) {
    float bv = __int_as_float(0x7f800000);  // +inf
    int bj = 0x7fffffff;
    for (int j = lane; j < n; j += 32) {    // j rises: strict < keeps
      const float v = d2row[j];             // the lowest column of a tie
      if (v < bv) { bv = v; bj = j; }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oj = __shfl_xor_sync(0xffffffffu, bj, off);
      if (ov < bv || (ov == bv && oj < bj)) { bv = ov; bj = oj; }
    }
    const bool valid = bv < kBig * 0.5f;
    const float w = valid ? expf(-scale * bv) : 0.0f;
    for (int c = lane; c < df; c += 32) {
      const float wf = w * f[bj * df + c];
      out[c] = out[c] + wf;
      if (valid) out[df + c] = fmaxf(out[df + c], wf);
    }
    if (lane == (bj & 31)) d2row[bj] = kBig;   // knock the column out
    __syncwarp();
  }

  for (int c = lane; c < df; c += 32) {
    out[c] = out[c] / (float)k;
    if (out[df + c] <= -kBig * 0.5f) out[df + c] = 0.0f;
  }
  __syncwarp();
}

}  // namespace repro_torch
