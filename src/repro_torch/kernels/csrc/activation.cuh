// The activations of the dense epilogues, shared by the f32 and int8
// denses (fused_dense.cu, fused_dense_int8.cu) and blocks
// (gravnet_block.cu, gravnet_block_int8.cu). The codes are
// kernels/fused_dense.py:act_code's: 0 none, 1 relu, 2 gelu, 3 silu.
//
// relu and none are exact, so those epilogues stay bitwise with the plain
// versions. gelu is the tanh form, jax.nn.gelu's default and
// F.gelu(approximate="tanh"): 0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715
// x^3))); silu is x / (1 + exp(-x)). Both run in f32 on CUDA's tanhf and
// expf, which need not round as PyTorch's do: the plain versions hold
// them to the float32 row, not to their bits.
#pragma once

namespace repro_torch {

__device__ inline float activate(float v, int act) {
  if (act == 1) return v > 0.0f ? v : 0.0f;
  if (act == 2) {
    const float inner = 0.7978845608028654f * (v + 0.044715f * (v * v * v));
    return 0.5f * v * (1.0f + tanhf(inner));
  }
  if (act == 3) return v / (1.0f + expf(-v));
  return v;
}

}  // namespace repro_torch
