"""The source transform of ``repro_torch/kernels/phase_split.py`` (the
phase timer of ``gravnet_block_int8``), on the CPU: a ``clock64()``
stamp after the kernel's start, after each ``__syncthreads()`` of its
body and at its end, each phase labelled by its first comment, and the
kernel's own text otherwise untouched. Running the stamped build needs a
card."""
import re

from repro_torch.kernels.phase_split import stamped_source

STAMP = "repro_st[repro_ns++] = clock64();"
SOURCE = """#include <cuda_runtime.h>

namespace {

__device__ inline void helper() { __syncthreads(); }

__global__ void k(const float* x, float* y) {
  // load (a comment with a brace {)
  float v = x[threadIdx.x];
  __syncthreads();
  // store
  y[threadIdx.x] = v;
  if (v > 0.0f) {
    __syncthreads();
  }
}

}  // namespace
"""


def test_stamps_each_barrier_of_the_kernel_body():
    out, labels = stamped_source(SOURCE)
    assert labels == ["load (a comment with a brace {)", "store", "}"]
    body = out[out.index("__global__"):out.index("}  // namespace")]
    # one at the start, one after each of the two barriers, one at the end
    assert body.count(STAMP) == 4
    # the helper's barrier is not the kernel's
    assert "helper() { __syncthreads(); }" in out
    assert out.index("__device__ long long* repro_phase_stamps;") < out.index(
        "namespace {")
    stripped = out.replace(STAMP, "")
    stripped = re.sub(r"\n  long long repro_st\[\d+\]; int repro_ns = 0;\n",
                      "", stripped)
    assert "y[threadIdx.x] = v;" in stripped

