"""The source transform of ``repro_torch/kernels/phase_split.py`` (the
phase timer of the GravNet and kNN kernels), on the CPU: a ``clock64()`` stamp
after the named kernel's start, after each ``__syncthreads()`` of its
body and at its end, each phase labelled by its first comment, and the
kernel's own text otherwise untouched; each ``--kernel`` option's
source, entry and inputs; and ``kernels/source_ab.py``'s options and the
chunks it times the GravNet pair at. Running either tool needs a
card."""
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, gravnet_block, phase_split, source_ab
from repro_torch.kernels import ref as tref
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



TWO_KERNELS = """#include <cuda_runtime.h>

namespace {

template <int CPL>
__global__ void __launch_bounds__(512)
block_kernel(float* y) {
  // 1. stage
  y[threadIdx.x] = CPL;
  __syncthreads();
  // 2. write
  y[threadIdx.x] += 1.0f;
}

__global__ void __launch_bounds__(256)
block_shared_kernel(float* y) {
  // first version
  __syncthreads();
}

}  // namespace
"""


@pytest.mark.parametrize("kernel,labels,stamped", [
    ("block_kernel", ["1. stage", "2. write"], "block_kernel"),
    ("block_shared_kernel", ["first version", "(empty)"],
     "block_shared_kernel"),
    (None, ["1. stage", "2. write"], "block_kernel")])
def test_stamps_only_the_named_kernel(kernel, labels, stamped):
    """With several __global__ functions in a source (a register path
    and a shared-memory path), the stamps go into the named one's body
    (the first one's when none is named), a name that is a prefix of
    another's picks its own, and the other body stays as it was."""
    out, got = stamped_source(TWO_KERNELS, kernel)
    assert got == labels
    other = ({"block_kernel", "block_shared_kernel"} - {stamped}).pop()
    start = out.index(other + "(")
    end = out.index("\n}\n", start)
    assert STAMP not in out[start:end]
    start = out.index(stamped + "(")
    assert out[start:out.index("\n}\n", start)].count(STAMP) == 3


def test_refuses_a_kernel_the_source_lacks():
    with pytest.raises(ValueError, match="no __global__ function"):
        stamped_source(TWO_KERNELS, "block")


@pytest.mark.parametrize("name", sorted(phase_split.SPECS))
def test_each_kernel_spec_matches_its_source_and_package(name):
    """Each --kernel option names a __global__ function and a C entry of
    its default source, stamps it, passes the entry as many arguments as
    its argument types, at the package's rows per CTA by default, on
    inputs of the main path's widths."""
    spec = phase_split.SPECS[name]
    src = (_build.CSRC / f"{name}.cu").read_text()
    assert f'extern "C" int {spec.entry}(' in src
    out, labels = stamped_source(src, spec.kernel)
    # the kNN aggregation has no barrier: one phase, the CTA's whole time
    assert len(labels) >= (1 if name == "knn_aggregate" else 2)
    assert out.count(STAMP) == len(labels) + 1
    for bsz in spec.events:
        ops, kw = spec.inputs(bsz)
        t = [torch.from_numpy(np.ascontiguousarray(o)) for o in ops]
        assert all(tuple(o.shape[:2]) == (bsz, phase_split.N_HITS)
                   for o in t[:2])
        ys = [torch.empty(bsz, phase_split.N_HITS, w,
                          dtype=getattr(torch, dt)) for w, dt in spec.outs]
        seen = []
        spec.call(lambda *a: seen.append(a) or 0, t, ys, bsz,
                  spec.bm(bsz), 0, kw)
        assert len(seen[0]) == len(spec.argtypes)
        if name.startswith("knn"):
            # the plain version on these inputs gives outputs of these
            # widths and dtypes
            got = getattr(tref, name + "_ref")(*t, **dict(spec.package_kw))
            got = got if isinstance(got, tuple) else (got,)
            assert [(g.shape[2], str(g.dtype)[6:]) for g in got] == list(
                spec.outs)
    assert spec.bm(2) == {"gravnet_block_int8": gravnet_block.BM_INT8,
                          "gravnet_block": 16, "gravnet_aggregate": 4,
                          "knn_build": 4, "knn_aggregate": 4}[name]


def test_phase_split_needs_a_card():
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        phase_split.main(["--kernel", "gravnet_aggregate", "--bm", "32"])
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        phase_split.main(["--kernel", "knn_build"])
    with pytest.raises(SystemExit):
        phase_split.main(["--kernel", "flash_attention"])


def test_source_ab_options():
    """source_ab A/Bs the f32 GravNet pair by default; the dense and the
    edge kernel on request (against sources with their first C
    entries); it needs a card."""
    args = source_ab.parse_args(["--earlier", "build/parent"])
    assert args.kernels == ["gravnet_block", "gravnet_aggregate"]
    args = source_ab.parse_args(["--earlier", "d", "--kernels",
                                 "fused_dense", "edge_aggregate"])
    assert args.kernels == ["fused_dense", "edge_aggregate"]
    args = source_ab.parse_args(["--earlier", "d", "--kernels",
                                 "knn_build", "knn_aggregate"])
    assert args.kernels == ["knn_build", "knn_aggregate"]
    with pytest.raises(SystemExit):
        source_ab.parse_args(["--earlier", "d", "--kernels",
                              "flash_attention"])
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        source_ab.main(["--earlier", "build/parent"])
    assert set(source_ab.ARGTYPES) == set(source_ab.KERNELS)


@pytest.mark.parametrize("path,kernel", [
    (dict(design_point=3, precision="fp"), "gravnet_block"),
    (dict(design_point=1, precision="fp"), "gravnet_aggregate")])
def test_source_ab_chunks_are_the_paths(monkeypatch, path, kernel):
    """The chunks source_ab times the GravNet pair at are the deployed
    paths': the fp block's chunk launches 2 blocks over 2 events of
    (128, 64), design point 1's chunk 2 aggregations over 1 event."""
    from repro_torch.core.caloclusternet import CCNConfig
    from repro_torch.data.belle2 import Belle2Config, generate
    from repro_torch.launch import serve

    cfg = CCNConfig()
    pipe = serve.build_pipeline(cfg, Belle2Config(), device="cpu", **path)
    calls = []
    plain = getattr(tref, kernel + "_ref")
    monkeypatch.setattr(tref, kernel + "_ref", lambda *a, **kw: (
        calls.append(tuple(a[0].shape)), plain(*a, **kw))[1])
    ev = generate(Belle2Config(), pipe.microbatch, seed=1)
    pipe({"hits": ev["feats"], "mask": ev["mask"]})
    (_, chunk, count, bsz), = [s for s in source_ab.GRAVNET_SHAPES
                               if s[0] == kernel and s[2]]
    assert pipe.microbatch == bsz and len(calls) == count
    width = cfg.d_hidden if kernel == "gravnet_block" else cfg.d_s
    assert set(calls) == {(bsz, cfg.n_hits, width)}
