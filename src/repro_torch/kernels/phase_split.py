"""Where a CTA of a GravNet or kNN kernel spends its time, phase by
phase.

    python -m repro_torch.kernels.phase_split [--kernel NAME]
        [--source FILE.cu --bm N]

``--kernel`` is ``gravnet_block_int8`` (the default), ``gravnet_block``,
``gravnet_aggregate``, ``knn_build`` or ``knn_aggregate``. Builds a copy
of the kernel's source (by default ``csrc/<NAME>.cu``; ``--source``
takes another version of it, such as an earlier commit's, with the same
C entry point) in which thread 0 of every CTA of the kernel's
``__global__`` function reads ``clock64()`` at its start, after every
``__syncthreads()`` of its body and at its end, and runs it at the main
path's widths (128 hits, d_hidden 64, d_s 4, d_f 22, k 8, three
quarters of the hits valid; inputs from ``int8_cases.block_inputs`` for
the int8 block, ``f32_cases.block_inputs`` and ``aggregate_inputs`` for
the f32 pair) on the card at 2, 16 and 64 events (the aggregation: 1, 16
and 64, its unfused chunk being one event), the kNN pair at the ragged
path's 1, 8 and 16 bins of 128 rows of packed events
(``f32_cases.knn_path_bins``, s on a grid of 1/8; the aggregation on the
plain selection's (idx, d2)). Prints, per event count, the mean and
the largest time of each phase over the CTAs in microseconds at the SM
clock read right after the launches, the phase labelled by the first
comment line inside it, the device time of one launch of the stamped and
of the package's kernel (CUDA events around 200 back-to-back launches),
with the card's name and power limit. The whole report also goes to
``chiprun_out/phase_split/<source>.json``. ``--bm`` is the query rows
per CTA the source's wrapper chose (by default the package's: ``BM_INT8``
for the int8 block, ``gravnet_block.plan`` and ``gravnet.plan`` for the
f32 pair, ``knn_build.build_plan`` and ``aggregate_plan`` for the kNN
pair; 32 for every first design). Needs a card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import numpy as np

from repro_torch.kernels import _build, f32_cases, gravnet, gravnet_block, \
    int8_cases, knn_build

MAIN = dict(dh=64, ds=4, df=22, dout=64)
N_HITS, K = 128, 8
MAX_STAMPS = 16
_PRELUDE = (
    "__device__ long long* repro_phase_stamps;\n"
    'extern "C" int repro_set_phase_stamps(long long* p) {\n'
    "  return (int)cudaMemcpyToSymbol(repro_phase_stamps, &p, sizeof(p));\n"
    "}\n")


def _skip_comment(src: str, i: int) -> int:
    if src.startswith("//", i):
        return src.index("\n", i)
    if src.startswith("/*", i):
        return src.index("*/", i) + 1
    return i


def _kernel_body(src: str, name: str | None) -> tuple[int, int]:
    """Offsets of the opening and closing brace of the body of the
    ``__global__`` function ``name`` (the first one when None)."""
    pat = r"__global__" + ("" if name is None else
                           r"[^;{]*?\b" + re.escape(name) + r"\s*\(")
    m = re.search(pat, src)
    if m is None:
        raise ValueError(f"no __global__ function {name!r} in the source")
    i = m.start()
    depth, start = 0, None
    while True:
        i = _skip_comment(src, i)
        c = src[i]
        if c == "(":
            depth += 1
        elif c == ")":
            depth -= 1
        elif c == "{" and depth == 0:
            start = i
            break
        i += 1
    depth = 0
    while True:
        i = _skip_comment(src, i)
        if src[i] == "{":
            depth += 1
        elif src[i] == "}":
            depth -= 1
            if depth == 0:
                return start, i
        i += 1


def stamped_source(src: str, kernel: str | None = None
                   ) -> tuple[str, list[str]]:
    """The source with the stamps in the ``__global__`` function
    ``kernel`` (the first one when None), and each phase's label."""
    open_, close = _kernel_body(src, kernel)
    body = src[open_ + 1:close]
    parts = body.split("__syncthreads();")
    labels = []
    for part in parts:
        m = re.search(r"//\s*(.+)", part)
        code = [ln.strip() for ln in part.splitlines() if ln.strip()]
        labels.append(m.group(1).strip() if m else
                      code[0][:60] if code else "(empty)")
    stamp = "repro_st[repro_ns++] = clock64();"
    body = ("\n  long long repro_st[%d]; int repro_ns = 0;\n"
            "  __syncthreads(); %s" % (MAX_STAMPS, stamp)
            + ("__syncthreads(); " + stamp).join(parts)
            + "  __syncthreads(); " + stamp + "\n"
            "  if (threadIdx.x == 0) {\n"
            "    const int cta = blockIdx.y * gridDim.x + blockIdx.x;\n"
            "    for (int i = 0; i < repro_ns; ++i)\n"
            "      repro_phase_stamps[cta * %d + i] = repro_st[i];\n"
            "  }\n" % MAX_STAMPS)
    first_ns = src.index("\nnamespace") + 1
    out = (src[:first_ns] + _PRELUDE + src[first_ns:open_ + 1] + body
           + src[close:])
    return out, labels


def sleep_cycles_per_ms(torch, cycles: int = 20_000_000) -> float:
    """Cycles of ``torch.cuda._sleep`` per ms: a spin of ``cycles`` timed
    by CUDA events (read right after the launches it converts, while the
    clock is up)."""
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    torch.cuda._sleep(cycles)
    b.record()
    b.synchronize()
    return cycles / a.elapsed_time(b)


def device_ms(torch, fn, cycles_per_ms: float, reps: int = 200) -> float:
    """Device time of one call of ``fn``: a sleep kernel of about 1.5×
    the host's enqueue time holds the card while ``reps`` calls are
    enqueued, and CUDA events bracket their device work."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(int(cycles_per_ms * (1.5 * host_ms + 1.0)))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


@dataclass(frozen=True)
class Spec:
    """How phase_split builds, feeds and calls one kernel."""
    entry: str                        # C entry point
    kernel: str                       # its __global__ function
    argtypes: list
    events: tuple[int, ...]
    bm: Callable[[int], int]          # the package's rows per CTA at B
    inputs: Callable                  # B -> (numpy operands, keywords)
    #: each output's last dimension and dtype name, (B, N_HITS, width)
    outs: tuple[tuple[int, str], ...]
    #: (C entry, tensors, outputs, B, bm, stream, keywords) -> its
    #: return code
    call: Callable
    module: object                    # the wrapper's module
    package: str                      # the wrapper's name in it
    package_kw: tuple = (("k", K),)   # the wrapper's own keywords


def _block_args(fn, t, ys, bsz, bm, stream, kw):
    return fn(*(x.data_ptr() for x in t), ys[0].data_ptr(), bsz, N_HITS,
              MAIN["dh"], MAIN["ds"], MAIN["df"], MAIN["dout"], K, 10.0,
              *kw.values(), 1, bm, stream)


def _knn_build_inputs(bsz):
    s, seg = f32_cases.knn_build_inputs(f32_cases.knn_path_bins(bsz),
                                        N_HITS, MAIN["ds"], K, "grid", 0,
                                        seed=0)
    return (s, seg), {}


def _knn_aggregate_inputs(bsz):
    import torch

    from repro_torch.kernels import ref
    (s, seg), _ = _knn_build_inputs(bsz)
    idx, d2 = ref.knn_build_ref(torch.from_numpy(s), torch.from_numpy(seg),
                                k=K)
    f, idx = f32_cases.knn_aggregate_inputs(idx.numpy(), N_HITS,
                                            MAIN["df"], False, seed=0)
    return (f, idx, d2.numpy()), {}


SPECS = {
    "gravnet_block_int8": Spec(
        "gravnet_block_int8", "gravnet_block_int8_kernel",
        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [ctypes.c_float] * 4
        + [ctypes.c_int] * 2 + [ctypes.c_void_p], (2, 16, 64),
        lambda bsz: gravnet_block.BM_INT8,
        lambda bsz: int8_cases.block_inputs(bsz, N_HITS, **MAIN, seed=0,
                                            n_valid=N_HITS * 3 // 4),
        ((MAIN["dout"], "float32"),), _block_args, gravnet_block,
        "gravnet_block_int8_cuda"),
    "gravnet_block": Spec(
        "gravnet_block_f32", "gravnet_block_kernel",
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
        (2, 16, 64),
        lambda bsz: gravnet_block.plan(N_HITS, **MAIN)[0],
        lambda bsz: (f32_cases.block_inputs(bsz, N_HITS, **MAIN, seed=0,
                                            n_valid=N_HITS * 3 // 4), {}),
        ((MAIN["dout"], "float32"),), _block_args, gravnet_block,
        "gravnet_block_cuda"),
    "gravnet_aggregate": Spec(
        "gravnet_aggregate_f32", "gravnet_aggregate_kernel",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p], (1, 16, 64),
        lambda bsz: gravnet.plan(N_HITS, bsz, MAIN["df"])[0],
        lambda bsz: (f32_cases.aggregate_inputs(
            bsz, N_HITS, ds=MAIN["ds"], df=MAIN["df"], seed=0,
            n_valid=N_HITS * 3 // 4), {}),
        ((2 * MAIN["df"], "float32"),),
        lambda fn, t, ys, bsz, bm, stream, kw: fn(
            *(x.data_ptr() for x in t), ys[0].data_ptr(), bsz, N_HITS,
            MAIN["ds"], MAIN["df"], K, 10.0, bm, stream),
        gravnet, "gravnet_aggregate_cuda"),
    "knn_build": Spec(
        "knn_build_f32", "knn_build_kernel",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
        (1, 8, 16), lambda bsz: knn_build.build_plan(N_HITS, bsz)[0],
        _knn_build_inputs, ((K, "int32"), (K, "float32")),
        lambda fn, t, ys, bsz, bm, stream, kw: fn(
            *(x.data_ptr() for x in (*t, *ys)), bsz, N_HITS, MAIN["ds"], K,
            bm, stream),
        knn_build, "knn_build_cuda"),
    "knn_aggregate": Spec(
        "knn_aggregate_f32", "knn_aggregate_kernel",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p], (1, 8, 16),
        lambda bsz: knn_build.aggregate_plan(N_HITS, bsz, MAIN["df"])[0],
        _knn_aggregate_inputs, ((2 * MAIN["df"], "float32"),),
        lambda fn, t, ys, bsz, bm, stream, kw: fn(
            *(x.data_ptr() for x in t), ys[0].data_ptr(), bsz, N_HITS,
            MAIN["df"], K, 10.0, bm, stream),
        knn_build, "knn_aggregate_cuda", ()),
}


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=sorted(SPECS),
                    default="gravnet_block_int8")
    ap.add_argument("--source", type=Path,
                    help="default: csrc/<kernel>.cu")
    ap.add_argument("--bm", type=int,
                    help="query rows per CTA (default: the package's)")
    args = ap.parse_args(argv)
    spec = SPECS[args.kernel]
    source = args.source or _build.CSRC / f"{args.kernel}.cu"
    if not torch.cuda.is_available():
        raise SystemExit("phase_split needs a CUDA card")
    dev = torch.device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card)

    src, labels = stamped_source(source.read_text(), spec.kernel)
    out_dir = _build.BUILD_DIR.parents[1] / "chiprun_out" / "phase_split"
    out_dir.mkdir(parents=True, exist_ok=True)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = (source.stem + "_"
           + hashlib.sha256(source.read_bytes()).hexdigest()[:8])
    cu = _build.BUILD_DIR / f"stamped_{tag}.cu"
    cu.write_text(src)
    so = cu.with_suffix(".so")
    flags = _build.nvcc_flags(args.kernel)
    res = subprocess.run([_build._nvcc(), *flags, "-I",
                          str(source.resolve().parent), "-I",
                          str(_build.CSRC), "-o", str(so), str(cu)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"nvcc failed for the stamped {source}:\n"
                         f"{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(str(so))
    fn = getattr(lib, spec.entry)
    fn.argtypes = spec.argtypes
    fn.restype = ctypes.c_int
    lib.repro_set_phase_stamps.argtypes = [ctypes.c_void_p]
    package = getattr(spec.module, spec.package)
    package_kw = dict(spec.package_kw)

    report = {"card": card, "kernel": args.kernel, "source": str(source),
              "labels": labels, "runs": []}
    print(f"kernel {args.kernel}, source {source}")
    for bsz in spec.events:
        bm = args.bm or spec.bm(bsz)
        ops, kw = spec.inputs(bsz)
        t = [torch.from_numpy(np.ascontiguousarray(o)).to(dev) for o in ops]
        ys = [torch.empty((bsz, N_HITS, w), dtype=getattr(torch, dt),
                          device=dev) for w, dt in spec.outs]
        ctas = -(-N_HITS // bm) * bsz
        stamps = torch.zeros(ctas * MAX_STAMPS, dtype=torch.int64,
                             device=dev)
        _build.check(lib.repro_set_phase_stamps(stamps.data_ptr()),
                     "repro_set_phase_stamps")

        def call():
            return spec.call(fn, t, ys, bsz, bm,
                             torch.cuda.current_stream().cuda_stream, kw)

        cycles_per_ms = sleep_cycles_per_ms(torch, 100_000_000)
        stamped_ms = device_ms(torch, call, cycles_per_ms)
        package_ms = device_ms(torch, lambda: package(*t, **kw,
                                                      **package_kw),
                               cycles_per_ms)
        _build.check(call(), f"stamped {args.kernel}")
        torch.cuda.synchronize()
        cycles_per_ms = sleep_cycles_per_ms(torch, 100_000_000)
        st = stamps.view(ctas, MAX_STAMPS)[:, :len(labels) + 1]
        us = np.diff(st.cpu().numpy().astype(np.float64), axis=1) / (
            cycles_per_ms / 1e3)
        want = package(*t, **kw, **package_kw)
        want = want if isinstance(want, tuple) else (want,)
        same = all(bool(torch.equal(w, y)) for w, y in zip(want, ys,
                                                           strict=True))
        run = {"events": bsz, "bm": bm, "ctas": ctas,
               "same_as_package": same, "sm_mhz": cycles_per_ms / 1e3,
               "phase_us_mean": us.mean(axis=0).tolist(),
               "phase_us_max": us.max(axis=0).tolist(),
               "cta_us_mean": float(us.sum(axis=1).mean()),
               "stamped_ms": stamped_ms, "package_ms": package_ms}
        report["runs"].append(run)
        print(f"events {bsz}: bm {bm}, {ctas} CTAs, SM clock "
              f"{run['sm_mhz']:.1f} MHz, a CTA {run['cta_us_mean']:.3f} us, "
              f"stamped launch {stamped_ms:.5f} ms, package kernel "
              f"{package_ms:.5f} ms, outputs equal: {same}")
        for lab, mean, mx in zip(labels, run["phase_us_mean"],
                                 run["phase_us_max"]):
            print(f"  {mean:9.3f} us (max {mx:9.3f})  {lab}")
    (out_dir / f"{tag}.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
