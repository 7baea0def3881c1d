"""Device time of the port's f32 kernels against an earlier revision of
their sources, in one call.

    python -m repro_torch.kernels.source_ab --earlier DIR [--kernels ...]

``DIR`` holds the earlier sources of the kernels named by ``--kernels``
(by default ``gravnet_block`` and ``gravnet_aggregate``), for example an
earlier commit's ``src/repro_torch/kernels/csrc`` unpacked with ``git
archive`` under ``build/``. Their C entries are the first designs':
``gravnet_block_f32(x, mask, ws, bs, wf, bf, wo, bo, y, B, n, dh, ds,
df, dout, k, scale, act, bm, stream)`` and ``gravnet_aggregate_f32(s, f,
mask, out, B, n, ds, df, k, scale, bm, stream)``, and the kNN pair's
``knn_build_f32(s, seg, idx, d2, B, n, ds, k, bm, stream)`` and
``knn_aggregate_f32(f, idx, d2, out, B, n, df, k, scale, bm, stream)``,
launched at bm = 32 query rows per CTA (the sources before the register
cell); ``fused_dense_f32(x, w, b, y, M, K, N, act, stream)`` over a
contiguous x and ``edge_aggregate_f32(msg, dst, mask, out, B, E, n, d,
bm, mean, stream)`` at bm = 8 (the sources before the tile plan). Each
is built with this checkout's flags. Then, at every launch shape of its
paths — a CaloClusterNet fp chunk (2 events, 2 blocks) and unfused chunk
(1 event, 2 aggregations) and 16 and 64 events for the GravNet pair
(:data:`GRAVNET_SHAPES`, inputs from ``kernels/f32_cases.py``); a launch
of the ragged executable (8 bins of packed events, 2 launches of each)
and 1 and 16 bins for the kNN pair (:data:`KNN_SHAPES`,
``f32_cases.knn_path_bins``); a GatedGCN 16 × 70, a GraphSAGE 2 × 128
and a CaloClusterNet fp chunk for the dense and the edge kernel
(:data:`DENSE_SHAPES`, :data:`EDGE_SHAPES`) — each kernel is held
against its plain version bitwise (every output) and timed in turns,
earlier, current, current, earlier (CUDA
events around 200 back-to-back launches behind a sleep kernel, as
``chip_smoke.py`` times). Where the executor now hands the dense a
row-strided own-K view of a lane-padded input, the earlier kernel gets
what its executor gave it: the padded input, contiguous, and w padded
with zero rows. Prints a line per shape and the sums per chunk with the
card's name and power limit; the report also goes to ``--out``
(``chiprun_out/source_ab.json`` by default). Needs a card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

from repro_torch.kernels.phase_split import device_ms, sleep_cycles_per_ms

#: (chunk, launches per chunk, M, own K, N, lane-padded K or None): the
#: denses of a chunk, as chip_smoke.py records them (all timed with relu)
DENSE_SHAPES = (
    ("gatedgcn", 31, 256, 70, 70, 128),
    ("gatedgcn", 16, 256, 70, 140, 128),
    ("gatedgcn", 15, 64, 70, 70, 128),
    ("gatedgcn", 1, 64, 8, 70, None),
    ("gatedgcn", 1, 256, 4, 70, None),
    ("gatedgcn", 1, 256, 70, 70, None),
    ("gatedgcn", 1, 64, 70, 70, None),
    ("gatedgcn", 1, 64, 70, 2, 128),
    ("graphsage", 1, 512, 32, 128, 128),
    ("graphsage", 1, 512, 256, 128, None),
    ("graphsage", 1, 512, 128, 5, None),
    ("ccn_fp", 1, 256, 4, 64, None),
    ("ccn_fp", 2, 256, 64, 64, None),
    ("ccn_fp", 1, 256, 64, 32, None),
    ("ccn_fp", 1, 256, 32, 7, None),
)
#: (chunk, launches per chunk, graphs, E, d, reduce) on graphs of 64
#: nodes
EDGE_SHAPES = (
    ("gatedgcn", 32, 1, 256, 70, "sum"),
    ("graphsage", 1, 8, 256, 16, "mean"),
    ("graphsage", 1, 8, 256, 128, "mean"),
)
NODES = 64
EARLIER_BM = 8
#: (kernel, chunk, launches per chunk, events): the GravNet pair at the
#: CaloClusterNet fp chunk (2 blocks over 2 events), the unfused chunk (2
#: aggregations over 1 event) and, outside any chunk, 16 and 64 events
GRAVNET_SHAPES = (
    ("gravnet_block", "ccn_fp", 2, 2),
    ("gravnet_block", "16 events", 0, 16),
    ("gravnet_block", "64 events", 0, 64),
    ("gravnet_aggregate", "ccn_unfused", 2, 1),
    ("gravnet_aggregate", "16 events", 0, 16),
    ("gravnet_aggregate", "64 events", 0, 64),
)
#: query rows per CTA of the GravNet pair's and the kNN pair's first
#: designs
EARLIER_GRAVNET_BM = 32
#: (kernel, chunk, launches per chunk, bins): the kNN pair at a launch of
#: the ragged executable (8 bins of 128 rows, 2 launches of each) and,
#: outside any launch, 1 and 16 bins
KNN_SHAPES = (
    ("knn_build", "ragged launch", 2, 8),
    ("knn_build", "1 bin", 0, 1),
    ("knn_build", "16 bins", 0, 16),
    ("knn_aggregate", "ragged launch", 2, 8),
    ("knn_aggregate", "1 bin", 0, 1),
    ("knn_aggregate", "16 bins", 0, 16),
)
KERNELS = ("fused_dense", "edge_aggregate", "gravnet_block",
           "gravnet_aggregate", "knn_build", "knn_aggregate")
#: each earlier C entry's argument types
ARGTYPES = {
    "fused_dense": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
    + [ctypes.c_void_p],
    "edge_aggregate": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
    + [ctypes.c_void_p],
    "gravnet_block": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "gravnet_aggregate": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    "knn_build": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
    + [ctypes.c_void_p],
    "knn_aggregate": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--earlier", type=Path, required=True,
                    help="directory of the earlier sources")
    ap.add_argument("--kernels", nargs="+", choices=KERNELS,
                    default=["gravnet_block", "gravnet_aggregate"])
    ap.add_argument("--out", type=Path,
                    help="the report (default chiprun_out/source_ab.json)")
    return ap.parse_args(argv)


def _build_earlier(src: Path, name: str) -> ctypes.CDLL:
    from repro_torch.kernels import _build
    so = _build.BUILD_DIR / f"lib{name}-earlier.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    res = subprocess.run([_build._nvcc(), *_build.nvcc_flags(name), "-o",
                          str(so), str(src)], capture_output=True,
                         text=True)
    if res.returncode != 0:
        raise SystemExit(f"nvcc failed for {src}:\n{res.stdout}"
                         f"{res.stderr}")
    return ctypes.CDLL(str(so))


def main(argv=None) -> int:
    import torch

    from repro_torch.core.caloclusternet import CCNConfig
    from repro_torch.kernels import f32_cases, ref
    from repro_torch.kernels.edge_aggregate import edge_aggregate_cuda
    from repro_torch.kernels.fused_dense import act_code, fused_dense_cuda
    from repro_torch.kernels.gravnet import gravnet_aggregate_cuda
    from repro_torch.kernels.gravnet_block import gravnet_block_cuda
    from repro_torch.kernels.knn_build import (knn_aggregate_cuda,
                                               knn_build_cuda)

    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("source_ab needs a CUDA card")
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card)
    old = {}
    for name in args.kernels:
        entry = name + "_f32"
        old[name] = getattr(_build_earlier(args.earlier / f"{name}.cu",
                                           name), entry)
        old[name].argtypes = ARGTYPES[name]

    cycles_per_ms = sleep_cycles_per_ms(torch)

    def turns(earlier, current):
        """Earlier, current, current, earlier; the mean of each pair."""
        t = [device_ms(torch, fn, cycles_per_ms)
             for fn in (earlier, current, current, earlier)]
        return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2

    def stream():
        return torch.cuda.current_stream().cuda_stream

    gen = torch.Generator().manual_seed(0)
    rows, sums = [], {}
    dense_shapes = DENSE_SHAPES if "fused_dense" in old else ()
    edge_shapes = EDGE_SHAPES if "edge_aggregate" in old else ()
    for chunk, count, m, k, n, kpad in dense_shapes:
        kin = kpad or k
        xp = torch.zeros(m, kin)
        xp[:, :k] = torch.randn(m, k, generator=gen)
        xp = xp.to(dev)
        w = (torch.randn(k, n, generator=gen) / k ** 0.5).to(dev)
        bias = torch.randn(n, generator=gen).to(dev)
        wp = torch.cat([w, torch.zeros(kin - k, n, device=dev)])
        x = xp[:, :k]

        def earlier(xp=xp, wp=wp, bias=bias, m=m, kin=kin, n=n):
            y = torch.empty(m, n, device=dev)
            old["fused_dense"](xp.data_ptr(), wp.data_ptr(),
                               bias.data_ptr(), y.data_ptr(), m, kin, n,
                               act_code("relu"), stream())
            return y

        def current(x=x, w=w, bias=bias):
            return fused_dense_cuda(x, w, bias)

        for fn, want in ((earlier, ref.fused_dense_ref(xp, wp, bias)),
                         (current, ref.fused_dense_ref(x, w, bias))):
            if not bool((fn() == want).all()):
                raise SystemExit(f"dense ({m},{k})->{n}: not bitwise equal "
                                 "to its plain version")
        t_old, t_new = turns(earlier, current)
        rows.append({"kernel": "fused_dense", "chunk": chunk,
                     "count": count, "shape": f"({m},{k})->{n}"
                     + (f" of {kpad}" if kpad else ""),
                     "earlier_ms": t_old, "current_ms": t_new})
    for chunk, count, bsz, e, d, reduce in edge_shapes:
        msg = torch.randn(bsz, e, d, generator=gen).to(dev)
        dst = torch.randint(0, NODES, (bsz, e), generator=gen,
                            dtype=torch.int32).to(dev)
        mask = (torch.rand(bsz, e, generator=gen) < 0.9).float().to(dev)
        mean = reduce == "mean"

        def earlier(msg=msg, dst=dst, mask=mask, bsz=bsz, e=e, d=d,
                    mean=mean):
            out = torch.empty(bsz, NODES, d, device=dev)
            old["edge_aggregate"](msg.data_ptr(), dst.data_ptr(),
                                  mask.data_ptr(), out.data_ptr(), bsz, e,
                                  NODES, d, EARLIER_BM, int(mean), stream())
            return out

        def current(msg=msg, dst=dst, mask=mask, reduce=reduce):
            return edge_aggregate_cuda(msg, dst, mask, n_nodes=NODES,
                                       reduce=reduce)

        want = ref.edge_aggregate_ref(msg, dst, mask, n_nodes=NODES,
                                      reduce=reduce)
        for fn in (earlier, current):
            if not bool((fn() == want).all()):
                raise SystemExit(f"edge ({bsz},{e},{d}) {reduce}: not "
                                 "bitwise equal to its plain version")
        t_old, t_new = turns(earlier, current)
        rows.append({"kernel": "edge_aggregate", "chunk": chunk,
                     "count": count, "shape": f"({bsz},{e},{d}) {reduce}",
                     "earlier_ms": t_old, "current_ms": t_new})
    cfg = CCNConfig()
    widths = dict(dh=cfg.d_hidden, ds=cfg.d_s, df=cfg.d_flr,
                  dout=cfg.d_hidden)
    n, kk = cfg.n_hits, cfg.k
    for kernel, chunk, count, bsz in GRAVNET_SHAPES:
        if kernel not in old:
            continue
        fn = old[kernel]
        if kernel == "gravnet_block":
            ops = [torch.from_numpy(a).to(dev)
                   for a in f32_cases.block_inputs(
                       bsz, n, **widths, seed=bsz, n_valid=n * 3 // 4)]
            want = ref.gravnet_block_ref(*ops, k=kk)

            def earlier(ops=ops, bsz=bsz, fn=fn):
                y = torch.empty(bsz, n, widths["dout"], device=dev)
                fn(*(t.data_ptr() for t in ops), y.data_ptr(), bsz, n,
                   *widths.values(), kk, 10.0, act_code("relu"),
                   EARLIER_GRAVNET_BM, stream())
                return y

            def current(ops=ops):
                return gravnet_block_cuda(*ops, k=kk)
            shape = f"x({bsz},{n},{widths['dh']})"
        else:
            ops = [torch.from_numpy(a).to(dev)
                   for a in f32_cases.aggregate_inputs(
                       bsz, n, ds=widths["ds"], df=widths["df"], seed=bsz,
                       n_valid=n * 3 // 4)]
            want = ref.gravnet_aggregate_ref(*ops, k=kk)

            def earlier(ops=ops, bsz=bsz, fn=fn):
                y = torch.empty(bsz, n, 2 * widths["df"], device=dev)
                fn(*(t.data_ptr() for t in ops), y.data_ptr(), bsz, n,
                   widths["ds"], widths["df"], kk, 10.0, EARLIER_GRAVNET_BM,
                   stream())
                return y

            def current(ops=ops):
                return gravnet_aggregate_cuda(*ops, k=kk)
            shape = f"s({bsz},{n},{widths['ds']}) f(.., {widths['df']})"
        for f_ in (earlier, current):
            if not bool((f_() == want).all()):
                raise SystemExit(f"{kernel} {shape}: not bitwise equal to "
                                 "its plain version")
        t_old, t_new = turns(earlier, current)
        rows.append({"kernel": kernel, "chunk": chunk, "count": count,
                     "shape": shape, "earlier_ms": t_old,
                     "current_ms": t_new})

    def equal(got, want):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        return all(bool(torch.equal(g, w)) for g, w in zip(got, want,
                                                           strict=True))

    ds, df = widths["ds"], widths["df"]
    for kernel, chunk, count, bsz in KNN_SHAPES:
        if kernel not in old:
            continue
        fn = old[kernel]
        s_, seg = (torch.from_numpy(a).to(dev)
                   for a in f32_cases.knn_build_inputs(
                       f32_cases.knn_path_bins(bsz), n, ds, kk, "grid", 0,
                       seed=bsz))
        if kernel == "knn_build":
            want = ref.knn_build_ref(s_, seg, k=kk)

            def earlier(s_=s_, seg=seg, bsz=bsz, fn=fn):
                idx = torch.empty(bsz, n, kk, dtype=torch.int32, device=dev)
                d2 = torch.empty(bsz, n, kk, device=dev)
                fn(s_.data_ptr(), seg.data_ptr(), idx.data_ptr(),
                   d2.data_ptr(), bsz, n, ds, kk, EARLIER_GRAVNET_BM,
                   stream())
                return idx, d2

            def current(s_=s_, seg=seg):
                return knn_build_cuda(s_, seg, k=kk)
            shape = f"s({bsz},{n},{ds}) k={kk}"
        else:
            idx, d2 = ref.knn_build_ref(s_, seg, k=kk)
            f = torch.from_numpy(f32_cases.knn_aggregate_inputs(
                idx.cpu().numpy(), n, df, False, seed=bsz)[0]).to(dev)
            want = ref.knn_aggregate_ref(f, idx, d2)

            def earlier(f=f, idx=idx, d2=d2, bsz=bsz, fn=fn):
                y = torch.empty(bsz, n, 2 * df, device=dev)
                fn(f.data_ptr(), idx.data_ptr(), d2.data_ptr(), y.data_ptr(),
                   bsz, n, df, kk, 10.0, EARLIER_GRAVNET_BM, stream())
                return y

            def current(f=f, idx=idx, d2=d2):
                return knn_aggregate_cuda(f, idx, d2)
            shape = f"f({bsz},{n},{df}) k={kk}"
        for f_ in (earlier, current):
            if not equal(f_(), want):
                raise SystemExit(f"{kernel} {shape}: not bitwise equal to "
                                 "its plain version")
        t_old, t_new = turns(earlier, current)
        rows.append({"kernel": kernel, "chunk": chunk, "count": count,
                     "shape": shape, "earlier_ms": t_old,
                     "current_ms": t_new})
    for r in rows:
        print(f"{r['kernel']} [{r['chunk']}] {r['shape']} x{r['count']}: "
              f"earlier {r['earlier_ms']:.5f} ms, current "
              f"{r['current_ms']:.5f} ms")
        if not r["count"]:
            continue
        key = (r["chunk"], r["kernel"])
        s = sums.setdefault(key, [0, 0.0, 0.0])
        s[0] += r["count"]
        s[1] += r["count"] * r["earlier_ms"]
        s[2] += r["count"] * r["current_ms"]
    for (chunk, kernel), (cnt, t_old, t_new) in sums.items():
        print(f"per {chunk} chunk, {kernel} ({cnt} launches): earlier "
              f"{t_old:.5f} ms, current {t_new:.5f} ms ({card})")
    out = args.out or (Path(__file__).resolve().parents[3] / "chiprun_out"
                       / "source_ab.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(
        {"card": card, "earlier": str(args.earlier), "rows": rows,
         "per_chunk": [{"chunk": c, "kernel": k, "launches": cnt,
                        "earlier_ms": o, "current_ms": w_}
                       for (c, k), (cnt, o, w_) in sums.items()]},
        indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
