"""The design flow's H100 model against the card: its measured constants,
the launches each op costs, and the modelled time of a chunk against the
chunk's device time.

    python -m repro_torch.launch.h100_model [--out FILE]

Needs a card (it fails without one). Every time below is the profiler's
busy time: the durations of the device records of a window summed, as
``chip_smoke.py`` phase 9 reads a chunk's (``torch.profiler`` over
CUPTI; the gaps between kernels are not counted). It measures:

- ``launch_s``: the busy time of one small plain kernel inside a
  captured CUDA graph (``LAUNCH_OPS`` elementwise ops of CPS's kind on
  (2, 128) tensors, ``LAUNCH_REPS`` times over, in one graph);
- ``kernel_launch_s``: the busy time of one hand-kernel launch at the
  served paths' smallest shapes inside a captured graph (the f32 and
  int8 denses of a head at one event, (128, 32) -> 7);
- ``plain_flops``: the f32 elements a second of plain elementwise ops
  (add, mul, where, sigmoid) on ``PLAIN_ELEMENTS`` elements inside a
  captured graph;
- per served path (the mixed default, fp, the ragged path, GatedGCN 16 x
  70, GraphSAGE 2 x 128) the kernels each op of one eager chunk
  launches, each op in a profiler range of its own that ends in a
  synchronization, against ``op_registry.op_launches``;
- the mixed default and fp at P = 1 to 64, GatedGCN 16 x 70 at P = 1 to
  16: the busy ms of one replay of the captured chunk against the
  model's seconds a step (``parallelize.model_step`` at P), and their
  ratio.

It prints the card's name and power limit as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` gives them, then
one JSON object as its last line (also written to ``--out``).
``launch/mesh.py``'s ``H100_LAUNCH_S``, ``H100_KERNEL_LAUNCH_S`` and
``H100_PLAIN_FLOPS`` and ``op_registry``'s launch counts are this
script's readings. ``chip_smoke.py`` phase 19 calls :func:`sweep`.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

LAUNCH_OPS = 8
LAUNCH_REPS = 64
PLAIN_ELEMENTS = 1 << 24
#: the P of the sweep, by path
SWEEP_P = {"mixed": (1, 2, 4, 8, 16, 32, 64), "fp": (1, 2, 4, 8, 16, 32, 64),
           "gatedgcn": (1, 2, 4, 8, 16)}
#: replays a chunk's busy time is read over
REPLAYS = 10


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        raise RuntimeError(f"nvidia-smi: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def _device_records(prof):
    """The device records of a profile (kernels, copies, fills), the
    step annotations left out."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and not (
                getattr(e, "is_user_annotation", False)
                or e.name.startswith("ProfilerStep"))]


def busy(fn, *, calls: int = 1) -> tuple[float, int]:
    """(busy seconds, device records) of ``calls`` calls of ``fn`` under
    the profiler, after one call outside it."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    recs = _device_records(prof)
    return sum(e.time_range.elapsed_us() for e in recs) * 1e-6, len(recs)


def capture(fn):
    """``fn`` captured into one CUDA graph (warmed on a side stream
    first); returns the graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


def launch_cost(dev) -> float:
    """Busy seconds of one small plain kernel inside a captured graph."""
    a = torch.rand(2, 128, device=dev)
    b = torch.rand(2, 128, device=dev)
    m = a > 0.5
    idx = torch.zeros_like(a, dtype=torch.long)

    def chain():
        for _ in range(LAUNCH_REPS):
            x = a * b
            x = x + a
            x = torch.where(m, x, b)
            x = torch.sigmoid(x)
            y = x > 0.25
            y = y & m
            z = x.sum(dim=1)
            torch.gather(x, 1, idx)
            del y, z
    graph = capture(chain)
    seconds, n = busy(graph.replay, calls=REPLAYS)
    want = LAUNCH_OPS * LAUNCH_REPS * REPLAYS
    if n < want:
        raise RuntimeError(f"launch cost: {n} device records, expected at "
                           f"least {want}")
    return seconds / n


def kernel_launch_cost(dev) -> float:
    """Busy seconds of one hand-kernel launch at a head's shape at one
    event, (128, 32) -> 7, f32 and int8, inside a captured graph."""
    from repro_torch.kernels import ops
    g = torch.Generator(device="cpu").manual_seed(0)
    x = torch.randn(128, 32, generator=g).to(dev)
    w = torch.randn(32, 7, generator=g).to(dev)
    b = torch.randn(7, generator=g).to(dev)
    xq = torch.randint(-127, 128, (128, 32), generator=g,
                       dtype=torch.int8).to(dev)
    wq = torch.randint(-127, 128, (32, 7), generator=g,
                       dtype=torch.int8).to(dev)
    ws = torch.full((7,), 0.01, device=dev)

    def chain():
        for _ in range(LAUNCH_REPS):
            ops.fused_dense(x, w, b, activation="none")
            ops.fused_dense_int8(xq, wq, b, 0.02, ws, activation="none")
    graph = capture(chain)
    seconds, n = busy(graph.replay, calls=REPLAYS)
    if n != 2 * LAUNCH_REPS * REPLAYS:
        raise RuntimeError(f"kernel launch cost: {n} device records, "
                           f"expected {2 * LAUNCH_REPS * REPLAYS}")
    return seconds / n


def plain_rate(dev) -> float:
    """f32 elements a second of plain elementwise ops on large tensors,
    inside a captured graph (one element = one counted operation)."""
    a = torch.rand(PLAIN_ELEMENTS, device=dev)
    b = torch.rand(PLAIN_ELEMENTS, device=dev)
    m = a > 0.5
    out = torch.empty_like(a)

    def chain():
        torch.add(a, b, out=out)
        torch.mul(out, b, out=out)
        torch.where(m, out, a, out=out)
        torch.sigmoid(out, out=out)
    graph = capture(chain)
    seconds, _ = busy(graph.replay, calls=REPLAYS)
    return 4 * PLAIN_ELEMENTS * REPLAYS / seconds


def op_key(op) -> str:
    """The name an op's launch count is reported under: its type, an
    eltwise's function and operand count, a dense's precision."""
    key = op.op_type
    if op.op_type == "eltwise":
        key += f"/{op.attrs['fn']}/{len(op.inputs)}"
    elif op.op_type in ("dense", "linear"):
        key += f"/{op.precision}"
    elif op.op_type == "retile":
        key += f"/{op.attrs.get('to')}"
    elif op.op_type == "gravnet_block" and op.attrs.get("ragged"):
        key += "/ragged"
    return key


def op_launch_counts(pipe, chunk) -> dict:
    """{op key: [counted kernels per call, modelled]} over one eager
    chunk of ``pipe`` on ``chunk`` (device tensors): each op in a
    profiler range of its own that ends in a synchronization, its
    device records those that start and end inside the range."""
    from repro_torch.core.op_registry import op_launches
    ex = pipe._ex
    run_op = ex.run_op
    spans = []

    def ranged(op, vals, feeds, **kw):
        with torch.profiler.record_function(f"h100_model:{op.name}"):
            out = run_op(op, vals, feeds, **kw)
            torch.cuda.synchronize()
        spans.append(op)
        return out
    pipe.run_chunk(chunk)
    torch.cuda.synchronize()
    ex.run_op = ranged
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    try:
        with torch.profiler.profile(activities=acts) as prof:
            pipe.run_chunk(chunk)
            torch.cuda.synchronize()
    finally:
        ex.run_op = run_op
    ranges = {e.name[len("h100_model:"):]: e.time_range
              for e in prof.events() if e.name.startswith("h100_model:")}
    recs = _device_records(prof)
    counts: dict[str, list] = {}
    for op in spans:
        r = ranges[op.name]
        n = sum(r.start <= e.time_range.start and e.time_range.end <= r.end
                for e in recs)
        key = op_key(op)
        counts.setdefault(key, [set(), set()])
        counts[key][0].add(n)
        counts[key][1].add(op_launches(op, pipe.graph))
    return {k: [sorted(v[0]), sorted(v[1])] for k, v in counts.items()}


def chunk_busy_s(pipe, feeds) -> float:
    """Busy seconds of one replay of ``pipe``'s captured chunk on
    ``feeds`` (one chunk's events, on the card): the chunk is captured
    by a first call, then its graphs replayed ``REPLAYS`` times under the
    profiler."""
    pipe(feeds)
    cap = next(iter(pipe._graphs._by_sig.values()))

    def replay():
        for g in cap.graphs:
            g.replay()
    seconds, _ = busy(replay, calls=REPLAYS)
    return seconds / REPLAYS


def modelled_s(pipe, p: int | None = None) -> float:
    """The model's seconds a step of ``pipe`` on its platform: at its
    own (P_mxu, P_xla), or at ``p`` for both."""
    from repro_torch.core.passes.parallelize import model_step
    par = pipe.graph.meta["parallelization"]
    pm, px = (p, p) if p else (par["P_mxu"], par["P_xla"])
    return model_step(pipe.graph, pipe.req, pm, px)[1]


def at_p(make, p: int):
    """``make(req_changes, batch)`` deployed at a fixed P on "h100":
    batch-packed at ``p`` events (every segment runs the whole chunk),
    or P = 1 by the search's bound."""
    if p == 1:
        return make({"platform": "h100", "max_p": 1}, 1)
    return make({"platform": "h100"}, p)


def sweep(paths: dict, dev) -> list[dict]:
    """For each path ``name -> (make, events)``, with ``make(req_changes,
    batch) -> pipe`` and ``events(n) -> feeds``, and each P of
    ``SWEEP_P[name]``: the modelled and the measured ms of one chunk and
    their ratio (modelled over measured)."""
    rows = []
    for name, (make, events) in paths.items():
        for p in SWEEP_P[name]:
            pipe = at_p(make, p)
            feeds = {k: torch.as_tensor(np.asarray(v)).to(dev)
                     for k, v in events(p).items()}
            model = modelled_s(pipe, p)
            meas = chunk_busy_s(pipe, feeds)
            rows.append({"path": name, "P": p, "model_ms": model * 1e3,
                         "measured_ms": meas * 1e3, "ratio": model / meas})
            del pipe
    return rows


def served_paths(dev, params=None):
    """The sweep's paths: the mixed default (``params``, else seed-0
    weights), fp and GatedGCN 16 x 70, each as ``(make, events)``."""
    from repro_torch.core import caloclusternet as ccn
    from repro_torch.core.graph_ir import export_graph
    from repro_torch.core.pipeline import Requirements, deploy
    from repro_torch.data.belle2 import Belle2Config, generate
    from repro_torch.launch import serve
    from repro_torch.models.gnn import gatedgcn
    cfg, gen = ccn.CCNConfig(), Belle2Config()
    if params is None:
        params = ccn.init(torch.Generator().manual_seed(0), cfg)
    graph = export_graph("caloclusternet", params, cfg)
    calib = serve.calibration_feeds(gen)

    def ccn_make(prec):
        def make(changes, batch):
            req = Requirements(design_point=3, precision_policy=prec,
                               n_hits=cfg.n_hits,
                               target_throughput=serve.TARGET_THROUGHPUT,
                               max_latency_s=2e-3, **changes)
            return deploy(graph, req, calibration_feeds=calib, batch=batch,
                          device=dev)
        return make

    def ccn_events(n):
        ev = generate(gen, n, seed=7)
        return {"hits": ev["feats"], "mask": ev["mask"]}

    gcfg = gatedgcn.GatedGCNConfig(n_layers=16, d_hidden=70, d_in=8,
                                   d_edge_in=4, n_classes=2)
    gparams = gatedgcn.init(torch.Generator().manual_seed(1), gcfg)
    ggraph = export_graph("gatedgcn", gparams, gcfg)
    args = serve.parse_args(["--device", dev.type])

    def gnn_make(changes, batch):
        req = dataclasses.replace(serve._edge_req(args), **changes)
        return deploy(ggraph, req, batch=batch, device=dev)

    gnn_events = serve._edge_events(gcfg.d_in, gcfg.d_edge_in)
    return {"mixed": (ccn_make("mixed"), ccn_events),
            "fp": (ccn_make("fp"), ccn_events),
            "gatedgcn": (gnn_make, lambda n: gnn_events(n, 7)[0])}


def design_points(dev, params=None) -> list[dict]:
    """The model's P, events/s and latency at design points 1-3 of the
    mixed default under the paper's targets (3e6 events/s, 10 µs), as
    the reference's design-point bench reports its "tpu-model" rows."""
    from repro_torch.core import caloclusternet as ccn
    from repro_torch.core.graph_ir import export_graph
    from repro_torch.core.pipeline import Requirements, deploy
    from repro_torch.data.belle2 import Belle2Config
    from repro_torch.launch import serve
    cfg, gen = ccn.CCNConfig(), Belle2Config()
    if params is None:
        params = ccn.init(torch.Generator().manual_seed(0), cfg)
    graph = export_graph("caloclusternet", params, cfg)
    rows = []
    for dp in (1, 2, 3):
        req = Requirements(design_point=dp, platform="h100",
                           precision_policy="mixed", n_hits=cfg.n_hits,
                           target_throughput=3e6, max_latency_s=10e-6)
        pipe = deploy(graph, req, calibration_feeds=serve.calibration_feeds(
            gen), device=dev)
        par = pipe.graph.meta["parallelization"]
        rows.append({"design_point": dp, "P_mxu": par["P_mxu"],
                     "P_xla": par["P_xla"],
                     "model_events_s": pipe.model_throughput(),
                     "model_latency_us": pipe.model_latency() * 1e6})
    return rows


def launch_table(dev) -> dict:
    """Per served path, :func:`op_launch_counts` over one chunk."""
    from repro_torch.core import caloclusternet as ccn
    from repro_torch.data.belle2 import Belle2Config, generate
    from repro_torch.launch import serve
    from repro_torch.models.gnn import gatedgcn, graphsage
    cfg, gen = ccn.CCNConfig(), Belle2Config()
    args = serve.parse_args(["--device", dev.type])
    pipes = {
        "mixed": serve.build_pipeline(cfg, gen, device=dev),
        "fp": serve.build_pipeline(cfg, gen, precision="fp", device=dev),
        "ragged": serve.build_pipeline(cfg, gen, precision="fp",
                                       ragged=True, batch=8, device=dev),
        "gatedgcn": serve.MODELS["gatedgcn"](args, gatedgcn.GatedGCNConfig(
            n_layers=16, d_hidden=70, d_in=8, d_edge_in=4,
            n_classes=2)),
        "graphsage": serve.MODELS["graphsage"](
            args, graphsage.GraphSAGEConfig(n_layers=2, d_hidden=128,
                                            d_in=16, n_classes=5)),
    }
    out = {}
    for name, p in pipes.items():
        if name in ("gatedgcn", "graphsage"):
            feeds, _ = p.events(p.pipe.microbatch, 7)
            pipe = p.pipe
        elif name == "ragged":
            ev = generate(gen, 16, seed=7)
            one = []
            p._launch({"hits": ev["feats"], "mask": ev["mask"]},
                      lambda f: one.append(f) or p.pipe(f))
            pipe, feeds = p.pipe, one[0]
        else:
            ev = generate(gen, p.microbatch, seed=7)
            pipe, feeds = p, {"hits": ev["feats"], "mask": ev["mask"]}
        chunk = {k: torch.as_tensor(np.asarray(v)).to(dev)
                 for k, v in feeds.items()}
        out[name] = op_launch_counts(pipe, chunk)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("h100_model: no CUDA device; the model's constants are "
              "measured on the card only", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    from repro_torch.kernels import _build
    _build.build_all()      # every source at once, not one at first use
    name = card()
    print(name, flush=True)
    props = torch.cuda.get_device_properties(dev)
    report = {"card": name, "sms": props.multi_processor_count,
              "l2_bytes": getattr(props, "L2_cache_size", None),
              "launch_s": launch_cost(dev),
              "kernel_launch_s": kernel_launch_cost(dev),
              "plain_flops": plain_rate(dev),
              "op_launches": launch_table(dev)}
    print(json.dumps({k: v for k, v in report.items()
                      if k != "op_launches"}), flush=True)
    for path, counts in report["op_launches"].items():
        for key, (seen, model) in counts.items():
            flag = "" if seen == model else "  <- differs"
            print(f"{path:10s} {key:28s} card {seen} model {model}{flag}",
                  flush=True)
    report["sweep"] = sweep(served_paths(dev), dev)
    for r in report["sweep"]:
        print(f"{r['path']:9s} P={r['P']:3d} model {r['model_ms']:.5f} "
              f"ms measured {r['measured_ms']:.5f} ms ratio "
              f"{r['ratio']:.3f}", flush=True)
    report["design_points"] = design_points(dev)
    line = json.dumps(report)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
