"""One run of one cell: set-up, the measured window, the check of every
answer against the plain reference, and the result line.

Set-up (``setup_s``, from process start to the window's first timed event):
import, the kernels' libraries (built on the first run in a checkout, loaded
from ``build/repro_torch/`` after), the weights from the seed on the card,
the calibration events and the traffic pool from the seed, export and deploy
(calibration included), a warm call at the serving width (which captures the
chunk's CUDA graph), the service's lanes (each captures its own) and, for the
service kinds, ``lead_s`` of traffic before the window opens, in which the
queue reaches its steady state.

Then the load thread drives the program for ``--seconds`` (the batch kind's
window ends with the first call that finishes at or after that). With
``--trace 1`` the window's last ``TRACE_S`` seconds run under torch.profiler
(device activity alone) and a sparse host sampler; the rates come from the
part before them.

The traffic kinds are ``loads.py``'s: ``batch`` (the manifest's cell),
``service`` and ``open_loop`` (no cell yet). A cell of any of them, and its
end-to-end metric (``RATE``, ``latency_p99_us``), needs its files alone, no
edit here.

After the window the program's peak memory is read, its state freed, and
the reference answers every pool event; each answer the program gave is
judged against the reference's answer to the same event.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import sys
import time
from types import SimpleNamespace

import numpy as np

from portbench import catalog, traffic
from portbench.loads import BatchLoad, ServiceLoad
from portbench.reduce import percentile

TRACE_S = 2.0
#: the rate each traffic kind reports: the service's, or the direct calls'
RATE = {"service": "events_per_s", "batch": "batch_events_per_s"}
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


# ----------------------------------------------------------------- answers ----
def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [np.asarray(tree)]


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack([np.asarray(t) for t in trees])


def _concat(trees):
    if isinstance(trees[0], dict):
        return {k: _concat([t[k] for t in trees]) for k in trees[0]}
    return np.concatenate(trees)


def _take(tree, idx):
    if isinstance(tree, dict):
        return {k: _take(v, idx) for k, v in tree.items()}
    return tree[idx]


def _same(a, b) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))


def _firsts(keys, answers) -> list:
    """[(key, answer, count)]: each key's first answer with how many equal
    to it (bitwise) came, then every answer that differs from its key's
    first, once each."""
    firsts, variants = {}, []
    for k, a in zip(keys, answers):
        if k not in firsts:
            firsts[k] = [a, 1]
        elif _same(a, firsts[k][0]):
            firsts[k][1] += 1
        else:
            variants.append((k, a, 1))
    return [(k, a, n) for k, (a, n) in firsts.items()] + variants


def distinct_answers(pool_idx, answers):
    """The service kinds' answers (one event each; None where none came) as
    distinct answers. Returns (pool indices, stacked answers, counts,
    unanswered)."""
    got = [(k, a) for k, a in zip(pool_idx, answers) if a is not None]
    unanswered = len(answers) - len(got)
    rows = _firsts(*zip(*got)) if got else []
    if not rows:
        return np.zeros(0, np.int64), None, np.zeros(0), unanswered
    keys, got, n = zip(*rows)
    return (np.asarray(keys), _stack(list(got)), np.asarray(n, np.float64),
            unanswered)


def distinct_batches(pool_idx, outputs, batch: int):
    """The batch kind's calls as distinct per-event answers. Returns (event
    indices, answers, counts, 0)."""
    rows = _firsts(pool_idx, outputs)
    idx = np.concatenate([k * batch + np.arange(batch) for k, _, _ in rows])
    counts = np.concatenate([np.full(batch, float(n)) for _, _, n in rows])
    return idx, _concat([a for _, a, _ in rows]), counts, 0


def to_host(out):
    if isinstance(out, dict):
        return {k: to_host(v) for k, v in out.items()}
    return out.cpu().numpy()


# ------------------------------------------------------------------- a run ----
def prepare(name: str, seed: int, *, device="cuda", here=catalog.HERE,
            fault=None, trace=False) -> SimpleNamespace:
    """Set-up: the model's weights, the pool, the deployment, its warm
    call and (the service kinds) the service. ``fault`` (tests only) wraps
    the deployed pipeline before any traffic: ``fault(pipe) -> pipe``.
    ``trace`` starts the profiler's tracer once before anything is
    captured: CUPTI records no kernel of a CUDA graph captured before it
    started."""
    import torch

    from repro_torch.launch import serve

    stamps = {"imported": time.perf_counter()}
    if trace:
        from portbench import trace as tr
        tr.start_tracer(torch)

    cell = catalog.workloads(here)[name]
    cfg = catalog.configs(here)[cell["config"]]
    mod = catalog.adapter(cfg["model"])
    model = mod.Model(cfg, seed, device)
    stamps["weights"] = time.perf_counter()
    args = serve.parse_args(model.serve_argv())
    pool = model.pool(cell["pool"] * cell.get("batch", 1), seed)
    stamps["pool"] = time.perf_counter()
    pipe = model.deploy(args)
    stamps["deployed"] = time.perf_counter()
    if fault is not None:
        pipe = fault(pipe)
    st = SimpleNamespace(name=name, cell=cell, cfg=cfg, model=model,
                         pool=pool, pipe=pipe, svc=None, stamps=stamps,
                         on_card=torch.device(device).type == "cuda")
    if cell["kind"] == "batch":
        b = cell["batch"]
        st.batches = [{k: v[i * b:(i + 1) * b] for k, v in pool.items()}
                      for i in range(cell["pool"])]

        def call(feeds):
            return to_host(pipe(feeds))
        st.call = call
        call(st.batches[0])                  # warm: the shapes a call uses
    else:
        sv = serve.Servable(mod.SERVABLE, pipe, None)
        width = serve.service_width([sv])
        pipe({k: v[:width] for k, v in pool.items()})   # captures the chunk
        svc = st.svc = serve.build_service(args, [sv],
                                           **serve.fault_kwargs(args))
        route = None if args.model == ["ccn"] else mod.SERVABLE
        st.events = [{k: v[i] for k, v in pool.items()}
                     for i in range(len(next(iter(pool.values()))))]

        def submit(ev):
            return svc.submit(ev, route=route)
        st.submit = submit
    if st.on_card:
        torch.cuda.synchronize()
    stamps["warm"] = time.perf_counter()
    return st


def drive(st, seed: int, seconds: float, trace: bool, *, rate=None):
    """One measured window of the cell's traffic (at ``rate`` instead of
    the cell's, for a sweep); returns what it saw.

    The harness keeps every answer for the check, for a service hundreds of
    thousands of objects, which the cyclic collector would walk again and
    again, each time stopping every thread of the process for up to a tenth
    of a second. So that the window measures the program and not the
    harness's retention, the collector is off from the start of traffic
    until the answers are read."""
    gc.collect()
    gc.disable()
    try:
        return _drive(st, seed, seconds, trace, rate)
    finally:
        gc.enable()


def _sleep_until(t: float) -> None:
    time.sleep(max(0.0, t - time.perf_counter()))


def thread_cpu() -> dict:
    """The CPU seconds each live thread of this process has used, by
    thread name (empty where the system has no ``/proc``)."""
    import threading
    out = {}
    tick = os.sysconf("SC_CLK_TCK")
    for t in threading.enumerate():
        try:
            with open(f"/proc/self/task/{t.native_id}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except (OSError, IndexError):
            continue
        out[t.name] = (int(fields[11]) + int(fields[12])) / tick
    return out


def _drive(st, seed, seconds, trace, rate):
    import torch

    cell, kind = st.cell, st.cell["kind"]
    t0 = time.perf_counter()
    lead = 0.0 if kind == "batch" else cell["lead_s"]
    w0, w1 = t0 + lead, t0 + lead + seconds
    if kind == "batch":
        load = BatchLoad(st.call, st.batches, t0, t_stop=w1)
    elif kind == "service":
        load = ServiceLoad(st.submit, st.events, t0, t_stop=w1)
    elif kind == "open_loop":
        rate = cell["rate_per_s"] if rate is None else rate
        n = math.ceil(rate * (lead + seconds) * 1.05) + 2
        gaps = traffic.arrival_gaps(rate, n, traffic.rng(seed, "arrivals"))
        due = np.cumsum(gaps) - gaps[0]
        load = ServiceLoad(st.submit, st.events, t0, t_stop=w1,
                           due=due[due <= lead + seconds])
    else:
        raise ValueError(f"unknown traffic kind {kind!r}")
    window = None
    load.start()
    _sleep_until(w0)
    cpu0 = thread_cpu()
    if trace:
        from portbench import trace as tr
        _sleep_until(w1 - min(TRACE_S, seconds / 2))
        window = tr.Window(torch)
        window.start()
    _sleep_until(w1)
    stats = None if st.svc is None else st.svc.stats.summary()
    cpu1 = thread_cpu()
    if window is not None:
        window.stop()
    load.join(timeout=seconds + lead + 600)
    seen = SimpleNamespace(stats=stats, window=window, lat=None, host={
        "thread_cpu_s": {k: round(v - cpu0[k], 3) for k, v in cpu1.items()
                         if k in cpu0}, "load_cpu_s": load.cpu_s})
    if kind == "batch":
        seen.w0, seen.w1 = load.t_disp[0], load.t_done[-1]
        done = np.asarray(load.t_done)
        seen.completed = seen.attempted = len(done) * cell["batch"]
        seen.failed = 0
        seen.done_at = np.repeat(done, cell["batch"])
        seen.spans = (np.asarray(load.t_disp), done, cell["batch"])
        seen.answers = distinct_batches(load.pool_idx, load.outputs,
                                        cell["batch"])
        return seen
    answers, rel = load.results()
    due_t = np.asarray(load.t_due)
    if kind == "service":
        counted = (np.asarray(load.t_sub) >= w0) & (due_t <= w1)
    else:
        counted = (due_t >= w0) & (due_t <= w1)
    ok = np.asarray([a is not None for a in answers], bool)
    seen.w0, seen.w1 = w0, w1
    seen.attempted = int(counted.sum())
    seen.failed = int((counted & ~ok).sum())
    seen.completed = int(((rel >= w0) & (rel <= w1) & ok).sum())
    seen.lat = (rel - due_t)[counted & ok]
    seen.late = (np.asarray(load.t_sub) - due_t)[counted]
    seen.done_at = rel[ok]
    seen.spans = (seen.done_at, seen.done_at, 1)
    seen.answers = distinct_answers(load.pool_idx, answers)
    return seen


def check(st, seen) -> dict:
    """The compared numbers, each beside its limit, and ``correct``."""
    idx, got, n_each, unanswered = seen.answers
    want = st.model.reference(st.pool)
    numbers = st.model.numbers(got, _take(want, idx), n_each) if len(idx) \
        else {}
    numbers["unanswered"] = unanswered
    limits = dict(st.cfg["correct"]["limits"], unanswered=0)
    compared = {k: {"value": numbers.get(k), "limit": v}
                for k, v in limits.items()}
    correct = len(idx) > 0 and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in compared.values())
    return {"numbers": numbers, "compared": compared, "correct": correct}


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, device="cuda", here=catalog.HERE,
             fault=None, stamps=None) -> dict:
    """Everything but the result line. ``stamps``: the caller's moments of
    set-up, by name, for the run's record beside the harness's own."""
    import torch

    st = prepare(name, seed, device=device, here=here, fault=fault,
                 trace=trace)
    seen = drive(st, seed, seconds, trace)
    setup_s = seen.w0 - t_start         # the lead-in included
    memory_peak = torch.cuda.max_memory_allocated() if st.on_card else 0
    if st.svc is not None:
        st.svc.drain(timeout=60)
        st.svc.close()
    w = seen.window
    trace_rec = w.read() if w is not None else None
    st.pipe = st.svc = st.call = st.submit = None
    gc.collect()
    if st.on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    verdict = check(st, seen)
    # the traced stretch closes the window; the rates come from the rest
    hi = seen.w1 if w is None else w.h0
    completed = _work(seen.spans, seen.w0, hi)
    trace_done = 0 if w is None else _work(seen.spans, w.h0, w.h1)
    ctx = SimpleNamespace(
        cell=name, kind=st.cell["kind"], cfg=st.cfg, model=st.model,
        window_s=hi - seen.w0, completed=completed, stats=seen.stats,
        budget=None if seen.stats is None else seen.stats["budget"],
        trace=trace_rec, trace_events=trace_done, is_hand=hand_kernels())
    edges = np.arange(seen.w0, seen.w1 + 1e-9, 1.0)
    stamps = dict(stamps or {}, **st.stamps, window=seen.w0)
    diag = {"per_second": np.histogram(seen.done_at, edges)[0].tolist()
            if len(edges) > 1 else [],
            "setup_at_s": {k: round(v - t_start, 3)
                           for k, v in stamps.items()},
            "check_s": time.perf_counter() - t_check, **seen.host}
    if seen.lat is not None and len(seen.lat):
        lat = np.sort(seen.lat)
        diag["lat_us"] = {f"p{q}": float(percentile(lat, q)) * 1e6
                          for q in (50, 90, 99, 99.9)}
        diag["lat_us"]["max"] = float(lat[-1]) * 1e6
        diag["late_p99_us"] = float(percentile(seen.late, 99)) * 1e6
    if seen.stats is not None:
        diag["events_a_launch"] = (seen.stats["completed"]
                                   / max(seen.stats["batches"], 1))
        diag["budget_us"] = seen.stats["budget"]
    if trace_rec is not None:
        diag["traced_ops"] = len(trace_rec["ops"])
        diag["traced_events"] = trace_done
        diag["markers"] = trace_rec["markers"]
        diag["clock_skew_us"] = trace_rec["clock_skew_us"]
        # the host's pace while traced against before: near 1 where
        # tracing costs the program nothing
        diag["traced_rate_share"] = (trace_done / (w.h1 - w.h0)) / (
            completed / (hi - seen.w0)) if completed else None
    return {"ctx": ctx, "setup_s": setup_s, "lat": seen.lat, "diag": diag,
            "attempted": seen.attempted, "failed": seen.failed,
            "memory_peak": int(memory_peak), **verdict}


def _work(spans, lo: float, hi: float) -> float:
    """Events of the work done in [lo, hi]: spans = (starts, ends, events
    each); a call's events count by the share of its span inside, an
    answer with no span (start = end) counts where it came."""
    start, end, n = (np.asarray(x, np.float64) for x in spans)
    if not start.size:
        return 0.0
    dur = end - start
    inside = np.clip(np.minimum(end, hi) - np.maximum(start, lo), 0.0, None)
    share = np.where(dur > 0, inside / np.where(dur > 0, dur, 1.0),
                     (end >= lo) & (end <= hi))
    return float((n * share).sum())


def hand_kernels():
    """A predicate on a device record's name: whether it is one of the
    program's hand-written kernels (``<source>..._kernel`` of a source
    under ``kernels/csrc``)."""
    import re

    from repro_torch.kernels import _build
    rx = re.compile(r"(?<!\w)(" + "|".join(map(re.escape, _build.sources()))
                    + r")\w*_kernel(?!\w)")
    return lambda n: rx.search(n) is not None


def end_to_end(bench: dict, name: str, run: dict) -> dict:
    """The cell's end-to-end metrics, by the manifest: the set-up, the rate
    of completed events over the window's untraced part (its kind's
    ``RATE``) and the tail over every event due in the window (an open
    loop's)."""
    ctx = run["ctx"]
    vals = {"setup_s": run["setup_s"]}
    if ctx.kind in RATE:
        vals[RATE[ctx.kind]] = ctx.completed / ctx.window_s
    if run["lat"] is not None and len(run["lat"]):
        vals["latency_p99_us"] = float(percentile(run["lat"], 99)) * 1e6
    return {m["name"]: {"value": vals[m["name"]], "unit": m["unit"]}
            for m in bench["end_to_end"] if catalog.applies(m, name)}


def per_layer(bench: dict, name: str, run: dict, here=catalog.HERE) -> dict:
    """The cell's per-layer metrics that found something to read."""
    readers = catalog.metrics(here)
    out = {}
    for m in bench["per_layer"]:
        if not catalog.applies(m, name):
            continue
        v = readers[m["name"]].read(run["ctx"])
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def main(argv=None, t_start=None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    a = parse_args(argv)
    bench = catalog.manifest()
    cells = {w["name"]: w for w in bench["workloads"]}
    if a.workload not in cells:
        print(f"no cell {a.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401 — a checkout without the program stops here
    import torch
    stamps = {"torch": time.perf_counter()}
    chips = cells[a.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA device(s); CUDA available: "
              f"{torch.cuda.is_available()}, devices: "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 3
    torch.cuda.init()
    stamps["cuda"] = time.perf_counter()
    run = run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                   t_start=t_start, stamps=stamps)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": 1, "memory_peak_bytes": run["memory_peak"]}
    result = {"correct": run["correct"], "attempted": run["attempted"],
              "failed": run["failed"]}
    if a.trace:
        from portbench import trace as tr
        rec = run["ctx"].trace
        result["metrics"] = per_layer(bench, a.workload, run)
        device["busy_s"] = tr.busy_s(rec)
        device["window_s"] = rec["hi"] - rec["lo"]
        result["device"] = device
        result["breakdown"] = tr.breakdown(rec)
    else:
        result["metrics"] = end_to_end(bench, a.workload, run)
        result["device"] = device
    result["compared"] = run["compared"]
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 4
    print(f"run {json.dumps(run['diag'])}", file=sys.stderr)
    print(f"numbers {json.dumps(run['numbers'])}", file=sys.stderr)
    for k, c in run["compared"].items():
        print(f"compared {k} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
