#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each of which exits non-zero when it fails:

1. print the card's name and power limit (``nvidia-smi``);
2. build every kernel from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all started together);
3. hold every kernel against its plain PyTorch version on the card, at
   every shape the main path launches it with (one micro-batch chunk),
   at 16 events and at the 64-event calibration batch, with TF32 off;
   time kernel, plain version and, for ``fused_dense``, the library call
   ``torch.addmm`` (+ ``relu``) that computes the same function;
4. deploy the upgrade-width CaloClusterNet (random weights from a seed)
   at design point 3 under the fp policy on the card, serve 256 events
   through the port's in-order serving loop with every launch counter
   at 0, check that each chunk launched 5 ``fused_dense`` and 2
   ``gravnet_block`` kernels, and that the heads and trigger decisions
   equal those of the same pipeline with the plain versions substituted;
   print events/s, decision latency p50/p99 and the device's idle share;
5. print ``{"kernels": [...]}`` with every kernel of the port, then
   ``{"ok": true, "device": {...}}`` as the last line.

The script refuses to run without CUDA or outside a checkout. Long
output (compiler logs, profiler tables) goes to ``chiprun_out/chip_smoke/``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke"

# the float32 row of tests/_numerics.py: |got - want| <= ATOL + RTOL·|want|
RTOL, ATOL = 1e-5, 1e-5
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
F32_FLOPS = 67e12               # H100 SXM, f32 outside the tensor cores
SERVE_EVENTS = 256
CHECK_BATCHES = (2, 16, 64)     # main-path chunk, serve batch, calibration

KERNELS = {
    "fused_dense": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_dense.cu",
        "replaces": "src/repro/kernels/fused_dense.py:83",
    },
    "gravnet_block": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gravnet_block.cu",
        "replaces": "src/repro/kernels/gravnet_block.py:208",
    },
}


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


# --------------------------------------------------------------- timing ----
class Timer:
    """Device time of a callable: a sleep kernel holds the card while
    the host enqueues ``reps`` calls, so the events bracket the calls'
    device work and not the host's launch overhead."""

    def __init__(self, torch):
        self.torch = torch
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        torch.cuda._sleep(20_000_000)
        b.record()
        b.synchronize()
        self.cycles_per_ms = 20_000_000 / a.elapsed_time(b)

    def device_ms(self, fn, reps: int) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(int(self.cycles_per_ms * (1.5 * host_ms + 1.0)))
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


def dense_cost(x, w):
    m, k = x.shape
    n = w.shape[1]
    return 4.0 * (m * k + k * n + n + m * n), 2.0 * m * k * n


def block_cost(x, w):
    """Bytes and operations of one block launch, each counted once: the
    prologue once per event (the kernel recomputes it in every row block
    of the event; that repeat is not work the function needs), each
    argmin round as n compares per row, and the exp of each round's
    weight as one operation."""
    b, n, dh = x.shape
    ds, df = w["ws"].shape[1], w["wf"].shape[1]
    dcat, dout = w["wo"].shape
    k = w["k"]
    nbytes = 4.0 * (x.numel() + b * n + sum(w[p].numel() for p in
                    ("ws", "bs", "wf", "bf", "wo", "bo")) + b * n * dout)
    flops = b * n * (2.0 * dh * (ds + df)          # S/F prologue
                     + n * (2.0 * ds + 3.0)        # distances
                     + k * (n + 1.0 + 3.0 * df)    # k argmin rounds
                     + 2.0 * dcat * dout)          # epilogue
    return nbytes, flops


# ----------------------------------------------------------------- main ----
def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{ROOT} is not a checkout of the repository (no "
             "src/repro_torch): run chip_smoke.py from its root")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs "
             "an NVIDIA card")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.core import caloclusternet as ccn
    from repro_torch.data.belle2 import Belle2Config, generate
    from repro_torch.kernels import _build
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_dense import fused_dense_cuda
    from repro_torch.kernels.gravnet_block import gravnet_block_cuda
    from repro_torch.launch import serve

    OUT.mkdir(parents=True, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)

    # 1. the card --------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")

    # 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    try:
        logs = _build.build_all()
    except RuntimeError as e:
        fail(f"kernel build: {e}")
    say(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f}s")
    for name, log in logs.items():
        (OUT / f"nvcc_{name}.log").write_text(log)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"  {name}: {line.strip()}")

    plain_fns = {"fused_dense_cuda": ref.fused_dense_ref,
                 "gravnet_block_cuda": ref.gravnet_block_ref}

    @contextmanager
    def substituted(make):
        """Swap the kernel wrappers that kernels/ops.py calls for
        ``make(name, plain_fn)``; restore them afterwards."""
        saved = {n: getattr(kops, n) for n in plain_fns}
        try:
            for n, fn in plain_fns.items():
                setattr(kops, n, make(n, fn))
            yield
        finally:
            for n, fn in saved.items():
                setattr(kops, n, fn)

    # the main path's deployment, used by phases 3 and 4
    cfg = ccn.CCNConfig()
    gen_cfg = Belle2Config()
    pipe = serve.build_pipeline(cfg, design_point=3, precision="fp",
                                device=dev)
    mb = pipe.microbatch
    say(f"deployed upgrade CaloClusterNet (n_hits={cfg.n_hits}, "
        f"d_hidden={cfg.d_hidden}) at design point 3, fp: "
        f"segments={len(pipe.segments)} microbatch={mb}")

    # 3. kernels against their plain versions ----------------------------
    calib = generate(gen_cfg, 64, seed=123)
    calls: list[tuple[str, tuple, dict]] = []

    def recorder(name, fn):
        def rec(*args, **kw):
            calls.append((name, args, kw))
            return fn(*args, **kw)
        return rec

    with substituted(recorder):
        pipe({"hits": calib["feats"], "mask": calib["mask"]})
    per_chunk = len(calls) // (64 // mb)
    chunk_calls = calls[:per_chunk]
    names = [c[0] for c in chunk_calls]
    if (names.count("fused_dense_cuda"), names.count("gravnet_block_cuda")) \
            != (5, 2):
        fail(f"a main-path chunk calls {names}, expected 5 fused_dense and "
             "2 gravnet_block")

    def batched_args(pos, n_events):
        """The pos-th call of a chunk, with the inputs of the first
        n_events events (whole chunks) stacked."""
        parts = [calls[c * per_chunk + pos] for c in range(n_events // mb)]
        name, args0, kw = parts[0]
        args = [torch.cat([p[1][0] for p in parts]), *args0[1:]]
        if name == "gravnet_block_cuda":
            args[1] = torch.cat([p[1][1] for p in parts])
        return name, args, kw

    timer = Timer(torch)
    results = {k: {"max_abs_err": 0.0, "per_launch": []} for k in KERNELS}
    for pos in range(per_chunk):
        for n_ev in CHECK_BATCHES:
            name, args, kw = batched_args(pos, n_ev)
            kname = name.removesuffix("_cuda")
            kern = fused_dense_cuda if kname == "fused_dense" \
                else gravnet_block_cuda
            plain = plain_fns[name]
            try:
                got = kern(*args, **kw)
                torch.cuda.synchronize()
            except (RuntimeError, ValueError, TypeError) as e:
                fail(f"{kname} did not launch: {e}")
            want = plain(*args, **kw)
            err = (got - want).abs()
            excess = (err - (ATOL + RTOL * want.abs())).max().item()
            max_err = err.max().item()
            exact = (got == want).float().mean().item()
            if not np.isfinite(max_err) or excess > 0:
                fail(f"{kname} at {tuple(args[0].shape)} disagrees with "
                     f"its plain version: max|err|={max_err:.3e} "
                     f"(tolerance {ATOL:g} + {RTOL:g}·|want|)")
            if kname == "fused_dense":
                x, w, b = args[0], args[1], args[2]
                nbytes, flops = dense_cost(x, w)
                act = kw.get("activation", "relu")
                shape = f"({x.shape[0]},{x.shape[1]})->{w.shape[1]} {act}"

                def lib(x=x, w=w, b=b, act=act):
                    y = torch.addmm(b, x, w)
                    return torch.relu_(y) if act == "relu" else y
                lib_ms = timer.device_ms(lib, 200)
            else:
                x = args[0]
                nbytes, flops = block_cost(x, {
                    "ws": args[2], "bs": args[3], "wf": args[4],
                    "bf": args[5], "wo": args[6], "bo": args[7],
                    "k": kw["k"]})
                shape = f"x{tuple(x.shape)} k={kw['k']}"
                lib_ms = None
            ms = timer.device_ms(lambda: kern(*args, **kw), 200)
            plain_ms = timer.device_ms(lambda: plain(*args, **kw), 3)
            b_ms, b_by = bound(nbytes, flops)
            row = {"op": pos, "events": n_ev, "shape": shape,
                   "max_abs_err": max_err, "exact_share": exact, "ms": ms,
                   "plain_ms": plain_ms, "library_ms": lib_ms,
                   "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
                   "flops": flops}
            results[kname]["per_launch"].append(row)
            results[kname]["max_abs_err"] = max(
                results[kname]["max_abs_err"], max_err)
            say(f"{kname} events={n_ev} {shape}: max|err|={max_err:.3e} "
                f"(tol {ATOL:g}+{RTOL:g}|want|, {exact:.1%} bitwise) "
                f"ms={ms:.5f} plain_ms={plain_ms:.5f} "
                f"library_ms={'n/a' if lib_ms is None else f'{lib_ms:.5f}'}"
                f" bound_ms={b_ms:.6f} ({b_by})")
    del calls

    # 4. the main path on the card ----------------------------------------
    events = generate(gen_cfg, SERVE_EVENTS, seed=7)
    feeds = {"hits": events["feats"], "mask": events["mask"]}
    serve.serve_events(pipe, {k: v[:32] for k, v in feeds.items()})  # warm
    torch.cuda.synchronize()
    fused_dense_cuda.launches = 0
    gravnet_block_cuda.launches = 0
    res, lat, elapsed = serve.serve_events(pipe, feeds)
    launches = {"fused_dense": fused_dense_cuda.launches,
                "gravnet_block": gravnet_block_cuda.launches}
    batch = max(mb, serve.MIN_SERVE_BATCH)
    n_chunks = sum(-(-min(batch, SERVE_EVENTS - s) // mb)
                   for s in range(0, SERVE_EVENTS, batch))
    say(f"served {SERVE_EVENTS} events in {n_chunks} chunks of {mb}: "
        f"launches {launches}")
    if launches != {"fused_dense": 5 * n_chunks,
                    "gravnet_block": 2 * n_chunks}:
        fail(f"launch counts {launches} != 5 and 2 per chunk "
             f"({n_chunks} chunks)")
    with substituted(lambda n, fn: fn):
        plain_res, _, _ = serve.serve_events(pipe, feeds)
    for h in ("beta", "coords", "energy", "cls"):
        got, want = res[h], plain_res[h]
        if not np.isfinite(got).all() or got.shape != (
                SERVE_EVENTS, cfg.n_hits, cfg.head_dims[h]):
            fail(f"head {h}: shape {got.shape} or non-finite values")
        err = np.abs(got - want)
        if (err > ATOL + RTOL * np.abs(want)).any():
            fail(f"head {h}: kernels vs plain versions max|err|="
                 f"{err.max():.3e}")
        say(f"head {h}: kernels vs plain max|err|={err.max():.3e}")
    for k in ("trigger", "n_clusters", "cluster_valid"):
        if not np.array_equal(res["cps"][k], plain_res["cps"][k]):
            fail(f"cps {k} differs between kernels and plain versions")
    # CPS on the card against CPS on the CPU, on the card's heads
    cpu_cps = ccn.cps({"beta_logit": torch.from_numpy(res["beta"][..., 0]),
                       "coords": torch.from_numpy(res["coords"]),
                       "energy": torch.from_numpy(res["energy"][..., 0])},
                      torch.from_numpy(events["mask"]), cfg)
    for k in ("trigger", "n_clusters", "cluster_valid"):
        if not np.array_equal(res["cps"][k], cpu_cps[k].numpy()):
            fail(f"cps {k} on the card differs from cps on the CPU")
    eff, fake = serve.trigger_rates(res["cps"]["trigger"],
                                    events["trigger_truth"])
    say(f"trigger decisions equal to the plain path on all "
        f"{SERVE_EVENTS} events (efficiency={eff:.3f} fake={fake:.3f}, "
        "random weights)")
    say(f"serve: {SERVE_EVENTS / elapsed:.1f} events/s, latency "
        f"p50={np.percentile(lat, 50) * 1e6:.1f}us "
        f"p99={np.percentile(lat, 99) * 1e6:.1f}us "
        f"({batch} events per dispatch, {card})")

    # where one served micro-batch's time goes, and the device idle share
    prof_feeds = {k: v[:batch] for k, v in feeds.items()}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(4):
            serve.serve_events(pipe, prof_feeds)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels_us: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels_us.setdefault(e.name, [0.0, 0])
            k[0] += e.time_range.elapsed_us()
            k[1] += 1
    busy_us = sum(v[0] for v in kernels_us.values())
    top = sorted(kernels_us.items(), key=lambda kv: -kv[1][0])
    (OUT / "profile.txt").write_text("".join(
        f"{us:12.1f} us {n:7d} calls  {name}\n" for name, (us, n) in top))
    if busy_us > 0:
        say(f"device busy {busy_us:.1f}us of {wall_us:.1f}us wall over 4 "
            f"served micro-batches (profiler on): idle share "
            f"{1 - busy_us / wall_us:.4f}")
        for name, (us, n) in top[:8]:
            say(f"  device {us:10.1f}us  calls {n:6d}  {name[:70]}")
    else:
        say("idle share: not measured (the profiler recorded no device "
            "time)")
    host = {}
    ex = pipe._ex
    run_op = ex.run_op

    def timed(op, vals, feeds_):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = run_op(op, vals, feeds_)
        torch.cuda.synchronize()
        host[op.op_type] = host.get(op.op_type, 0.0) + \
            time.perf_counter() - t
        return out
    ex.run_op = timed
    try:
        serve.serve_events(pipe, prof_feeds)
    finally:
        ex.run_op = run_op
    total = sum(host.values())
    say("per op type, one served micro-batch, synchronized after each op: "
        + ", ".join(f"{k}={v * 1e6:.1f}us ({v / total:.1%})"
                    for k, v in sorted(host.items(), key=lambda kv: -kv[1])))

    # 5. the kernel line and the result ------------------------------------
    line = []
    for name, meta in KERNELS.items():
        rows_ = [r for r in results[name]["per_launch"] if r["events"] == mb]
        lib = [r["library_ms"] for r in rows_]
        nbytes = sum(r["bytes"] for r in rows_)
        flops = sum(r["flops"] for r in rows_)
        b_ms, b_by = bound(nbytes, flops)
        line.append({
            "name": name, **meta, "status": "ported",
            "launches": launches[name],
            "max_abs_err": results[name]["max_abs_err"],
            "tolerance": f"|err| <= {ATOL:g} + {RTOL:g}*|plain|",
            "per": f"one main-path chunk ({len(rows_)} launches, "
                   f"{mb} events)",
            "ms": sum(r["ms"] for r in rows_),
            "plain_ms": sum(r["plain_ms"] for r in rows_),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None if None in lib else sum(lib),
            "per_launch": results[name]["per_launch"],
        })
    (OUT / "kernels.json").write_text(json.dumps(line, indent=1))
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
