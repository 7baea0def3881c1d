#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each of which exits non-zero when it fails:

1. print the card's name and power limit (``nvidia-smi``);
2. build every kernel from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all started together);
3. hold every kernel against its plain PyTorch version on the card, at
   every shape its path launches it with (one micro-batch chunk), at 16
   events and at the 64-event calibration batch, with TF32 off; time
   kernel, plain version and, where one PyTorch call computes the same
   function, that library call (``torch.addmm`` + ``relu`` for
   ``fused_dense``; ``torch._int_mm``, the int8 product alone without
   the epilogue, for ``fused_dense_int8`` at the shapes it accepts;
   ``index_add_`` for ``edge_aggregate``'s sum and, over 0/1 masks,
   ``index_reduce_('mean')`` for its mean), checked once against the
   plain version before it is timed. ``fused_dense`` and
   ``edge_aggregate`` are held bitwise at every shape checked, the f32
   dense also on the inputs of ``kernels/f32_cases.py`` (K from 1 past
   its staging limit, row-strided x, N and M off every tile, with and
   without bias), with each tile's shared-memory plan against the
   library's own. The int8 pair (``fused_dense_int8``,
   ``gravnet_block_int8``) is held bitwise everywhere: at the main
   path's shapes, at the current detector's (its mixed deployment's
   calls, 32 hits, at one chunk, 16 and 64 events), and on the inputs of
   ``kernels/int8_cases.py`` (exact distance ties, 32 and 50 hits, fewer
   valid hits than k, rows off the tile, K = 4 and N = 7 in both output
   forms, K past one staged slice, x quantized on the hard quotients of
   ``int8_cases.quotient_edges``). So is the f32 GravNet pair
   (``gravnet_block``, ``gravnet_aggregate``): at the fp and unfused
   paths' shapes (the block also at one event of its chunk), at the
   current detector's fp deployment (its calls, 32 hits, at one chunk,
   16 and 64 events), and on the inputs of ``kernels/f32_cases.py``
   (exact distance ties, 1 to 600 hits, fewer valid hits than k, a
   masked event, k past n, d_s 1 and 9, d_f 1 to 129, 1 to 64 events,
   the register cell and the shared-memory cell past it), with each
   shape's shared-memory plan against the library's own;
4. the main path, as ``python -m repro_torch.launch.serve
   --train-steps 0`` runs it: deploy the upgrade-width CaloClusterNet
   (random weights from a seed) at design point 3 under the **mixed**
   policy, calibrated on the card, serve 256 events through the
   in-order loop with every launch counter at 0, check 5
   ``fused_dense_int8`` and 2 ``gravnet_block_int8`` launches per chunk
   and no f32 dense, block or aggregate launch, and that the heads and
   trigger decisions equal bitwise those of the same deployment with the
   plain versions substituted, calibration included; print events/s,
   decision latency p50/p99, trigger efficiency, the device's idle share
   and the host time per op type; then (4b) the default run: warm-train
   those weights on the card for 40 steps (``serve.warm_train``, the
   reference's condensation training, autograd through the plain ops;
   the loss must stay finite and fall), deploy the trained weights the
   same way and serve and check the same 256 events as above;
5. the other paths, each with the counters at 0 just before it: the fp
   policy at design point 3 (64 events; 5 ``fused_dense`` and 2
   ``gravnet_block`` per chunk), design point 1 under fp and design
   point 3 under mixed with ``fuse_int8=False`` (16 events each; both
   launch ``gravnet_aggregate``), each held against its plain versions;
6. the padding-free ragged path, as ``deploy(ragged=True)`` serves it:
   the upgrade-width CaloClusterNet at design point 3, fp, 8 bins of 128
   rows per launch, serving 128 events whose occupancy spreads over a
   quarter to three quarters of the readout (so bins hold 1–3 events),
   16 per call, with the counters at 0 just before: 2 ``knn_build``, 2
   ``knn_aggregate`` and the graph's ``fused_dense`` count per launch,
   no GravNet block or aggregate launch; heads and every CPS output
   bitwise equal to the plain-substituted deployment; real rows within
   the float32 row of the padded fp path on the same events, with the
   same trigger decisions; events/s and latency of ragged and padded in
   turns, and the idle share; then the same at design point 1 (16
   events, the kNN pair as graph ops). Phase 3 holds both kNN kernels
   against their plain versions, bitwise, at 1, 8 and 16 bins of this
   path, with segment ids from its real bin packing, and on the inputs
   of ``kernels/f32_cases.py`` (bins of 1–3 events, spent slots, an
   all-padding bin, coincident rows, exact ties, 40 to 600 rows, d_s 3
   and 12, d_f 22 and 129, indices outside [0, n), k 40), with their
   shared-memory plans against the library's own; it times each against
   the first design (each source's second path, the kernel it
   replaced) in turns at 1, 8 and 16 bins of packed events
   (``kernels/source_ab.py``), and prints where a CTA of each spends its
   time (``kernels/phase_split.py``);
7. the edge-based GNNs, as ``python -m repro_torch.launch.serve --model
   gatedgcn graphsage`` deploys them but at their published widths:
   GatedGCN 16 layers × 70 and GraphSAGE 2 layers × 128 (random weights
   from generator seeds 1 and 2) on the serve routes' graphs of 64 nodes
   and 256 edges, design point 3, fp. Each serves 128 events (graphs of
   seed 7, ``max(8, microbatch)`` per dispatch as the reference's
   service serves its GNN routes) with the counters at 0 just before:
   exactly 2 ``edge_aggregate`` per layer and chunk, the graph's
   ``fused_dense`` count, no other kernel; logits bitwise equal to the
   plain-substituted deployment on the card, and within the float32 row
   of the same deployment with ``device="cpu"``; events/s, latency and
   the idle share. The kernel calls of each path (graphs of seed 17) are
   held against their plain versions, bitwise (``edge_aggregate`` at one
   graph, the path's micro-batch and 16 graphs, the denses on the
   row-strided own-K views the executor gives them), and the device time
   of a chunk is printed: the two kernels' timed launches beside the
   library calls', and the profiled busy time; so is ``edge_aggregate``
   held on synthetic graphs of the routes' size with masked edges and
   destinations outside [0, N), for sum and mean, at d 16, 32, 70 and
   128 and 1, 8 and 16 graphs, and on the inputs of
   ``kernels/f32_cases.py`` (E from 1 to the largest a launch takes, one
   node taking every edge, every edge masked, every dst out of range, d
   1 to 129), with its shared-memory plans against the library's own.
   Then ``launch.serve.main`` serves
   ``--model ccn gatedgcn graphsage`` and every route must answer every
   event;
8. the ``attention`` op and the tuning layer: ``flash_attention`` (FMA
   code, so held to the float32 row of its plain version
   ``flash_attention_blocked_ref``, not to its bits) at the reference's
   LM prefill tuning cell (8, 512, 512, 64), its regression bench's
   (8, 1024, 1024, 64) and OLMo-1B's heads at 4096 tokens (16, 4096,
   4096, 128), causal; at (8, 512, 512, 64) not causal; the same four on
   bf16 q, k, v against the bfloat16 row; where the wrapper splits the
   kv tiles over CTAs, unsplit too; at S = 1000 padded to the blocks;
   and at every (bq, bk) that ``tuning/candidates.py`` keeps at (8, 512,
   512, 64); its shared memory plans must agree with the library's own;
   times beside ``F.scaled_dot_product_attention`` on the same inputs
   (its max |err| printed, the port never calls it). Then an
   ``attention`` graph (q, k, v denses of random weights from numpy
   seed 0 at scale 1/√64) deployed at design point 3, fp, ``batch=8``,
   n 512, d 64, serving 32 events with the counters at 0 just before:
   one ``flash_attention`` and one ``fused_dense`` per dense of the
   deployed graph (the fusion pass merges q, k and v into one) per
   micro-batch of 8, its output within the float32 row of the
   plain-substituted deployment and of ``device="cpu"``. Then
   ``autotune_graph`` over that deployment and
   over the main path's, a redeploy with the cache whose attention op
   binds the cached (bq, bk) and launches it, a ``save``/``load`` round
   trip and ``warm_from_cache`` of every entry; the tuner's row: the
   bound (bq, bk)'s device time is at most the default's (the tuner
   times on the card's clock); then ``serve.main`` with
   ``--tune --tuning-cache`` and again on the saved cache alone, which
   binds every problem without searching;
9. the whole-pipeline compile: on eight paths (the served default
   warm-trained, fp, fp at design point 1, mixed with
   ``fuse_int8=False``, ragged, GatedGCN, GraphSAGE, attention) the
   captured deployment (one CUDA graph replay per chunk, per segment at
   design point 1, per launch on the ragged path) answers every output
   bitwise as its eager ``run_chunk`` loop does; in turns (captured,
   eager, eager, captured, captured, eager) the events/s, latency
   p50/p99 and host wall per chunk of both, and their medians; the idle
   share of both for the served default and GatedGCN, with a profiler
   cross-check that each replay runs the default's 5 ``fused_dense_int8``
   and 2 ``gravnet_block_int8``; and CPS alone on one chunk's heads, its
   device time captured and eager (``capture.json``). Every phase above
   serves through the captures too; the plain-substituted and the
   recording runs go through ``run_eager``. A path's launch counts are
   read from its counted run: its served events once more under
   torch.profiler, every counter at 0 just before, each kernel's runs
   on the card counted from the profiler's records (``counted``); the
   counters, which a replay adds to by what its capture recorded, must
   read the same, and the kernels line takes the profiler's counts;
10. the serving layer: ``serve.run`` (``python -m
    repro_torch.launch.serve``) through ``ShardedTriggerService``, each
    replica on a lane of its own (a CUDA stream, captures and pinned
    rings): (a) the default run (warm-trained mixed, design point 3, one
    replica, the streaming loop, 512 events), (b) ``--replicas 2`` under
    each policy, (c) ``--loop deadline``, (d) ``--model gatedgcn
    graphsage``, (f) ``--replicas 2 --inject-faults
    'fail:p=1.0,replica=1' --max-retries 2`` (0 client-visible
    failures), and (e) a ``ragged=`` service over the ragged deployment,
    16 events a launch. Every event released once, in submission order,
    every output bitwise equal to ``serve_events`` on the same deployment
    (the plain captured loop, timed right after it), each lane captured
    before traffic and nothing during it; then a fresh service on the
    same deployment serves the events once more as its counted run (the
    profiler's kernel runs equal to the counters; on the mixed runs 5
    ``fused_dense_int8`` and 2 ``gravnet_block_int8`` per chunk of every
    launch that ran) and its idle share; events/s, p50/p99, the budget,
    batches and padded events beside the plain loop's and phase 9's
    (``service.json``). The kernel line's launches add these runs';
11. print ``{"kernels": [...]}`` with every kernel of the port, then
    ``{"ok": true, "device": {...}}`` as the last line.

The script refuses to run without CUDA or outside a checkout. Long
output (compiler logs, profiler tables) goes to ``chiprun_out/chip_smoke/``.
"""
from __future__ import annotations

import io
import json
import re
import subprocess
import sys
import time
from contextlib import contextmanager, redirect_stdout
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke"

# the float32 row of tests/_numerics.py: |got - want| <= ATOL + RTOL·|want|
RTOL, ATOL = 1e-5, 1e-5
BF16_RTOL, BF16_ATOL = 3e-2, 3e-2   # its bfloat16 row
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
RATES = {"f32": 67e12,          # H100 SXM, f32 outside the tensor cores
         "int8": 1979e12}       # H100 SXM, int8 tensor cores, dense
SERVE_EVENTS = 256              # the main path
FP_EVENTS = 64                  # the fp path of the first slice
SHORT_EVENTS = 16               # design point 1, and mixed without fuse_int8
CHECK_BATCHES = (2, 16, 64)     # one chunk, serve batch, calibration
RAGGED_EVENTS = 128             # the ragged path
RAGGED_BINS = 8                 # bins per launch (benchmarks/batching.py)
RAGGED_OCCUPANCY = (33, 65, 97)  # a quarter to three quarters of 128
RAGGED_CHECK_BINS = (1, 8, 16)  # the kNN kernels' checks
DISPATCH = 16                   # events per call of the serving loop on
                                # the CaloClusterNet paths and attention:
                                # max(microbatch, 16)
GNN_EVENTS = 128                # the edge-based GNNs' served graphs
EDGE_WIDTHS = (16, 32, 70, 128)  # edge_aggregate's synthetic checks
EDGE_BATCHES = (1, 8, 16)
# flash_attention's (BH, S, T, D), causal: the reference's LM prefill
# tuning cell (benchmarks/tuning_bench.py), its regression bench's
# (benchmarks/regression.py) and OLMo-1B's 16 heads of 128 at the
# train_4k length (src/repro/configs/olmo_1b.py, lm_common.py)
ATTN_SHAPES = ((8, 512, 512, 64), (8, 1024, 1024, 64),
               (16, 4096, 4096, 128))
ATTN_N, ATTN_D, ATTN_BATCH = 512, 64, 8  # the deployed attention graph
ATTN_EVENTS = 32
CAPTURE_EVENTS = 128            # CaloClusterNet events of phase 9's paths
PROFILE_MARGIN_S = 0.02         # idle time at each edge of a profiled window

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
    "fused_dense_int8": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_dense_int8.cu",
        "replaces": "src/repro/kernels/fused_dense.py:221",
    },
    "gravnet_aggregate": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gravnet_aggregate.cu",
        "replaces": "src/repro/kernels/gravnet.py:142",
    },
    "gravnet_block_int8": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gravnet_block_int8.cu",
        "replaces": "src/repro/kernels/gravnet_block.py:427",
    },
    "knn_build": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/knn_build.cu",
        "replaces": "src/repro/kernels/knn_build.py:172",
    },
    "knn_aggregate": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/knn_aggregate.cu",
        "replaces": "src/repro/kernels/knn_build.py:242",
    },
    "edge_aggregate": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/edge_aggregate.cu",
        "replaces": "src/repro/kernels/edge_aggregate.py:117",
    },
    "flash_attention": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:78",
    },
}
# kernels held bitwise to their plain versions at every shape checked
BITWISE = {"fused_dense", "fused_dense_int8", "gravnet_block",
           "gravnet_block_int8", "gravnet_aggregate", "edge_aggregate",
           "knn_build", "knn_aggregate"}
# the int8 block's widths on the edge inputs: the served model's and the
# reference's smoke config's (repro/configs/caloclusternet.py)
INT8_WIDTHS = dict(dh=64, ds=4, df=22, dout=64)
SMOKE_WIDTHS = dict(dh=24, ds=3, df=8, dout=24)
# leading arguments of each kernel that carry the events (stacked to
# check a kernel at more events than one chunk)
EVENT_ARGS = {"fused_dense": 1, "fused_dense_int8": 1, "gravnet_block": 2,
              "gravnet_block_int8": 2, "gravnet_aggregate": 3,
              "knn_build": 2, "knn_aggregate": 3, "edge_aggregate": 3}


LOG: list[str] = []


def _save_log() -> None:
    """Keep the whole output under chiprun_out/, whose tail alone comes
    back from a chip run."""
    if OUT.is_dir():
        (OUT / "log.txt").write_text("".join(LOG))


def fail(msg: str) -> None:
    say(f"FAIL: {msg}")
    _save_log()
    sys.exit(1)


def say(msg: str) -> None:
    line = f"[chip_smoke] {msg}"
    LOG.append(line + "\n")
    print(line, flush=True)


class Eager:
    """A deployment run without capture, for ``serve_events``: the eager
    ``run_chunk`` loop (a ragged deployment's launches eagerly). The
    runs with the plain versions substituted on the card go this way:
    a replay would run the captured kernels, and the plain
    ``edge_aggregate`` reads its loop length back to the host."""

    def __init__(self, pipe):
        self.pipe = pipe
        self.microbatch = pipe.microbatch

    def __call__(self, feeds):
        return self.pipe.run_eager(feeds)


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

    def once_ms(self, fn) -> float:
        """Device time of one call, after one untimed call."""
        torch = self.torch
        fn()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b)

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


# ------------------------------------------------------------------ cost ----
# Bytes and operations of one launch, each input read once and each
# output written once. Operations are counted by type: products and sums
# as one each, an argmin round as n compares per row, each round's exp,
# each quantization's division and rounding, and each dequantization's
# multiply as one f32 operation; int8 products and sums at the int8
# tensor-core rate. The bound is the largest of the byte time and each
# type's operation time.
def bound(nbytes: float, ops: dict) -> tuple[float, str]:
    t_b = nbytes / HBM_BYTES_PER_S
    t_o = max(n / RATES[kind] for kind, n in ops.items())
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


def _numel(*ts):
    return float(sum(t.numel() for t in ts if t is not None))


def _cell_ops(n, ds, df, k):
    """f32 operations of the GravNet cell per query row."""
    return n * (2.0 * ds + 3.0) + k * (n + 1.0 + 3.0 * df)


def _segment_sizes(seg):
    """Per packed row, the rows of its own event (itself included); 0
    on padding rows."""
    same = (seg[:, :, None] == seg[:, None, :]) & (seg[:, None, :] >= 0)
    return same.sum(dim=2).double()


def _real_k(w):
    """The dense's own K, its weight's nonzero rows: the executor pads an
    int8 w with zero rows to meet a lane-padded input
    (``core/pipeline.py``), and those rows and x's padding columns are
    no work the function needs (the f32 dense reads its own K)."""
    return int((w != 0).any(dim=1).sum().item())


def cost(name, args, kw):
    if name == "flash_attention":
        # each unmasked (row, key) pair: D products and sums for its
        # score, D for its share of p·v, one exp; under causal only the
        # pairs with key <= row (about half); q, k, v read, o written
        q, k = args[0], args[1]
        bh, s, d = q.shape
        t = k.shape[1]
        pairs = float(bh * (sum(min(r + 1, t) for r in range(s))
                            if kw.get("causal", True) else s * t))
        return q.element_size() * (2.0 * _numel(q) + 2.0 * _numel(k)), {
            "f32": pairs * (4.0 * d + 1.0)}
    # the kNN pair's work depends on the packing: count the distances
    # and argmin rounds a real row needs against its own event's rows,
    # and the aggregation's valid slots, not the whole bin
    if name == "knn_build":
        s, seg = args[:2]
        b, n, ds = s.shape
        k = kw["k"]
        c = _segment_sizes(seg)
        cand = (c - 1).clamp_min(0)
        nbytes = 4.0 * (_numel(s, seg) + 2.0 * b * n * k)
        return nbytes, {"f32": float(((c > 0) * 2.0 * ds + cand * (
            2.0 * ds + 3.0) + k * cand).sum())}
    if name == "knn_aggregate":
        f, idx, d2 = args[:3]
        b, n, df = f.shape
        valid = float((d2 < 0.5e30).sum())
        rows = float((d2[..., 0] < 0.5e30).sum())
        nbytes = 4.0 * (_numel(f, idx, d2) + b * n * 2 * df)
        return nbytes, {"f32": valid * (2.0 + 3.0 * df) + rows * 2.0 * df}
    if name == "edge_aggregate":
        # only edges whose dst lies in [0, n) are summed
        msg, dst, mask = args[:3]
        b, e, d = msg.shape
        n = kw["n_nodes"]
        valid = float(((dst >= 0) & (dst < n)).sum())
        nbytes = 4.0 * (_numel(msg, dst, mask) + b * n * d)
        mean = kw.get("reduce", "sum") == "mean"
        return nbytes, {"f32": 2.0 * valid * d + (
            valid + b * n * d if mean else 0.0)}
    if name == "fused_dense":
        x, w, b = args[:3]
        m, kd = x.shape[0], _real_k(w)
        n = w.shape[1]
        return 4.0 * ((m + n) * kd + _numel(b) + m * n), {
            "f32": 2.0 * m * kd * n}
    if name == "fused_dense_int8":
        x, w, b, _, ws = args[:5]
        m, kd = x.shape[0], _real_k(w)
        n = w.shape[1]
        out8 = kw.get("out_int8", False)
        nbytes = (m + n) * kd + 4.0 * _numel(b, ws) + m * n * (
            1.0 if out8 else 4.0)
        return nbytes, {"int8": 2.0 * m * kd * n,
                        "f32": m * n * (3.0 + (2.0 if out8 else 0.0)) + n}
    if name == "gravnet_aggregate":
        s, f, mask = args[:3]
        b, n, ds = s.shape
        df = f.shape[2]
        nbytes = 4.0 * (_numel(s, f, mask) + b * n * 2 * df)
        return nbytes, {"f32": b * n * (2.0 * ds
                                        + _cell_ops(n, ds, df, kw["k"]))}
    x = args[0]
    b, n, dh = x.shape
    ws, bs, wf, bf, wo, bo = args[2:8]
    ds, df = ws.shape[1], wf.shape[1]
    dcat, dout = wo.shape
    if name == "gravnet_block":
        # the S/F prologue once per event (the kernel recomputes it in
        # each row block of an event; the repeat is not counted)
        nbytes = 4.0 * (_numel(x, *args[1:8]) + b * n * dout)
        return nbytes, {"f32": b * n * (2.0 * dh * (ds + df)
                                        + _cell_ops(n, ds, df, kw["k"])
                                        + 2.0 * dcat * dout)}
    nbytes = (4.0 * _numel(x, args[1], bs, bf, bo, *args[8:11])
              + _numel(ws, wf, wo) + 4.0 * b * n * dout)
    return nbytes, {
        "int8": b * n * (2.0 * dh * (ds + df) + 2.0 * dcat * dout),
        "f32": b * n * (2.0 * dh + 3.0 * (ds + df)
                        + _cell_ops(n, ds, df, kw["k"]) + 4.0 * 2 * df
                        + 2.0 * dh + 3.0 * dout)}


def shape_of(name, args, kw):
    if name == "flash_attention":
        split = kw.get("splits")
        return (f"q{tuple(args[0].shape)} T={args[1].shape[1]} "
                f"{str(args[0].dtype)[6:]} "
                f"{'causal' if kw.get('causal', True) else 'full'} "
                f"bq={kw['bq']} bk={kw['bk']}"
                + ("" if split is None else f" splits={split}"))
    if name == "edge_aggregate":
        return (f"msg{tuple(args[0].shape)} n={kw['n_nodes']} "
                f"{kw.get('reduce', 'sum')}")
    if name == "knn_build":
        return f"s{tuple(args[0].shape)} k={kw['k']}"
    if name == "knn_aggregate":
        return f"f{tuple(args[0].shape)} k={args[1].shape[2]}"
    if name in ("fused_dense", "fused_dense_int8"):
        x, w = args[0], args[1]
        tag = f"({x.shape[0]},{x.shape[1]})->{w.shape[1]} " \
              f"{kw.get('activation', 'relu')}"
        return tag + (" int8 out" if kw.get("out_int8") else "")
    if name == "gravnet_aggregate":
        return f"s{tuple(args[0].shape)} f{tuple(args[1].shape)} k={kw['k']}"
    return f"x{tuple(args[0].shape)} k={kw['k']}"


# ----------------------------------------------------------------- main ----
def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{ROOT} is not a checkout of the repository (no "
             "src/repro_torch): run chip_smoke.py from its root")
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs "
             "an NVIDIA card")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.core import caloclusternet as ccn
    from repro_torch.data.belle2 import (Belle2Config, generate,
                                         with_occupancy)
    from repro_torch.kernels import _build, f32_cases, int8_cases
    from repro_torch.kernels import edge_aggregate as edge_mod
    from repro_torch.kernels import fused_dense as dense_mod
    from repro_torch.kernels import gravnet as agg_mod
    from repro_torch.kernels import gravnet_block as block_mod
    from repro_torch.kernels import knn_build as knn_mod
    from repro_torch.kernels import phase_split, source_ab
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_dense import (fused_dense_cuda,
                                                 fused_dense_int8_cuda)
    from repro_torch.kernels.gravnet import gravnet_aggregate_cuda
    from repro_torch.kernels.gravnet_block import (gravnet_block_cuda,
                                                   gravnet_block_int8_cuda)
    from repro_torch.kernels.knn_build import (knn_aggregate_cuda,
                                               knn_build_cuda)
    from repro_torch.kernels.edge_aggregate import edge_aggregate_cuda
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     kv_split,
                                                     library_smem_bytes,
                                                     smem_bytes)
    from repro_torch.core.pipeline import RaggedPipeline
    from repro_torch.launch import serve
    from repro_torch.models.gnn import gatedgcn, graphsage

    OUT.mkdir(parents=True, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()

    # 1. the card --------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    LOG.append(card + "\n")
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
    if sorted(logs) != sorted(KERNELS):
        fail(f"built {sorted(logs)}, expected {sorted(KERNELS)}")
    say(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f}s")
    for name, log in logs.items():
        (OUT / f"nvcc_{name}.log").write_text(log)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"  {name}: {line.strip()}")

    wrappers = {"fused_dense": fused_dense_cuda,
                "gravnet_block": gravnet_block_cuda,
                "fused_dense_int8": fused_dense_int8_cuda,
                "gravnet_aggregate": gravnet_aggregate_cuda,
                "gravnet_block_int8": gravnet_block_int8_cuda,
                "knn_build": knn_build_cuda,
                "knn_aggregate": knn_aggregate_cuda,
                "edge_aggregate": edge_aggregate_cuda,
                "flash_attention": flash_attention_cuda}
    plain_fns = {"fused_dense": ref.fused_dense_ref,
                 "gravnet_block": ref.gravnet_block_ref,
                 "fused_dense_int8": ref.fused_dense_int8_ref,
                 "gravnet_aggregate": ref.gravnet_aggregate_ref,
                 "gravnet_block_int8": ref.gravnet_block_int8_ref,
                 "knn_build": ref.knn_build_ref,
                 "knn_aggregate": ref.knn_aggregate_ref,
                 "edge_aggregate": ref.edge_aggregate_ref,
                 "flash_attention": ref.flash_attention_blocked_ref}

    @contextmanager
    def substituted(fns):
        """Swap the kernel wrappers that kernels/ops.py calls for
        ``fns[name]``; restore them afterwards."""
        saved = {n: getattr(kops, f"{n}_cuda") for n in fns}
        try:
            for n, fn in fns.items():
                setattr(kops, f"{n}_cuda", fn)
            yield
        finally:
            for n, fn in saved.items():
                setattr(kops, f"{n}_cuda", fn)

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0
        flash_attention_cuda.launches_by_blocks.clear()

    def read_counts():
        return {n: w.launches for n, w in wrappers.items()}

    # a kernel's records in the profiler: its __global__ function (or the
    # shared-memory one), once per launch; flash_attention's template
    # arguments name its (bq, bk), its combine launch is not counted
    kernel_rx = {n: re.compile(rf"(?<!\w){n}(?:_shared)?_kernel(?!\w)")
                 for n in wrappers}
    flash_rx = re.compile(r"flash_attention_kernel<\w+, (\d+), (\d+),")

    def counted(call, warm, label):
        """The main path's counted run: ``call()`` under torch.profiler,
        every counter at 0 just before it (a step of ``warm()`` first,
        whose records are dropped: the tracer may lose its first ones).
        Returns (its result, {kernel: launches}, {(bq, bk): launches} of
        flash_attention) as the profiler saw the kernels run on the card;
        fails unless the wrappers' counters, which a replay adds to by
        what its capture recorded, read the same."""
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(
                activities=acts, schedule=torch.profiler.schedule(
                    wait=0, warmup=1, active=1, repeat=1)) as prof:
            warm()
            torch.cuda.synchronize()
            prof.step()
            # a margin at each edge of the active window: a kernel that
            # ran just past its start was once dropped as before it
            time.sleep(PROFILE_MARGIN_S)
            reset_counts()
            out = call()
            torch.cuda.synchronize()
            counters = read_counts()
            by_blocks = dict(flash_attention_cuda.launches_by_blocks)
            time.sleep(PROFILE_MARGIN_S)
            prof.step()
        seen = dict.fromkeys(wrappers, 0)
        seen_blocks: dict[tuple, int] = {}
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            for n, rx in kernel_rx.items():
                seen[n] += bool(rx.search(e.name))
            m = flash_rx.search(e.name)
            if m:
                bq_bk = (int(m[1]), int(m[2]))
                seen_blocks[bq_bk] = seen_blocks.get(bq_bk, 0) + 1
        if seen != counters or seen_blocks != by_blocks:
            # every device record of the window, for the diagnosis
            tag = re.sub(r"\W+", "_", label)
            (OUT / f"profile_mismatch_{tag}.json").write_text(json.dumps([
                 (e.name, e.time_range.start, e.time_range.end,
                  e.device_index, str(e.device_type)) for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA],
                 indent=0))
            fail(f"[{label}] the profiler saw {seen} {seen_blocks} kernel "
                 f"runs, the launch counters read {counters} {by_blocks}")
        say(f"[{label}] profiler: kernel runs on the card equal the launch "
            f"counters: {({n: c for n, c in seen.items() if c})}"
            + (f" {seen_blocks}" if seen_blocks else ""))
        return out, seen, seen_blocks

    cfg = ccn.CCNConfig()
    gen_cfg = Belle2Config()

    def deploy(**kw):
        pipe = serve.build_pipeline(cfg, gen_cfg, device=dev, **kw)
        shown = {k: v for k, v in kw.items() if k != "params"}
        weights = "trained" if kw.get("params") is not None else "random"
        say(f"deployed upgrade CaloClusterNet (n_hits={cfg.n_hits}, "
            f"d_hidden={cfg.d_hidden}, {weights} weights) {shown}: "
            f"microbatch={pipe.microbatch}")
        return pipe

    # the paths: (name, deploy kwargs)
    paths = {
        "mixed": dict(design_point=3, precision="mixed"),
        "fp": dict(design_point=3, precision="fp"),
        "mixed_no_fuse_int8": dict(design_point=3, precision="mixed",
                                   fuse_int8=False),
        "fp_dp1": dict(design_point=1, precision="fp"),
        "ragged": dict(design_point=3, precision="fp", ragged=True,
                       batch=RAGGED_BINS),
        "ragged_dp1": dict(design_point=1, precision="fp", ragged=True,
                           batch=RAGGED_BINS),
    }
    reset_counts()
    pipes = {name: deploy(**kw) for name, kw in paths.items()}
    calib_launches = read_counts()
    say(f"launches while deploying and calibrating on the card: "
        f"{calib_launches}")

    # 3. kernels against their plain versions ----------------------------
    calib = generate(gen_cfg, 64, seed=123)
    calib_feeds = {"hits": calib["feats"], "mask": calib["mask"]}

    def record(pipe, feeds=calib_feeds):
        """The kernel calls of ``pipe`` over ``feeds`` (the 64-event
        calibration batch unless given), made with the plain versions;
        returns (calls, calls per chunk)."""
        calls: list[tuple[str, tuple, dict]] = []

        def recorder(name):
            def rec(*args, **kw):
                calls.append((name, args, kw))
                return plain_fns[name](*args, **kw)
            return rec

        with substituted({n: recorder(n) for n in plain_fns}):
            pipe.run_eager(feeds)
        n_chunks = len(next(iter(feeds.values()))) // pipe.microbatch
        if len(calls) % n_chunks:
            fail(f"{len(calls)} kernel calls over {n_chunks} chunks")
        return calls, len(calls) // n_chunks

    def stacked(calls, per_chunk, mb, pos, n_events):
        """The pos-th call of a chunk, with the event inputs of the
        first n_events events (whole chunks) stacked."""
        parts = [calls[c * per_chunk + pos] for c in range(n_events // mb)]
        name, args0, kw = parts[0]
        if len(parts) == 1:   # as the path gave them (a strided x stays)
            return name, list(args0), kw
        args = list(args0)
        for i in range(EVENT_ARGS[name]):
            args[i] = torch.cat([p[1][i] for p in parts])
        return name, args, kw

    timer = Timer(torch)
    results = {k: {"max_abs_err": 0.0, "per_launch": []} for k in KERNELS}

    def check(path, pos, n_events, name, args, kw):
        """One kernel call against its plain version on the same inputs:
        every float output within the float32 row (the bfloat16 row for
        bf16 outputs; every element equal for the kernels of
        ``BITWISE``), every integer output (knn_build's idx) bitwise; then
        the times and the bound. ``splits`` in ``kw`` goes to the kernel
        alone."""
        kern, plain = wrappers[name], plain_fns[name]
        bitwise = name in BITWISE
        plain_kw = {k_: v_ for k_, v_ in kw.items() if k_ != "splits"}
        try:
            got = kern(*args, **kw)
            torch.cuda.synchronize()
        except (RuntimeError, ValueError, TypeError) as e:
            fail(f"{name} did not launch: {e}")
        want = plain(*args, **plain_kw)
        bf16 = (want if torch.is_tensor(want) else want[0]).dtype \
            == torch.bfloat16
        rtol, atol = (BF16_RTOL, BF16_ATOL) if bf16 else (RTOL, ATOL)
        gots = got if isinstance(got, tuple) else (got,)
        wants = want if isinstance(want, tuple) else (want,)
        shape = shape_of(name, args, kw)
        if name.startswith("knn"):
            b_, n_ = args[0].shape[:2]
            bm_, cell_ = (knn_mod.build_plan(n_, b_) if name == "knn_build"
                          else knn_mod.aggregate_plan(n_, b_,
                                                      args[0].shape[2]))
            shape += f" (plan: {bm_} rows a CTA, {cell_} cell)"
        max_err, n_equal, n_all = 0.0, 0, 0
        for g_, w_ in zip(gots, wants, strict=True):
            if g_.dtype != w_.dtype or g_.shape != w_.shape:
                fail(f"{name}: kernel gives {g_.dtype} {tuple(g_.shape)}, "
                     f"plain version {w_.dtype} {tuple(w_.shape)}")
            g64, w64 = g_.double(), w_.double()
            err = (g64 - w64).abs()
            excess = (err - (atol + rtol * w64.abs())).max().item()
            if not g_.is_floating_point() and not torch.equal(g_, w_):
                excess = 1.0       # integer outputs are held bitwise
            max_err = max(max_err, err.max().item())
            n_equal += int((g_ == w_).sum().item())
            n_all += g_.numel()
            if not np.isfinite(max_err) or excess > 0:
                fail(f"{name} at {shape} disagrees with its plain version: "
                     f"max|err|={max_err:.3e} (tolerance {atol:g} + "
                     f"{rtol:g}·|want|, integer outputs bitwise)")
        exact = n_equal / max(n_all, 1)
        if bitwise and n_equal != n_all:
            fail(f"{name} at {shape} is not bitwise equal to its plain "
                 f"version: {exact:.2%} of elements equal, max|err|="
                 f"{max_err:.3e}")
        lib_ms, lib_name = None, None
        if name == "fused_dense":
            x, w, b = args[:3]
            act = kw.get("activation", "relu")

            def lib(x=x, w=w, b=b, act=act):
                y = x @ w if b is None else torch.addmm(b, x, w)
                return torch.relu_(y) if act == "relu" else y
            lib_ms, lib_name = timer.device_ms(lib, 200), "addmm+relu"
        elif name == "fused_dense_int8":
            x, w = args[0], args[1]
            try:
                torch._int_mm(x, w)
                torch.cuda.synchronize()
            except RuntimeError:
                lib_name = "torch._int_mm refuses this shape"
            else:
                lib_ms = timer.device_ms(lambda: torch._int_mm(x, w), 200)
                lib_name = "torch._int_mm (int8 product only, no epilogue)"
        elif name == "edge_aggregate":
            # one call on the edges filtered (and, for sum, weighted)
            # beforehand, untimed: index_add_ of mask·msg for sum; for
            # mean, where every mask is 0 or 1, index_reduce_('mean',
            # include_self=False) of the unmasked edges, which leaves a
            # node without edges at 0 as max(count, 1) does
            msg, dst, mask = args[:3]
            n, mean = kw["n_nodes"], kw.get("reduce") == "mean"
            keep = (dst >= 0) & (dst < n)
            if mean:
                keep &= mask > 0
            rows = (dst.long() + n * torch.arange(
                msg.shape[0], device=dev)[:, None])[keep]
            acc = torch.zeros((msg.shape[0] * n, msg.shape[2]), device=dev)
            lib = None
            if not mean:
                wmsg = (mask[..., None] * msg)[keep]

                def lib():
                    return acc.index_add_(0, rows, wmsg)
                lib_name = ("Tensor.index_add_ of the mask-weighted "
                            "messages (atomic, no fixed order; the "
                            "weighting not timed)")
            elif bool(((mask == 0) | (mask == 1)).all()):
                kmsg = msg[keep]

                def lib():
                    return acc.index_reduce_(0, rows, kmsg, "mean",
                                             include_self=False)
                lib_name = ("Tensor.index_reduce_('mean', include_self="
                            "False) of the unmasked messages (atomic, no "
                            "fixed order; the filtering not timed)")
            else:
                lib_name = ("none for mean over fractional masks (no "
                            "single PyTorch call)")
            if lib is not None:
                # an atomic sum in another order differs by rounding steps
                # of its partial sums: held to the float32 row of the
                # terms' magnitudes summed (the largest-E input sums ~225
                # terms a node, some near 0), the kernel itself bitwise
                lib_err = (lib().view_as(want) - want).abs()
                scale = plain(msg.abs(), dst, mask.abs(), **plain_kw)
                if not bool((lib_err <= ATOL + RTOL * scale).all()):
                    fail(f"{name} at {shape}: the library call timed "
                         f"beside it computes another function (max|err|="
                         f"{lib_err.max().item():.3e})")
                lib_ms = timer.device_ms(lib, 200)
        reps = 200
        if name == "flash_attention":
            # up to 17 ms a launch: ~0.4 s of launches per timing
            reps = max(5, min(200, int(400.0 / timer.once_ms(
                lambda: kern(*args, **kw)))))
            # SDPA, top-left causal like the reference where S == T; a
            # yardstick only: it may round otherwise, so it is held to
            # 1e-3 in f32 and to the bfloat16 row in bf16 (it computes
            # the same function) and its error printed
            q, k, v = args[:3]
            causal = kw.get("causal", True)
            if q.shape[1] == k.shape[1] or not causal:
                def lib(q=q, k=k, v=v, causal=causal):
                    return F.scaled_dot_product_attention(
                        q, k, v, is_causal=causal)
                lib_err = (lib().float() - want.float()).abs().max().item()
                lib_tol = 1e-3 if q.dtype == torch.float32 else atol
                if not lib_err <= lib_tol:
                    fail(f"{name} at {shape}: scaled_dot_product_attention "
                         f"computes another function (max|err|="
                         f"{lib_err:.3e})")
                lib_ms = timer.device_ms(lib, reps)
                lib_name = (f"F.scaled_dot_product_attention(is_causal="
                            f"{causal}), {str(q.dtype)[6:]}, max|err| "
                            f"{lib_err:.3e} against the plain version")
        ms = timer.device_ms(lambda: kern(*args, **kw), reps)
        plain_ms = timer.device_ms(lambda: plain(*args, **plain_kw), 3)
        nbytes, ops = cost(name, args, plain_kw)
        b_ms, b_by = bound(nbytes, ops)
        row = {"path": path, "op": pos, "events": n_events, "shape": shape,
               "max_abs_err": max_err, "exact_share": exact, "ms": ms,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "library": lib_name, "bound_ms": b_ms, "bound_by": b_by,
               "bytes": nbytes, "ops": ops}
        results[name]["per_launch"].append(row)
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"],
                                           max_err)
        say(f"{name} [{path}] events={n_events} {shape}: "
            f"max|err|={max_err:.3e} ({exact:.1%} bitwise) ms={ms:.5f} "
            f"plain_ms={plain_ms:.5f} library_ms="
            f"{'n/a' if lib_ms is None else f'{lib_ms:.5f}'} "
            f"bound_ms={b_ms:.7f} ({b_by})")

    # (path, which kernels, event counts to check them at: one chunk of
    # the path, a 16-event dispatch, the 64-event calibration batch)
    plan = [("mixed", None, CHECK_BATCHES),
            ("fp", None, CHECK_BATCHES),
            ("mixed_no_fuse_int8", {"fused_dense_int8"}, CHECK_BATCHES[:1]),
            ("mixed_no_fuse_int8", {"gravnet_aggregate"}, CHECK_BATCHES),
            ("fp_dp1", {"gravnet_aggregate"}, CHECK_BATCHES[:2])]
    per_chunk_calls = {}
    recorded = {}
    for path, only, batches in plan:
        pipe = pipes[path]
        if path not in recorded:
            recorded[path] = record(pipe)
        calls, per_chunk = recorded[path]
        per_chunk_calls[path] = [c[0] for c in calls[:per_chunk]]
        for pos in range(per_chunk):
            if only is not None and calls[pos][0] not in only:
                continue
            for n_ev in (pipe.microbatch, *batches[1:]):
                check(path, pos, n_ev,
                      *stacked(calls, per_chunk, pipe.microbatch, pos, n_ev))
            if path == "fp" and calls[pos][0] == "gravnet_block":
                # one event of the chunk: the per-event TPU kernel's form
                name, args, kw = calls[pos]
                check(path, pos, 1, name,
                      [a[:1] if i < EVENT_ARGS[name] else a
                       for i, a in enumerate(args)], kw)
    del recorded

    # the int8 pair at the current detector's shapes (32 hits: its mixed
    # deployment's calls on its own calibration batch) and on the inputs
    # that stress their designs (kernels/int8_cases.py), bitwise
    cur_cfg, cur_gen = serve.detector_configs("current")
    cur_pipe = serve.build_pipeline(cur_cfg, cur_gen, device=dev,
                                    design_point=3, precision="mixed")
    say(f"deployed current-detector CaloClusterNet (n_hits="
        f"{cur_cfg.n_hits}, mixed, design point 3): microbatch="
        f"{cur_pipe.microbatch}")
    cur_fp = serve.build_pipeline(cur_cfg, cur_gen, device=dev,
                                  design_point=3, precision="fp")
    for tag, pipe in (("mixed_current", cur_pipe), ("fp_current", cur_fp)):
        cur_calls, cur_per_chunk = record(
            pipe, serve.calibration_feeds(cur_gen))
        for pos in range(cur_per_chunk):
            for n_ev in (pipe.microbatch, *CHECK_BATCHES[1:]):
                check(tag, pos, n_ev, *stacked(
                    cur_calls, cur_per_chunk, pipe.microbatch, pos, n_ev))
        del cur_calls

    def as_args(arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                if isinstance(a, np.ndarray) else a for a in arrays]

    for case, (b, n, n_valid, dup) in int8_cases.BLOCK_CASES.items():
        for tag, widths, k_ in (("", INT8_WIDTHS, cfg.k),
                                (" smoke widths", SMOKE_WIDTHS, 4)):
            ops_, scales = int8_cases.block_inputs(
                b, n, **widths, seed=len(case), n_valid=n_valid, dup=dup)
            check(f"edge:{case}{tag}", 0, b, "gravnet_block_int8",
                  as_args(ops_), dict(scales, k=k_))
    # x's quantizations (into xq and into h) on the quotients where the
    # kernels' division-free quotient (csrc/int8_quant.cuh) could round
    # otherwise than the division: ties of rint, float midpoints,
    # subnormal quotients (its division fallback), the clip, ±inf
    for tag, widths, k_ in (("", INT8_WIDTHS, cfg.k),
                            (" smoke widths", SMOKE_WIDTHS, 4)):
        ops_, scales = int8_cases.quotient_edges(*int8_cases.block_inputs(
            2, cfg.n_hits, **widths, seed=5, n_valid=cfg.n_hits * 3 // 4),
            seed=5)
        check(f"edge:quotients{tag}", 0, 2, "gravnet_block_int8",
              as_args(ops_), dict(scales, k=k_))
    for case, (m, kd, n, act, out8) in int8_cases.DENSE_CASES.items():
        ops_, out_scale = int8_cases.dense_inputs(m, kd, n, seed=len(case))
        check(f"edge:{case}", 0, 1, "fused_dense_int8", as_args(ops_),
              dict(activation=act, out_int8=out8, out_scale=out_scale))
    # the f32 dense on the inputs that stress its design
    # (kernels/f32_cases.py): K past the staging limit, row-strided x,
    # N and M off every tile; and each tile's shared-memory plan against
    # the built library's own
    for case, (m, kd, n, ldx, act, bias) in f32_cases.DENSE_CASES.items():
        x, w, b = as_args(f32_cases.dense_inputs(m, kd, n, ldx=ldx,
                                                 bias=bias, seed=len(case)))
        check(f"edge:{case}", 0, 1, "fused_dense", [x[:, :kd], w, b],
              dict(activation=act))
    # the f32 GravNet pair on the inputs that stress their designs
    # (kernels/f32_cases.py): ties, 1 to 600 hits, fewer valid hits than
    # k, a masked event, k past n, d_s 1 and 9, d_f 1 to 129, 1 to 64
    # events, both cells; and each shape's shared-memory plan against the
    # built library's own
    for case, (b, n, dh, ds, df, dout, k_, nv, dup,
               masked) in f32_cases.GRAVNET_CASES.items():
        kw_ = dict(seed=len(case), n_valid=nv, dup=dup, masked_event=masked)
        check(f"edge:{case}", 0, b, "gravnet_block", as_args(
            f32_cases.block_inputs(b, n, dh=dh, ds=ds, df=df, dout=dout,
                                   **kw_)), {"k": k_})
        check(f"edge:{case}", 0, b, "gravnet_aggregate", as_args(
            f32_cases.aggregate_inputs(b, n, ds=ds, df=df, **kw_)),
            {"k": k_})
        bm, cell = block_mod.plan(n, dh, ds, df, dout)
        want = block_mod.smem_bytes(n, dh, ds, df, dout, bm, cell)
        if block_mod.library_smem_bytes(n, dh, ds, df, dout, bm) != want:
            fail(f"gravnet_block: {case} plans {want} B of shared memory "
                 f"({cell} cell, bm {bm}), the library "
                 f"{block_mod.library_smem_bytes(n, dh, ds, df, dout, bm)}")
        if agg_mod.library_smem_bytes(n, ds, df) != agg_mod.smem_bytes(
                n, ds, df):
            fail(f"gravnet_aggregate: {case} plans "
                 f"{agg_mod.smem_bytes(n, ds, df)} B of shared memory, the "
                 f"library {agg_mod.library_smem_bytes(n, ds, df)}")
    say(f"gravnet_block, gravnet_aggregate: the shared-memory plans of the "
        f"{len(f32_cases.GRAVNET_CASES)} edge cases equal the library's")
    plan_ks = sorted({c[1] for c in f32_cases.DENSE_CASES.values()}
                     | {4, 8, 32, 64, 108, 192})
    for v in range(len(dense_mod.TILES)):
        for kd in plan_ks:
            if dense_mod.library_smem_bytes(v, kd) != dense_mod.smem_bytes(
                    v, kd):
                fail(f"fused_dense: tile {v} at K={kd} plans "
                     f"{dense_mod.smem_bytes(v, kd)} B of shared memory, "
                     f"the library {dense_mod.library_smem_bytes(v, kd)}")
    say(f"fused_dense: the {len(dense_mod.TILES)} tiles' shared-memory "
        f"plans equal the library's at K {plan_ks}")

    # the ragged path: its kernel calls while serving its events, made
    # with the plain versions (whose results phase 6 holds the kernels'
    # to); the kNN pair checked at 1, 8 and 16 bins of real packing
    rg_events = generate(with_occupancy(gen_cfg, RAGGED_OCCUPANCY),
                         RAGGED_EVENTS, seed=7)
    rg_feeds = {"hits": rg_events["feats"], "mask": rg_events["mask"]}
    rg_counts = rg_events["mask"].sum(axis=1).astype(int)

    def ragged_launches(pipe, n_events):
        """Launches of the ragged executable while serve_events serves
        the first n_events, max(microbatch, 16) per call."""
        step = max(pipe.microbatch, serve.MIN_SERVE_BATCH)
        return sum(len(pipe._plan_launches(
            rg_counts[s:min(s + step, n_events)]))
            for s in range(0, n_events, step))

    def record_ragged(path, n_events):
        calls: list[tuple[str, tuple, dict]] = []

        def recorder(name):
            def rec(*args, **kw):
                calls.append((name, args, kw))
                return plain_fns[name](*args, **kw)
            return rec

        with substituted({n: recorder(n) for n in plain_fns}):
            res, _, _ = serve.serve_events(
                Eager(pipes[path]),
                {k: v[:n_events] for k, v in rg_feeds.items()})
        n_launch = ragged_launches(pipes[path], n_events)
        if len(calls) % n_launch:
            fail(f"[{path}] {len(calls)} kernel calls over {n_launch} "
                 "launches")
        per_launch = len(calls) // n_launch
        per_chunk_calls[path] = [c[0] for c in calls[:per_launch]]
        return calls, per_launch, res

    rg_plain = {}
    for path, n_ev in (("ragged", RAGGED_EVENTS),
                       ("ragged_dp1", SHORT_EVENTS)):
        calls, per_launch, rg_plain[path] = record_ragged(path, n_ev)
        for pos in range(per_launch):
            name = calls[pos][0]
            if not name.startswith("knn") and path != "ragged":
                continue
            for nb in (RAGGED_CHECK_BINS if name.startswith("knn")
                       and path == "ragged" else (RAGGED_BINS,)):
                if nb < RAGGED_BINS:
                    _, args, kw = calls[pos]
                    args = [a[:nb] if i < EVENT_ARGS[name] else a
                            for i, a in enumerate(args)]
                else:
                    _, args, kw = stacked(calls, per_launch, RAGGED_BINS,
                                          pos, nb)
                check(path, pos, nb, name, args, kw)
        del calls
    # the kNN pair on the inputs that stress their designs
    # (kernels/f32_cases.py): bins of 1-3 events, spent slots, an
    # all-padding bin, coincident rows, ties, 40 to 600 rows, d_s 3 and
    # 12, d_f 22 and 129, indices outside [0, n), k 40; both paths of each
    # source; and each shape's shared-memory plan against the built
    # library's own
    for case, (bins, n, ds, df, k_, values, dup,
               corrupted) in f32_cases.KNN_CASES.items():
        s_, seg = f32_cases.knn_build_inputs(bins, n, ds, k_, values, dup,
                                             seed=len(case))
        check(f"edge:{case}", 0, len(bins), "knn_build", as_args([s_, seg]),
              {"k": k_})
        idx, d2 = ref.knn_build_ref(torch.from_numpy(s_),
                                    torch.from_numpy(seg), k=k_)
        f_, idx = f32_cases.knn_aggregate_inputs(idx.numpy(), n, df,
                                                 corrupted, seed=len(case))
        check(f"edge:{case}", 0, len(bins), "knn_aggregate",
              as_args([f_, idx, d2.numpy()]), {})
        for name, mine, lib_ in (
                ("knn_build", knn_mod.build_smem_bytes(n, ds),
                 knn_mod.library_build_smem_bytes(n, ds)),
                ("knn_aggregate", knn_mod.aggregate_smem_bytes(n, df),
                 knn_mod.library_aggregate_smem_bytes(n, df))):
            if mine != lib_:
                fail(f"{name}: {case} plans {mine} B of shared memory, the "
                     f"library {lib_}")
    say(f"knn_build, knn_aggregate: the {len(f32_cases.KNN_CASES)} edge "
        "cases bitwise; their shared-memory plans equal the library's")

    def captured(tool, argv, label):
        """Run a measuring tool's main in this process, its output into
        the log; fail if it exits otherwise than with 0."""
        buf = io.StringIO()
        try:
            with redirect_stdout(buf):
                rc = tool.main(argv)
        except SystemExit as e:
            rc = e.code
        for line in buf.getvalue().splitlines():
            say(f"  [{label}] {line}")
        if rc not in (0, None):
            fail(f"{label} {' '.join(argv)}: {rc}")

    # the kNN pair against the first design (the kernel it replaced,
    # each source's second path: its C entry at 32 rows a CTA), both
    # held bitwise, timed in turns at 1, 8 and 16 bins; then where a CTA
    # of each spends its time (the launch counts are not read here)
    captured(source_ab, ["--earlier", str(_build.CSRC), "--kernels",
                         "knn_build", "knn_aggregate", "--out",
                         str(OUT / "source_ab_knn.json")], "source_ab")
    ab = json.loads((OUT / "source_ab_knn.json").read_text())["rows"]
    for r in ab:
        say(f"{r['kernel']} at {r['shape']}: first design "
            f"{r['earlier_ms']:.5f} ms, register cell {r['current_ms']:.5f} "
            f"ms ({r['earlier_ms'] / r['current_ms']:.2f}x, "
            + ("faster)" if r["current_ms"] < r["earlier_ms"]
               else "NOT faster)"))
    for kname in ("knn_build", "knn_aggregate"):
        captured(phase_split, ["--kernel", kname], f"phase_split {kname}")
    main_chunk = per_chunk_calls["mixed"]
    if (main_chunk.count("fused_dense_int8"),
            main_chunk.count("gravnet_block_int8"),
            len(main_chunk)) != (5, 2, 7):
        fail(f"a main-path chunk calls {main_chunk}, expected 5 "
             "fused_dense_int8 and 2 gravnet_block_int8")
    say(f"phase 3 done at {time.perf_counter() - t_start:.1f}s")

    def heads_and_cps(res, want, n_events, label, bitwise,
                      every_cps=False):
        for h in ("beta", "coords", "energy", "cls"):
            got, ref_ = res[h], want[h]
            if not np.isfinite(got).all() or got.shape != (
                    n_events, cfg.n_hits, cfg.head_dims[h]):
                fail(f"{label} head {h}: shape {got.shape} or non-finite")
            err = np.abs(got - ref_)
            if (not np.array_equal(got, ref_)) if bitwise else (
                    err > ATOL + RTOL * np.abs(ref_)).any():
                fail(f"{label} head {h}: kernels vs plain versions "
                     f"max|err|={err.max():.3e}")
            say(f"{label} head {h}: kernels vs plain max|err|="
                f"{err.max():.3e}")
        for k in (sorted(want["cps"]) if every_cps
                  else ("trigger", "n_clusters", "cluster_valid")):
            if not np.array_equal(res["cps"][k], want["cps"][k]):
                fail(f"{label} cps {k} differs between kernels and plain "
                     "versions")

    def run_path(path, n_events, seed):
        """Serve n_events of the path, timed, then once more as its
        counted run (``counted``); returns (the counted run's results,
        the timed run's latencies and elapsed, the launches the profiler
        saw, feeds, events)."""
        pipe = pipes[path]
        events = generate(gen_cfg, n_events, seed=seed)
        feeds = {"hits": events["feats"], "mask": events["mask"]}

        def warm():
            serve.serve_events(pipe, {k: v[:32] for k, v in feeds.items()})
        warm()
        torch.cuda.synchronize()
        _, lat, elapsed = serve.serve_events(pipe, feeds)
        (res, _, _), launches, _ = counted(
            lambda: serve.serve_events(pipe, feeds), warm, path)
        batch = max(pipe.microbatch, serve.MIN_SERVE_BATCH)
        n_chunks = sum(-(-min(batch, n_events - s) // pipe.microbatch)
                       for s in range(0, n_events, batch))
        say(f"[{path}] served {n_events} events in {n_chunks} chunks of "
            f"{pipe.microbatch}: launches {launches}")
        return res, lat, elapsed, launches, n_chunks, feeds, events

    path_launches = {}

    # 4. the main path on the card ----------------------------------------
    def serve_mixed(path, params=None):
        """Serve SERVE_EVENTS events of a mixed path (weights ``params``,
        default random from seed 0) with the counters at 0 just before:
        5 fused_dense_int8 and 2 gravnet_block_int8 per chunk, no other
        launch; calibration, heads and trigger decisions equal to the
        same deployment with the plain versions substituted, CPS on the
        card equal to CPS on the CPU. Returns (results, latencies,
        elapsed, events)."""
        res, lat, elapsed, launches, n_chunks, feeds, events = run_path(
            path, SERVE_EVENTS, seed=7)
        path_launches[path] = launches
        want = dict.fromkeys(wrappers, 0)
        want.update(fused_dense_int8=5 * n_chunks,
                    gravnet_block_int8=2 * n_chunks)
        if launches != want:
            fail(f"[{path}] launch counts {launches} != {want} (5 "
                 f"fused_dense_int8 and 2 gravnet_block_int8 per chunk, no "
                 f"fp dense, block or aggregate)")
        pipe = pipes[path]
        with substituted(plain_fns):
            plain_pipe = serve.build_pipeline(cfg, gen_cfg, device=dev,
                                              params=params,
                                              **paths["mixed"])
            plain_res, _, _ = serve.serve_events(Eager(plain_pipe), feeds)
        for op in pipe.graph:
            pop = plain_pipe.graph[op.name]
            for a in op.attrs:
                if a.endswith("_scale") and op.attrs[a] != pop.attrs[a]:
                    fail(f"[{path}] calibration: {op.name}.{a} "
                         f"{op.attrs[a]!r} with the kernels, "
                         f"{pop.attrs[a]!r} with the plain versions")
            for p in op.params or {}:
                if not torch.equal(op.params[p], pop.params[p]):
                    fail(f"[{path}] calibration: {op.name}/{p} differs")
        say(f"[{path}] calibration on the card: every activation scale and "
            "quantized weight equal to the plain versions'")
        heads_and_cps(res, plain_res, SERVE_EVENTS, path, bitwise=True)
        # CPS on the card against CPS on the CPU, on the card's heads
        cpu_cps = ccn.cps(
            {"beta_logit": torch.from_numpy(res["beta"][..., 0]),
             "coords": torch.from_numpy(res["coords"]),
             "energy": torch.from_numpy(res["energy"][..., 0])},
            torch.from_numpy(events["mask"]), cfg)
        for k in ("trigger", "n_clusters", "cluster_valid"):
            if not np.array_equal(res["cps"][k], cpu_cps[k].numpy()):
                fail(f"[{path}] cps {k} on the card differs from cps on "
                     "the CPU")
        eff, fake = serve.trigger_rates(res["cps"]["trigger"],
                                        events["trigger_truth"])
        batch = max(pipe.microbatch, serve.MIN_SERVE_BATCH)
        say(f"[{path}] trigger decisions bitwise equal to the plain path on "
            f"all {SERVE_EVENTS} events: efficiency={eff:.3f} "
            f"fake rate={fake:.3f}")
        say(f"serve ({path}, design point 3): "
            f"{SERVE_EVENTS / elapsed:.1f} events/s, latency "
            f"p50={np.percentile(lat, 50) * 1e6:.1f}us "
            f"p99={np.percentile(lat, 99) * 1e6:.1f}us "
            f"({batch} events per dispatch, {card})")
        return res, lat, elapsed, feeds

    res, lat, elapsed, feeds = serve_mixed("mixed")
    pipe = pipes["mixed"]
    batch = max(pipe.microbatch, serve.MIN_SERVE_BATCH)

    def idle_share(serve_once, label, tag):
        """The device's busy time and idle share over 4 calls of
        ``serve_once`` under torch.profiler; kernel sums go to
        profile{tag}.txt. Returns the busy µs and {kernel name: [µs,
        calls]}."""
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        # one warm-up step first: the tracer's first activity records
        # may be lost while it starts (2 kernels of 160 were, on a
        # replayed chunk), so only the 4 calls after it are read
        with torch.profiler.profile(
                activities=acts, schedule=torch.profiler.schedule(
                    wait=0, warmup=1, active=1, repeat=1)) as prof:
            serve_once()
            torch.cuda.synchronize()
            prof.step()
            time.sleep(PROFILE_MARGIN_S)    # as in ``counted``
            t0 = time.perf_counter()
            for _ in range(4):
                serve_once()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
            time.sleep(PROFILE_MARGIN_S)
            prof.step()
        kernels_us: dict[str, list] = {}
        for e in prof.events():
            # the step's annotation spans the window on the device's
            # timeline too: it is no kernel
            if e.device_type == torch.autograd.DeviceType.CUDA and not (
                    getattr(e, "is_user_annotation", False)
                    or e.name.startswith("ProfilerStep")):
                k = kernels_us.setdefault(e.name, [0.0, 0])
                k[0] += e.time_range.elapsed_us()
                k[1] += 1
        busy_us = sum(v[0] for v in kernels_us.values())
        top = sorted(kernels_us.items(), key=lambda kv: -kv[1][0])
        (OUT / f"profile{tag}.txt").write_text("".join(
            f"{us:12.1f} us {n:7d} calls  {name}\n"
            for name, (us, n) in top))
        if busy_us > 0:
            say(f"device busy {busy_us:.1f}us of {wall_us:.1f}us wall over "
                f"4 {label} (profiler on): idle share "
                f"{1 - busy_us / wall_us:.4f}")
            for name, (us, n) in top[:10]:
                say(f"  device {us:10.1f}us  calls {n:6d}  {name[:70]}")
        else:
            say("idle share: not measured (the profiler recorded no "
                "device time)")
        return busy_us, kernels_us, wall_us

    # where one served micro-batch's time goes, and the device idle share
    prof_feeds = {k: v[:batch] for k, v in feeds.items()}
    idle_share(lambda: serve.serve_events(pipe, prof_feeds),
               "served micro-batches", "")
    host = {}
    ex = pipe._ex
    run_op = ex.run_op

    def timed(op, vals, feeds_, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = run_op(op, vals, feeds_, **kw)
        torch.cuda.synchronize()
        host[op.op_type] = host.get(op.op_type, 0.0) + \
            time.perf_counter() - t
        return out
    ex.run_op = timed
    try:
        serve.serve_events(Eager(pipe), prof_feeds)
    finally:
        ex.run_op = run_op
    total = sum(host.values())
    say("per op type, one eager dispatch, synchronized after each op: "
        + ", ".join(f"{k}={v * 1e6:.1f}us ({v / total:.1%})"
                    for k, v in sorted(host.items(), key=lambda kv: -kv[1])))
    say(f"phase 4 done at {time.perf_counter() - t_start:.1f}s")

    # 4b. the default serve run: warm-training on the card, then the main
    # path with the trained weights -----------------------------------------
    t0 = time.perf_counter()
    trained, losses = serve.warm_train(cfg, gen_cfg, serve.TRAIN_STEPS,
                                       device=dev)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    loss_vals = [float(x) for x in losses]
    if len(loss_vals) != serve.TRAIN_STEPS \
            or not np.isfinite(loss_vals).all() \
            or not loss_vals[-1] < loss_vals[0]:
        fail(f"warm-training on the card: losses {loss_vals} (want "
             f"{serve.TRAIN_STEPS} finite, the last below the first)")
    for name, p_ in trained.items():
        for key, t_ in p_.items():
            if t_.device != dev or not bool(torch.isfinite(t_).all()):
                fail(f"warm-training: {name}/{key} on {t_.device} or "
                     "non-finite")
    say(f"warm-trained {serve.TRAIN_STEPS} steps on the card in "
        f"{t_train:.1f}s (autograd through CaloClusterNet.forward, no "
        f"kernel): loss {loss_vals[0]:.4f} -> {loss_vals[-1]:.4f}")
    reset_counts()
    pipes["mixed_trained"] = deploy(params=trained, **paths["mixed"])
    serve_mixed("mixed_trained", params=trained)
    say(f"phase 4b done at {time.perf_counter() - t_start:.1f}s")

    # 5. the other paths ----------------------------------------------------
    def other_path(path, n_events, per_chunk, redeploy):
        res, lat, elapsed, launches, n_chunks, feeds, _ = run_path(
            path, n_events, seed=17)
        path_launches[path] = launches
        want = dict.fromkeys(wrappers, 0)
        want.update({n: c * n_chunks for n, c in per_chunk.items()})
        if launches != want:
            fail(f"[{path}] launch counts {launches} != {want}")
        with substituted(plain_fns):
            pipe_ = (serve.build_pipeline(cfg, gen_cfg, device=dev,
                                          **paths[path])
                     if redeploy else pipes[path])
            plain_res, _, _ = serve.serve_events(Eager(pipe_), feeds)
        heads_and_cps(res, plain_res, n_events, path, bitwise=True)
        say(f"serve ({path}): {n_events / elapsed:.1f} events/s, latency "
            f"p50={np.percentile(lat, 50) * 1e6:.1f}us "
            f"p99={np.percentile(lat, 99) * 1e6:.1f}us")

    def per_chunk_of(path):
        calls = per_chunk_calls[path]
        return {n: calls.count(n) for n in set(calls)}

    if per_chunk_of("fp") != {"fused_dense": 5, "gravnet_block": 2}:
        fail(f"an fp chunk calls {per_chunk_calls['fp']}")
    other_path("fp", FP_EVENTS, per_chunk_of("fp"), redeploy=False)
    for path in ("fp_dp1", "mixed_no_fuse_int8"):
        pc = per_chunk_of(path)
        if pc.get("gravnet_aggregate") != 2 or "gravnet_block" in pc \
                or "gravnet_block_int8" in pc:
            fail(f"a {path} chunk calls {per_chunk_calls[path]}")
        other_path(path, SHORT_EVENTS, pc,
                   redeploy=paths[path]["precision"] == "mixed")
    say(f"phase 5 done at {time.perf_counter() - t_start:.1f}s")

    # 6. the ragged path ----------------------------------------------------
    heads = ("beta", "coords", "energy", "cls")

    def ragged_path(path, n_events):
        """Serve the first n_events of the ragged events, DISPATCH per
        call, with every counter at 0 just before; check the launch
        counts and hold heads and every CPS output bitwise to the
        plain-substituted run of phase 3."""
        pipe = pipes[path]
        feeds = {k: v[:n_events] for k, v in rg_feeds.items()}

        def warm():
            serve.serve_events(pipe, {k: v[:DISPATCH]
                                      for k, v in feeds.items()})
        warm()
        torch.cuda.synchronize()
        _, lat, elapsed = serve.serve_events(pipe, feeds)
        (res, _, _), launches, _ = counted(
            lambda: serve.serve_events(pipe, feeds), warm, path)
        path_launches[path] = launches
        n_launch = ragged_launches(pipe, n_events)
        g = pipe.pipe.graph
        dense = (sum(op.op_type in ("dense", "linear") for op in g)
                 + 3 * sum(op.op_type == "gravnet_block" for op in g))
        want = dict.fromkeys(wrappers, 0)
        want.update(fused_dense=dense * n_launch, knn_build=2 * n_launch,
                    knn_aggregate=2 * n_launch)
        if launches != want or per_chunk_calls[path].count("knn_build") != 2:
            fail(f"[{path}] launch counts {launches} != {want} ({dense} "
                 f"fused_dense, 2 knn_build, 2 knn_aggregate per launch)")
        say(f"[{path}] served {n_events} events in {n_launch} launches of "
            f"{RAGGED_BINS} bins: launches {launches}")
        heads_and_cps(res, rg_plain[path], n_events, path, bitwise=True,
                      every_cps=True)
        return res, lat, elapsed

    def against_padded(res, padded, n_events, label):
        """The real rows of every event within the float32 row of the
        padded path's, the rest zero; identical trigger decisions."""
        worst = 0.0
        for h in heads:
            for e, c in enumerate(rg_counts[:n_events]):
                got, want = res[h][e, :c], padded[h][e, :c]
                err = np.abs(got.astype(np.float64) - want)
                if (err > ATOL + RTOL * np.abs(want)).any() \
                        or res[h][e, c:].any():
                    fail(f"{label} head {h} event {e}: max|err| "
                         f"{err.max():.3e} against the padded fp path")
                worst = max(worst, float(err.max(initial=0.0)))
        if not np.array_equal(res["cps"]["trigger"],
                              padded["cps"]["trigger"][:n_events]):
            fail(f"{label}: trigger decisions differ from the padded path")
        say(f"{label} vs padded fp (design point 3) on {n_events} events: "
            f"real rows max|err|={worst:.3e}, trigger decisions identical")

    def rate(label, n_events, lat, elapsed, width=DISPATCH):
        say(f"serve ({label}): {n_events / elapsed:.1f} events/s, latency "
            f"p50={np.percentile(lat, 50) * 1e6:.1f}us "
            f"p99={np.percentile(lat, 99) * 1e6:.1f}us ({width} events "
            f"per call, {card})")

    rpipe = pipes["ragged"]
    res, lat, elapsed = ragged_path("ragged", RAGGED_EVENTS)
    serve.serve_events(pipes["fp"], {k: v[:DISPATCH] for k, v in
                                     rg_feeds.items()})
    padded, plat, pelapsed = serve.serve_events(pipes["fp"], rg_feeds)
    against_padded(res, padded, RAGGED_EVENTS, "ragged")
    # in turns: ragged, padded (above), padded, ragged
    _, plat2, pelapsed2 = serve.serve_events(pipes["fp"], rg_feeds)
    _, lat2, elapsed2 = serve.serve_events(rpipe, rg_feeds)
    for label, lt, el in (("ragged, design point 3, run 1", lat, elapsed),
                          ("padded fp, design point 3, run 1", plat,
                           pelapsed),
                          ("padded fp, design point 3, run 2", plat2,
                           pelapsed2),
                          ("ragged, design point 3, run 2", lat2, elapsed2)):
        rate(label, RAGGED_EVENTS, lt, el)
    say(f"ragged occupancy: {int(rg_counts.sum())} hits in "
        f"{RAGGED_EVENTS} events, {ragged_launches(rpipe, RAGGED_EVENTS)} "
        f"launches of {RAGGED_BINS}x{cfg.n_hits} rows")
    idle_share(lambda: serve.serve_events(
        rpipe, {k: v[:DISPATCH] for k, v in rg_feeds.items()}),
        "ragged calls of 16 events", "_ragged")
    res1, lat1, elapsed1 = ragged_path("ragged_dp1", SHORT_EVENTS)
    against_padded(res1, padded, SHORT_EVENTS, "ragged_dp1")
    rate("ragged, design point 1", SHORT_EVENTS, lat1, elapsed1)
    say(f"phase 6 done at {time.perf_counter() - t_start:.1f}s")

    # 7. the edge-based GNNs at their published widths ---------------------
    gnn_cfgs = {  # src/repro/configs/gatedgcn.py, graphsage_reddit.py
        "gatedgcn": gatedgcn.GatedGCNConfig(n_layers=16, d_hidden=70,
                                            d_in=8, d_edge_in=4,
                                            n_classes=2),
        "graphsage": graphsage.GraphSAGEConfig(n_layers=2, d_hidden=128,
                                               d_in=16, n_classes=5)}
    gnn_chunk_ms, gnn_feeds = {}, {}
    card_args = serve.parse_args(["--device", "cuda"])
    cpu_args = serve.parse_args(["--device", "cpu"])
    for gname, gcfg in gnn_cfgs.items():
        route = serve.MODELS[gname](card_args, gcfg)
        pipe = pipes[gname] = route.pipe
        mb = pipe.microbatch
        n_agg = sum(op.op_type == "edge_aggregate" for op in pipe.graph)
        if n_agg != (2 if gname == "gatedgcn" else 1) * gcfg.n_layers:
            fail(f"{gname}: {n_agg} edge_aggregate ops for "
                 f"{gcfg.n_layers} layers")
        say(f"deployed {gname} ({gcfg.n_layers} layers x {gcfg.d_hidden}, "
            f"d_in {gcfg.d_in}, {gcfg.n_classes} classes; graphs of "
            f"{serve._EDGE_N} nodes, {serve._EDGE_E} edges) at design "
            f"point 3, fp: microbatch={mb} segments={len(pipe.segments)}")
        # the path's kernel calls against their plain versions
        calls, per_chunk = record(pipe, route.events(16, 17)[0])
        per_chunk_calls[gname] = [c[0] for c in calls[:per_chunk]]
        for pos in range(per_chunk):
            name = calls[pos][0]
            for nb in (sorted({1, mb, 16}) if name == "edge_aggregate"
                       else (mb,)):
                if nb < mb:
                    _, args, kw = calls[pos]
                    args = [a[:nb] if i < EVENT_ARGS[name] else a
                            for i, a in enumerate(args)]
                else:
                    _, args, kw = stacked(calls, per_chunk, mb, pos, nb)
                check(gname, pos, nb, name, args, kw)
        del calls
        pc = {n: per_chunk_calls[gname].count(n)
              for n in set(per_chunk_calls[gname])}
        if set(pc) != {"fused_dense", "edge_aggregate"} \
                or pc["edge_aggregate"] != n_agg:
            fail(f"a {gname} chunk calls {pc}, expected {n_agg} "
                 "edge_aggregate and fused_dense only")
        # serve with every counter at 0 just before
        # at the width the reference's service serves its GNN routes
        # with: max(8, microbatch)
        batch = max(serve.MIN_ROUTES_BATCH, mb)
        feeds = gnn_feeds[gname] = route.events(GNN_EVENTS, 7)[0]

        def warm(pipe=pipe, feeds=feeds, batch=batch):
            pipe({k: v[:batch] for k, v in feeds.items()})
        warm()
        torch.cuda.synchronize()
        routed, elapsed = serve.serve_routes({gname: (pipe, feeds)}, batch)
        lat = routed[gname][1]
        (routed, _), launches, _ = counted(
            lambda pipe=pipe, feeds=feeds, batch=batch: serve.serve_routes(
                {gname: (pipe, feeds)}, batch), warm, gname)
        res = routed[gname][0]
        path_launches[gname] = launches
        n_chunks = sum(-(-min(batch, GNN_EVENTS - s) // mb)
                       for s in range(0, GNN_EVENTS, batch))
        want = dict.fromkeys(wrappers, 0)
        want.update({n: c * n_chunks for n, c in pc.items()})
        if launches != want:
            fail(f"[{gname}] launch counts {launches} != {want}")
        say(f"[{gname}] served {GNN_EVENTS} graphs, {batch} per dispatch, "
            f"in {n_chunks} chunks of {mb}: launches {launches} "
            f"({pc['edge_aggregate']} edge_aggregate and "
            f"{pc['fused_dense']} fused_dense per chunk)")
        logits = res["logits"]
        if logits.shape != (GNN_EVENTS, serve._EDGE_N, gcfg.n_classes) \
                or not np.isfinite(logits).all():
            fail(f"{gname} logits: shape {logits.shape} or non-finite")
        with substituted(plain_fns):
            plain_res = serve.serve_routes({gname: (Eager(pipe), feeds)},
                                           batch)[0][gname][0]
        if not np.array_equal(logits, plain_res["logits"]):
            err = np.abs(logits - plain_res["logits"]).max()
            fail(f"{gname} logits: kernels vs plain versions max|err|="
                 f"{err:.3e}, not bitwise")
        cpu_res, _, _ = serve.serve_events(
            serve.MODELS[gname](cpu_args, gcfg).pipe, feeds)
        want_cpu = cpu_res["logits"].astype(np.float64)
        err = np.abs(logits - want_cpu)
        if (err > ATOL + RTOL * np.abs(want_cpu)).any():
            fail(f"{gname} logits: max|err| {err.max():.3e} against the "
                 f"same deployment on the CPU (tolerance {ATOL:g} + "
                 f"{RTOL:g}·|cpu|)")
        say(f"{gname}: logits of {GNN_EVENTS} graphs bitwise equal to the "
            f"plain-substituted deployment on the card; max|err| "
            f"{err.max():.3e} against device='cpu' (tolerance {ATOL:g} + "
            f"{RTOL:g}·|cpu|)")
        rate(f"{gname}, design point 3, fp", GNN_EVENTS, lat, elapsed,
             batch)
        busy_us, by_kernel, _ = idle_share(
            lambda pipe=pipe, feeds=feeds: serve.serve_events(
                pipe, {k: v[:batch] for k, v in feeds.items()}),
            f"{gname} dispatches of {batch} graphs", f"_{gname}")
        # a chunk's device time: the two kernels' launches timed one by
        # one above (events at the path's micro-batch), beside the
        # library calls; and the profiled busy time of a served chunk
        rows_ = [r for n_ in ("fused_dense", "edge_aggregate")
                 for r in results[n_]["per_launch"]
                 if r["path"] == gname and r["events"] == mb]
        per = {n_: sum(r["ms"] for r in rows_
                       if per_chunk_calls[gname][r["op"]] == n_)
               for n_ in pc}
        lib_chunk = {n_: sum(r["library_ms"] or 0.0 for r in rows_
                             if per_chunk_calls[gname][r["op"]] == n_)
                     for n_ in pc}
        prof_chunks = 4 * -(-batch // mb)
        prof = {n_: sum(v[0] for k, v in by_kernel.items()
                        if f"{n_}_kernel" in k) / prof_chunks for n_ in pc}
        gnn_chunk_ms[gname] = {
            "kernels_ms": per, "library_ms": lib_chunk,
            "busy_ms": busy_us / prof_chunks / 1e3,
            "profiled_kernels_ms": {k: v / 1e3 for k, v in prof.items()}}
        say(f"[{gname}] device time per chunk of {mb} graphs: "
            + ", ".join(f"{n_} {per[n_]:.5f} ms ({pc[n_]} launches; "
                        f"library {lib_chunk[n_]:.5f})" for n_ in pc)
            + f" = {sum(per.values()):.5f} ms; profiled busy time "
            f"{busy_us / prof_chunks / 1e3:.5f} ms per chunk, of it "
            + ", ".join(f"{n_} {prof[n_] / 1e3:.5f}" for n_ in pc)
            + f" ({card})")

    # edge_aggregate on synthetic graphs of the routes' size: masked and
    # fractional edge weights, destinations outside [0, N)
    gen = torch.Generator().manual_seed(5)
    n_nodes, n_edges = serve._EDGE_N, serve._EDGE_E
    stray = torch.tensor([-1, n_nodes, n_nodes + 5, -n_nodes],
                         dtype=torch.int32)
    for d in EDGE_WIDTHS:
        for reduce in ("sum", "mean"):
            for nb in EDGE_BATCHES:
                msg = torch.randn(nb, n_edges, d, generator=gen)
                dst = torch.randint(0, n_nodes, (nb, n_edges), generator=gen,
                                    dtype=torch.int32)
                dst[:, ::16] = stray.repeat(n_edges // 64)
                mask = (torch.rand(nb, n_edges, generator=gen)
                        < 0.7).float()
                mask[:, 1::16] = 0.5
                check("synthetic", 0, nb, "edge_aggregate",
                      [msg.to(dev), dst.to(dev), mask.to(dev)],
                      {"n_nodes": n_nodes, "reduce": reduce})
    # and on the inputs that stress its design (kernels/f32_cases.py):
    # E past one warp round and past the staged plans, one node taking
    # every edge, every edge masked, every dst out of range, odd widths;
    # the shared-memory plans against the built library's own
    e_max = edge_mod.max_edges()
    for case, (nb, e, d, kind) in f32_cases.EDGE_CASES.items():
        for reduce in ("sum", "mean"):
            check(f"edge:{case}", 0, nb, "edge_aggregate", as_args(
                f32_cases.edge_inputs(nb, e or e_max, d, kind,
                                      seed=len(case))),
                  {"n_nodes": f32_cases.EDGE_NODES, "reduce": reduce})
    for e in (0, 1, 33, 256, 1000, e_max):
        for cw in (1, 2, 8, 16, 32):
            for staged in (False, True):
                if edge_mod.library_smem_bytes(e, cw, staged) \
                        != edge_mod.smem_bytes(e, cw, staged):
                    fail(f"edge_aggregate: E={e} cw={cw} staged={staged} "
                         f"plans {edge_mod.smem_bytes(e, cw, staged)} B, "
                         f"the library "
                         f"{edge_mod.library_smem_bytes(e, cw, staged)}")
    say(f"edge_aggregate: shared-memory plans equal the library's; the "
        f"largest E a launch takes: {e_max}")

    # the three routes through the serve entry point
    buf = io.StringIO()
    try:
        with redirect_stdout(buf):
            rc = serve.main(["--model", "ccn", "gatedgcn", "graphsage",
                             "--events", "48"])
    except SystemExit as e:
        rc = e.code
    for line in buf.getvalue().splitlines():
        say(f"  {line}")
    answered = [m for m in ("ccn", "gatedgcn", "graphsage")
                if f"route {m}: 16 events" in buf.getvalue()
                and re.search(rf"route {m}: .*answered=16 in-order=True",
                              buf.getvalue())]
    if rc != 0 or len(answered) != 3:
        fail(f"serve --model ccn gatedgcn graphsage: exit {rc}, routes that "
             f"answered all 16 of their events: {answered}")
    say(f"phase 7 done at {time.perf_counter() - t_start:.1f}s")

    # 8. the attention op and the tuning layer ------------------------------
    from repro_torch.core.graph_ir import Graph, Operator
    from repro_torch.core.pipeline import Requirements
    from repro_torch.core.pipeline import deploy as deploy_graph
    from repro_torch.tuning import (TuningCache, autotune_graph,
                                    flash_attention_key,
                                    graph_kernel_problems, warm_from_cache)
    from repro_torch.tuning.candidates import flash_attention_candidates
    t8 = time.perf_counter()
    gen = torch.Generator().manual_seed(11)

    def qkv(bh, s_len, t_len, d):
        return [torch.randn(bh, n, d, generator=gen).to(dev)
                for n in (s_len, t_len, t_len)]

    def padded(q, k, v, bq, bk):
        bq, bk = min(bq, q.shape[1]), min(bk, k.shape[1])
        return ([kops._pad_rows(q, bq).contiguous(),
                 kops._pad_rows(k, bk).contiguous(),
                 kops._pad_rows(v, bk).contiguous()], bq, bk)

    # (a) the kernel against its plain version: the float32 row (the
    # kernel runs on FMAs, in its own order), bf16 inputs the bfloat16 row;
    # where the wrapper splits the kv tiles, also unsplit, to time the split
    def flash_checks(args, kw):
        check("shapes", 0, args[0].shape[0], "flash_attention", args, kw)
        chunk, nsplit = kv_split(args[0].shape[0], args[0].shape[1],
                                 args[1].shape[1], bq=kw["bq"], bk=kw["bk"],
                                 n_sm=torch.cuda.get_device_properties(
                                     dev).multi_processor_count)
        if nsplit > 1:
            check("shapes", 0, args[0].shape[0], "flash_attention", args,
                  {**kw, "splits": 1})

    for bh, s_len, t_len, d in ATTN_SHAPES:
        args, bq, bk = padded(*qkv(bh, s_len, t_len, d), 128, 128)
        for a in (args, [x.to(torch.bfloat16) for x in args]):
            flash_checks(a, {"causal": True, "bq": bq, "bk": bk})
    base = qkv(8, 512, 512, 64)
    for a in (base, [x.to(torch.bfloat16) for x in base]):
        flash_checks(a, {"causal": False, "bq": 128, "bk": 128})
    q, k, v = qkv(8, 1000, 1000, 64)
    args, bq, bk = padded(q, k, v, 128, 128)
    check("shapes", 0, 8, "flash_attention", args,
          {"causal": True, "bq": bq, "bk": bk})
    cut = kops.flash_attention(q, k, v)
    want_cut = ref.flash_attention_blocked_ref(*args, bq=bq, bk=bk)[:, :1000]
    cut_err = (cut.double() - want_cut.double()).abs()
    if cut.shape != want_cut.shape or bool(
            (cut_err > ATOL + RTOL * want_cut.double().abs()).any()):
        fail("ops.flash_attention at S = 1000: the padded kernel's output "
             f"cut to S is not within the float32 row of the plain "
             f"version's (max|err| {cut_err.max().item():.3e})")
    cands = flash_attention_candidates(512, 512, 64)
    for c in cands:
        check("candidates", 0, 8, "flash_attention", base,
              {"causal": True, **c})
    for d in (8, 40, 64, 72, 128):
        for bq in (16, 32, 48, 64, 128, 256):
            for bk in (16, 32, 48, 64, 128, 256):
                if library_smem_bytes(bq, bk, d) != smem_bytes(bq, bk, d):
                    fail(f"flash_attention_smem_bytes({bq}, {bk}, {d}) = "
                         f"{library_smem_bytes(bq, bk, d)} in the library, "
                         f"{smem_bytes(bq, bk, d)} in Python")
    say(f"flash_attention: within the float32 row (bf16: the bfloat16 row) "
        f"at {len(ATTN_SHAPES) + 2} shapes and {len(cands)} block plans "
        f"{[(c['bq'], c['bk']) for c in cands]}; shared-memory plans agree "
        "with the library")

    # (b) the deployed attention graph
    def attention_graph():
        rng = np.random.default_rng(0)
        g = Graph()
        g.add(Operator(name="tok", op_type="input", out_dim=ATTN_D,
                       attrs={"feature": "tok"}))
        for nm in ("q", "k", "v"):
            w = rng.normal(size=(ATTN_D, ATTN_D)) / np.sqrt(ATTN_D)
            g.add(Operator(name=nm, op_type="linear", inputs=["tok"],
                           params={"w": torch.tensor(w, dtype=torch.float32),
                                   "b": torch.zeros(ATTN_D)},
                           out_dim=ATTN_D))
        g.add(Operator(name="attn", op_type="attention",
                       inputs=["q", "k", "v"], attrs={"causal": True},
                       out_dim=ATTN_D))
        g.add(Operator(name="out", op_type="output", inputs=["attn"],
                       attrs={"head_names": ["y"]}, out_dim=ATTN_D))
        return g

    attn_req = Requirements(design_point=3, platform="cpu",
                            precision_policy="fp", n_hits=ATTN_N,
                            target_throughput=1e3)

    def deploy_attention(device=dev, cache=None):
        return deploy_graph(attention_graph(), attn_req, batch=ATTN_BATCH,
                            tuning_cache=cache, device=device)

    apipe = pipes["attention"] = deploy_attention()
    tok = np.random.default_rng(1).normal(
        size=(ATTN_EVENTS, ATTN_N, ATTN_D)).astype(np.float32)
    afeeds = {"tok": tok}
    # the fusion pass merges the q, k, v denses, siblings on one input,
    # into one wider dense and slices, as the reference's does
    n_dense = sum(op.op_type in ("dense", "linear") for op in apipe.graph)
    calls, per_chunk = record(apipe, {"tok": tok[:2 * ATTN_BATCH]})
    per_chunk_calls["attention"] = [c[0] for c in calls[:per_chunk]]
    if sorted(per_chunk_calls["attention"]) != ["flash_attention"] + [
            "fused_dense"] * n_dense or n_dense == 0:
        fail(f"an attention chunk calls {per_chunk_calls['attention']}, "
             f"the graph has {n_dense} denses")
    for pos in range(per_chunk):
        check("attention", pos, ATTN_BATCH, *calls[pos])
    del calls

    def awarm():
        serve.serve_events(apipe, {"tok": tok[:DISPATCH]})
    awarm()
    torch.cuda.synchronize()
    _, alat, aelapsed = serve.serve_events(apipe, afeeds)
    (ares, _, _), launches, by_blocks = counted(
        lambda: serve.serve_events(apipe, afeeds), awarm, "attention")
    path_launches["attention"] = launches
    n_chunks = ATTN_EVENTS // ATTN_BATCH
    want = dict.fromkeys(wrappers, 0)
    want.update(flash_attention=n_chunks, fused_dense=n_dense * n_chunks)
    if launches != want or by_blocks != {(128, 128): n_chunks}:
        fail(f"[attention] launch counts {launches} {by_blocks} != {want} "
             f"(one flash_attention at (128, 128) and {n_dense} fused_dense "
             "per micro-batch)")
    y = ares["y"]
    if y.shape != (ATTN_EVENTS, ATTN_N, ATTN_D) or not np.isfinite(y).all():
        fail(f"attention output: shape {y.shape} or non-finite")
    with substituted(plain_fns):
        plain_y = serve.serve_events(Eager(apipe), afeeds)[0]["y"]
    perr = np.abs(y - plain_y.astype(np.float64))
    if (perr > ATOL + RTOL * np.abs(plain_y)).any():
        fail(f"attention output: kernels vs plain versions max|err|="
             f"{perr.max():.3e}, outside the float32 row")
    cpu_y = serve.serve_events(deploy_attention("cpu"), afeeds)[0]["y"]
    err = np.abs(y - cpu_y.astype(np.float64))
    if (err > ATOL + RTOL * np.abs(cpu_y)).any():
        fail(f"attention output: max|err| {err.max():.3e} against "
             f"device='cpu' (tolerance {ATOL:g} + {RTOL:g}·|cpu|)")
    say(f"[attention] served {ATTN_EVENTS} events (n {ATTN_N}, d {ATTN_D}) "
        f"in {n_chunks} micro-batches of {ATTN_BATCH}: launches {launches}; "
        f"output within the float32 row of the plain-substituted deployment"
        f" (max|err| {perr.max():.3e}) and of device='cpu' (max|err| "
        f"{err.max():.3e})")
    rate("attention, design point 3, fp, batch 8", ATTN_EVENTS, alat,
         aelapsed)
    idle_share(lambda: serve.serve_events(apipe, {"tok": tok[:DISPATCH]}),
               f"attention dispatches of {DISPATCH} events", "_attention")

    # (c) tuning: search, bind, launch, persist, warm
    cache = TuningCache()
    buf = io.StringIO()
    t_tune = time.perf_counter()
    with redirect_stdout(buf):
        n_att = autotune_graph(apipe.graph, n_rows=ATTN_N, backend="cuda",
                               cache=cache, batch=ATTN_BATCH, verbose=True)
        n_ccn = autotune_graph(pipes["mixed"].graph, n_rows=cfg.n_hits,
                               backend="cuda", cache=cache, verbose=True)
    for line in buf.getvalue().splitlines():
        say(f"  {line}")
    keys = (graph_kernel_problems(apipe.graph, n_rows=ATTN_N,
                                  backend="cuda", batch=ATTN_BATCH)
            + graph_kernel_problems(pipes["mixed"].graph,
                                    n_rows=cfg.n_hits, backend="cuda"))
    if n_att + n_ccn != len(set(keys)) or set(cache.entries()) != set(keys):
        fail(f"autotune_graph tuned {n_att} + {n_ccn} problems, the "
             f"deployments emit {len(set(keys))}")
    fkey = flash_attention_key(ATTN_BATCH, ATTN_N, ATTN_N, ATTN_D,
                               "float32", "cuda")
    fentry = cache.entry(fkey)
    if fentry is None or fentry.candidates != len(cands):
        fail(f"flash_attention's entry {fentry} did not search the "
             f"{len(cands)} kept plans")
    winner = (fentry.config["bq"], fentry.config["bk"])
    say(f"tuned {len(cache)} problems in {time.perf_counter() - t_tune:.1f}s"
        f"; flash_attention {fkey.encode()}: winner bq,bk={winner} "
        f"{fentry.us:.1f}us against the default's {fentry.default_us:.1f}us "
        f"(the card's clock: CUDA events around back-to-back calls; "
        f"{fentry.candidates} plans)")
    # the tuner's contract on the card: the bound winner's device time
    # is at most the default's (timed here in turns, default, winner,
    # winner, default, on the deployment's q, k, v shape)
    tq = qkv(ATTN_BATCH, ATTN_N, ATTN_N, ATTN_D)
    plans_ms = [timer.device_ms(lambda c=c: kops.flash_attention(
        *tq, causal=True, bq=c[0], bk=c[1]), 200)
        for c in ((128, 128), winner, winner, (128, 128))]
    default_ms = (plans_ms[0] + plans_ms[3]) / 2
    winner_ms = (plans_ms[1] + plans_ms[2]) / 2
    if winner != (128, 128) and not winner_ms <= default_ms:
        fail(f"the tuner bound {winner} at {winner_ms:.5f} ms of device "
             f"time, slower than the default (128, 128) at "
             f"{default_ms:.5f} ms")
    tuner_row = {"winner": list(winner), "winner_ms": winner_ms,
                 "default_ms": default_ms, "tuner_us": fentry.us,
                 "tuner_default_us": fentry.default_us}
    say(f"tuner row: the bound winner {winner} takes {winner_ms:.5f} ms of "
        f"device time a call (ops.flash_attention), the default (128, 128) "
        f"{default_ms:.5f} ms: "
        + ("the winner is the default" if winner == (128, 128)
           else "at most the default's") + f" ({card})")
    tpipe = deploy_attention(cache=cache)
    knobs = tpipe.graph["attn"].attrs_opt
    if (knobs.get("bq"), knobs.get("bk")) != winner:
        fail(f"the redeployed attention op binds {knobs}, the cache's "
             f"winner is {winner}")
    (tres, _, _), _, by_blocks = counted(
        lambda: serve.serve_events(tpipe, {"tok": tok[:DISPATCH]}),
        lambda: serve.serve_events(tpipe, {"tok": tok[:ATTN_BATCH]}),
        "attention, tuned")
    ty = tres["y"]
    if by_blocks != {winner: DISPATCH // ATTN_BATCH}:
        fail(f"the tuned deployment launched {by_blocks}, not the winner "
             f"{winner}")
    terr = np.abs(ty - y[:DISPATCH].astype(np.float64))
    if (terr > ATOL + RTOL * np.abs(y[:DISPATCH])).any():
        fail(f"the tuned deployment's output: max|err| {terr.max():.3e} "
             "against the untuned one")
    cache_path = OUT / "tuning_cache.json"
    cache.save(cache_path)
    back = TuningCache.load(cache_path)
    if back.load_error or {k: e.to_json() for k, e in back.entries().items()} \
            != {k: e.to_json() for k, e in cache.entries().items()}:
        fail(f"tuning cache round trip: {back.load_error or 'entries differ'}")
    warmed = warm_from_cache(back)
    if warmed != len(back):
        fail(f"warm_from_cache warmed {warmed} of {len(back)} entries")
    say(f"the redeployed attention op binds and launches {winner} "
        f"({by_blocks}); output within the float32 row of the untuned "
        f"deployment (max|err| {terr.max():.3e}); cache saved to "
        f"{cache_path.relative_to(ROOT)} and loaded back equal; "
        f"warm_from_cache warmed {warmed} of {len(back)}")

    # (d) the serve entry point: tune and save, then bind from the file
    serve_cache = OUT / "serve_tuning_cache.json"
    serve_cache.unlink(missing_ok=True)
    outs = []
    for extra in (["--tune"], []):
        buf = io.StringIO()
        try:
            with redirect_stdout(buf):
                rc = serve.main(extra + ["--tuning-cache", str(serve_cache),
                                         "--events", str(ATTN_EVENTS)])
        except SystemExit as e:
            rc = e.code
        for line in buf.getvalue().splitlines():
            say(f"  {line}")
        if rc != 0 or f"answered={ATTN_EVENTS} in-order=True" \
                not in buf.getvalue():
            fail(f"serve {' '.join(extra)} --tuning-cache: exit {rc}, not "
                 f"every one of {ATTN_EVENTS} events answered")
        outs.append(buf.getvalue())
    n_saved = len(TuningCache.load(serve_cache))
    if not re.search(r"autotuned [1-9]\d* kernel problem", outs[0]) \
            or "autotuned" in outs[1] or "[tune]" in outs[1] \
            or f"{n_saved} of {n_saved} kernel problems bound" not in outs[1]:
        fail("serve --tune then --tuning-cache: the first run must search "
             "and save, the second bind every problem without searching")
    say(f"serve: --tune searched and saved {n_saved} problems; the run on "
        "the saved cache bound all of them without searching")
    say(f"phase 8 done at {time.perf_counter() - t_start:.1f}s "
        f"({time.perf_counter() - t8:.1f}s)")

    # 9. the whole-pipeline compile: captured chunks against eager ones ---
    t9 = time.perf_counter()

    def leaves(tree, pre=""):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], f"{pre}/{k}")
        else:
            yield pre, tree

    def host_ms(call, feeds_dev, n_chunks):
        """Host wall per chunk of one dispatch: the call's time until it
        returns (its work enqueued), over its chunks; then a sync."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        call(feeds_dev)
        dt = time.perf_counter() - t
        torch.cuda.synchronize()
        return dt * 1e3 / n_chunks

    capture_rows = {}

    def captured_vs_eager(path, pipe, feeds, width):
        """Serve ``feeds`` through the captured deployment and through
        its eager run_chunk loop: every output bitwise equal; then in
        turns (captured, eager, eager, captured, captured, eager) the
        events/s, latency p50/p99 and the host wall per chunk of one
        dispatch (on device feeds; a ragged launch is its one chunk),
        and their medians."""
        n = len(next(iter(feeds.values())))
        eager = Eager(pipe)
        outs = [serve.serve_routes({path: (p, feeds)}, width)[0][path][0]
                for p in (pipe, eager)]
        a, b = (dict(leaves(o)) for o in outs)
        diff = sorted(k for k in a if not np.array_equal(a[k], b.get(k)))
        if set(a) != set(b) or diff:
            fail(f"[{path}] captured outputs differ from the eager run_chunk "
                 f"loop's: {diff or sorted(set(a) ^ set(b))}")
        unit = "chunk"
        if isinstance(pipe, RaggedPipeline):
            one = []    # the first launch's feeds of one dispatch
            pipe._launch({k: v[:width] for k, v in feeds.items()},
                         lambda f: one.append(f) or pipe.pipe(f))
            inner, hfeeds, chunks, unit = pipe.pipe, one[0], 1, "launch"
        else:
            inner, chunks = pipe, -(-width // pipe.microbatch)
            hfeeds = {k: v[:width] for k, v in feeds.items()}
        hfeeds = {k: torch.as_tensor(np.asarray(v)).to(dev)
                  for k, v in hfeeds.items()}
        calls = {"captured": (pipe, inner), "eager": (eager,
                                                      inner.run_eager)}
        stats = {"captured": [], "eager": []}
        for mode in ("captured", "eager", "eager", "captured", "captured",
                     "eager"):
            routed, elapsed = serve.serve_routes(
                {path: (calls[mode][0], feeds)}, width)
            lat = routed[path][1]
            stats[mode].append([
                n / elapsed, np.percentile(lat, 50) * 1e6,
                np.percentile(lat, 99) * 1e6,
                host_ms(calls[mode][1], hfeeds, chunks)])
        med = {m: dict(zip(("events_s", "p50_us", "p99_us",
                            "host_ms_per_chunk"),
                           np.median(np.array(v), axis=0).tolist()))
               for m, v in stats.items()}
        # of a captured chunk's host time, the replay of its graphs alone
        cap = next(iter(inner._graphs._by_sig.values()))
        med["captured"]["host_ms_replay"] = float(np.median([
            host_ms(lambda _: [g.replay() for g in cap.graphs], None, 1)
            for _ in range(5)]))
        capture_rows[path] = {**med, "events": n, "width": width,
                              "captures": pipe.captures,
                              "graphs_per_chunk": len(cap.graphs),
                              "runs": {m: v for m, v in stats.items()}}
        for m in ("captured", "eager"):
            r = med[m]
            say(f"[{path}] {m}: {r['events_s']:.1f} events/s, latency "
                f"p50={r['p50_us']:.1f}us p99={r['p99_us']:.1f}us, host "
                f"{r['host_ms_per_chunk']:.4f} ms per {unit}"
                + (f" (replaying its {len(cap.graphs)} graph(s) "
                   f"{r['host_ms_replay']:.4f})" if m == "captured" else "")
                + f" (median of 3; {n} events, {width} per dispatch, "
                f"{card})")
        return med

    cev = generate(gen_cfg, CAPTURE_EVENTS, seed=7)
    ccn_feeds = {"hits": cev["feats"], "mask": cev["mask"]}
    # the served default (warm-trained) first, with the profiler's
    # cross-check: its two kernels once per replay
    captured_vs_eager("mixed_trained", pipes["mixed_trained"], ccn_feeds,
                      DISPATCH)
    mt = pipes["mixed_trained"]
    disp = {k: v[:DISPATCH] for k, v in ccn_feeds.items()}
    replays = 4 * DISPATCH // mt.microbatch
    idle = {}
    for mode, p in (("captured", mt), ("eager", Eager(mt))):
        busy, by_kernel, wall = idle_share(
            lambda p=p: serve.serve_events(p, disp),
            f"{mode} dispatches of {DISPATCH} events (mixed, trained)",
            f"_mixed_{mode}")
        idle[mode] = {"busy_us": busy, "wall_us": wall,
                      "idle_share": 1 - busy / wall if busy else None}
        seen = {n_: sum(c for k, (_, c) in by_kernel.items()
                        if re.search(rf"(?<!\w){n_}_kernel(?!\w)", k))
                for n_ in ("fused_dense_int8", "gravnet_block_int8")}
        if mode == "captured" and seen != {"fused_dense_int8": 5 * replays,
                                           "gravnet_block_int8": 2 * replays}:
            fail(f"[mixed_trained] the profiler saw {seen} kernel runs over "
                 f"{replays} replays, expected 5 and 2 per replay")
        say(f"[mixed_trained] profiler, {mode}: {seen} kernel runs over "
            f"{replays} chunks")
    capture_rows["mixed_trained"]["idle"] = idle
    for path in ("fp", "fp_dp1", "mixed_no_fuse_int8"):
        captured_vs_eager(path, pipes[path], ccn_feeds, DISPATCH)
    captured_vs_eager("ragged", pipes["ragged"], rg_feeds, DISPATCH)
    for gname, gfeeds in gnn_feeds.items():
        width = max(serve.MIN_ROUTES_BATCH, pipes[gname].microbatch)
        captured_vs_eager(gname, pipes[gname], gfeeds, width)
        if gname == "gatedgcn":
            gdisp = {k: v[:width] for k, v in gfeeds.items()}
            idle_g = {}
            for mode, p in (("captured", pipes[gname]),
                            ("eager", Eager(pipes[gname]))):
                busy, _, wall = idle_share(
                    lambda p=p: serve.serve_events(p, gdisp),
                    f"{mode} GatedGCN dispatches of {width} graphs",
                    f"_gatedgcn_{mode}")
                idle_g[mode] = {"busy_us": busy, "wall_us": wall,
                                "idle_share": 1 - busy / wall if busy
                                else None}
            capture_rows[gname]["idle"] = idle_g
    captured_vs_eager("attention", apipe, afeeds, DISPATCH)
    # CPS alone on one chunk's heads of the served default: its device
    # time eager and captured (one CUDA graph of its k_max steps)
    cev = generate(gen_cfg, mt.microbatch, seed=7)
    heads_ = mt({"hits": cev["feats"], "mask": cev["mask"]})
    cps_in = ({"beta_logit": heads_["beta"][..., 0].contiguous(),
               "coords": heads_["coords"].contiguous(),
               "energy": heads_["energy"][..., 0].contiguous()},
              torch.from_numpy(cev["mask"]).to(dev))
    cps_want = ccn.cps(*cps_in, cfg)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ccn.cps(*cps_in, cfg)
    torch.cuda.current_stream().wait_stream(side)
    cps_graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(cps_graph):
        cps_got = ccn.cps(*cps_in, cfg)
    cps_graph.replay()
    torch.cuda.synchronize()
    for k, v in cps_want.items():
        if not torch.equal(cps_got[k], v):
            fail(f"captured cps {k} differs from eager cps")
    cps_rows = {
        "captured_device_ms": timer.device_ms(cps_graph.replay, 200),
        # few calls: ~100 launches each would fill the launch queue and
        # pace the card by the host
        "eager_device_ms": timer.device_ms(lambda: ccn.cps(*cps_in, cfg),
                                           5),
        "eager_host_ms": float(np.median([host_ms(
            lambda _: ccn.cps(*cps_in, cfg), None, 1) for _ in range(5)])),
        "captured_host_ms": float(np.median([host_ms(
            lambda _: cps_graph.replay(), None, 1) for _ in range(5)])),
        "events": mt.microbatch}
    capture_rows["cps"] = cps_rows
    say(f"cps alone on one chunk's heads ({mt.microbatch} events): device "
        f"{cps_rows['captured_device_ms']:.5f} ms captured, "
        f"{cps_rows['eager_device_ms']:.5f} ms eager; host "
        f"{cps_rows['captured_host_ms']:.4f} ms to replay, "
        f"{cps_rows['eager_host_ms']:.4f} ms to enqueue eagerly ({card})")
    capture_rows["tuner"] = tuner_row
    (OUT / "capture.json").write_text(json.dumps(capture_rows, indent=1))
    say(f"phase 9 done at {time.perf_counter() - t_start:.1f}s "
        f"({time.perf_counter() - t9:.1f}s)")

    # 10. the service: ShardedTriggerService, one lane per replica --------
    t10 = time.perf_counter()
    from repro_torch.serving import ShardedTriggerService
    service_rows = {}

    def leaves_equal(got, want, label):
        """Every output leaf of the served events bitwise equal to the
        plain captured loop's."""
        a, b = dict(leaves(got)), dict(leaves(want))
        diff = sorted(k for k in b if not np.array_equal(a.get(k), b[k]))
        if set(a) != set(b) or diff:
            fail(f"[{label}] served events differ from serve_events on the "
                 f"same deployment: {diff or sorted(set(a) ^ set(b))}")

    def released_once_in_order(served, summary, label, n):
        """Every event released once, in submission order, answered."""
        if served.order != list(range(n)) or served.failed \
                or summary["completed"] != n \
                or sum(r["completed"] for r in summary["per_replica"]) != n:
            fail(f"[{label}] release: order {served.order[:8]}... of {n}, "
                 f"{served.failed} failed, completed {summary['completed']}")

    def lanes_captured_before_traffic(captures, label):
        if not captures or any(c["captures"] != c["captured_at_start"]
                               or c["captured_at_start"] < 1
                               for c in captures):
            fail(f"[{label}] lane captures {captures}: each lane must capture "
                 "before traffic and nothing during it")

    def profiled(label, make_svc, routed, expect=None):
        """A fresh service on the same deployment: its counted run (every
        counter at 0 just before, the profiler's kernel records equal to
        the counters), its lanes' captures unchanged under traffic, and
        the idle share over 4 calls of a quarter of the events."""
        svc = make_svc()
        try:
            n = sum(len(next(iter(f.values()))) for f in routed.values())
            part = {r: {k: v[:max(1, len(v) // 4)] for k, v in f.items()}
                    for r, f in routed.items()}
            ran = {}

            def call():
                ran["before"] = batches_ran(svc)
                out = serve.submit_all(svc, routed)
                ran["during"] = batches_ran(svc) - ran["before"]
                return out
            (served, launches, _) = counted(
                call, lambda: serve.submit_all(svc, part),
                f"service {label}")
            if served.failed or served.order != list(range(n)):
                fail(f"[service {label}] the counted run: {served.failed} "
                     "failed or out of order")
            if expect is not None and expect(svc, launches, ran["during"]):
                fail(f"[service {label}] launches {launches}: "
                     f"{expect(svc, launches, ran['during'])}")
            busy, _, wall = idle_share(
                lambda: serve.submit_all(svc, part),
                f"service calls of {label}",
                "_service_" + label.replace(" ", "_"))
            svc.drain()
            lanes_captured_before_traffic(svc.capture_summary(),
                                          f"service {label}, profiled")
        finally:
            svc.close()
        path_launches[f"service {label}"] = launches
        return launches, (1 - busy / wall) if busy else None

    def plain_rate(report):
        """The plain captured loop on the report's deployment and events,
        timed right after the service: events/s, p50 and p99 µs."""
        routes = {sv.name: (sv.pipe, report.feeds[sv.name])
                  for sv in report.servables}
        res, elapsed = serve.serve_routes(
            routes, None if len(routes) == 1 else
            serve.service_width(report.servables))
        n = sum(len(r[1]) for r in res.values())
        lat = np.concatenate([r[1] for r in res.values()])
        return res, {"events_s": n / elapsed,
                     "p50_us": float(np.percentile(lat, 50) * 1e6),
                     "p99_us": float(np.percentile(lat, 99) * 1e6)}

    def batches_ran(svc):
        """Batches the service launched that ran (one failed by an
        injected fault ran no kernel)."""
        return sum(r.stats.batches for r in svc.replicas) - (
            svc.faults.counts()["fail"] if svc.faults is not None else 0)

    def mixed_launches(svc, launches, ran):
        """5 fused_dense_int8 and 2 gravnet_block_int8 per chunk of every
        launch that ran in the counted run, nothing else."""
        chunks = ran * (svc.microbatch // svc.replicas[0].lane.microbatch)
        want = dict.fromkeys(wrappers, 0)
        want.update(fused_dense_int8=5 * chunks, gravnet_block_int8=2 * chunks)
        return None if launches == want else f"expected {want}"

    def row(label, served, s_, plain, idle, launches):
        bud = s_["budget"]
        n = sum(len(v) for v in served.results.values())
        r = {"events": n, "events_s": n / served.elapsed_s,
             "p50_us": s_["p50_us"], "p99_us": s_["p99_us"],
             "budget_us": bud, "batches": s_["batches"],
             "padded_events": s_["padded_events"], "idle_share": idle,
             "plain_loop": plain, "launches": launches,
             "per_replica": [{k: p[k] for k in ("replica_id", "completed",
                                                "batches")}
                             for p in s_["per_replica"]]}
        service_rows[label] = r
        say(f"[service {label}] {n} events: {r['events_s']:.1f} events/s, "
            f"p50={r['p50_us']:.1f}us p99={r['p99_us']:.1f}us, budget "
            f"queue_wait={bud['queue_wait_us_mean']:.1f}us dispatch="
            f"{bud['dispatch_us_mean']:.1f}us compute="
            f"{bud['compute_us_mean']:.1f}us, {r['batches']} batches, "
            f"{r['padded_events']} padded events, idle share "
            + ("not measured" if idle is None else f"{idle:.4f}")
            + f"; the plain captured loop on the same deployment and events:"
            f" {plain['events_s']:.1f} events/s, p50={plain['p50_us']:.1f}us"
            f" p99={plain['p99_us']:.1f}us ({card})")

    def serve_run(label, argv, expect=None):
        """``serve.run(argv)`` (``python -m repro_torch.launch.serve``),
        its output into the log; every event held bitwise against
        serve_events on the same deployment, released once and in order,
        the lanes captured before traffic only; then the counted and
        profiled run of a fresh service on the same deployment."""
        buf = io.StringIO()
        try:
            with redirect_stdout(buf):
                report = serve.run(argv)
        except SystemExit as e:
            for line in buf.getvalue().splitlines():
                say(f"  [{label}] {line}")
            fail(f"serve {' '.join(argv)}: exit {e.code}")
        for line in buf.getvalue().splitlines():
            say(f"  [{label}] {line}")
        n = sum(len(v) for v in report.served.results.values())
        released_once_in_order(report.served, report.summary, label, n)
        lanes_captured_before_traffic(report.captures, label)
        res, plain = plain_rate(report)
        for (route, got), sv in zip(report.served.results.items(),
                                    report.servables):
            leaves_equal(serve.stack_results(got), res[sv.name][0],
                         f"{label} {sv.name}")
        say(f"[service {label}] {n} events answered once each, in "
            "submission order, bitwise equal to serve_events on the same "
            "deployment; every lane captured before traffic and nothing "
            "during it")
        routed = {(None if len(report.servables) == 1 else sv.name):
                  report.feeds[sv.name] for sv in report.servables}
        with redirect_stdout(io.StringIO()):   # its chaos line, again
            fk = serve.fault_kwargs(report.args)
        launches, idle = profiled(label, lambda: serve.build_service(
            report.args, report.servables, **fk), routed, expect)
        row(label, report.served, report.summary, plain, idle, launches)
        return report

    # (a) the default run: warm-trained mixed, design point 3, one
    # replica, the streaming loop, 512 events
    serve_run("default", [], mixed_launches)
    # (b) two replicas, each policy; (c) the deadline loop
    for policy in ("round_robin", "least_loaded"):
        serve_run(f"replicas 2 {policy}", ["--replicas", "2", "--policy",
                                           policy], mixed_launches)
    serve_run("deadline loop", ["--loop", "deadline"], mixed_launches)
    # (d) the GNN routes
    serve_run("routes", ["--model", "gatedgcn", "graphsage"])
    # (f) a dead lane: replica 1 fails every batch, failover to replica 0
    dead = serve_run("dead lane", ["--replicas", "2", "--inject-faults",
                                   "fail:p=1.0,replica=1", "--max-retries",
                                   "2"], mixed_launches)
    ft = dead.fault_tolerance
    if dead.served.failed or not ft["failed_over"] or \
            dead.summary["per_replica"][1]["completed"]:
        fail(f"[service dead lane] {dead.served.failed} client-visible "
             f"failures, fault tolerance {ft}")
    say(f"[service dead lane] 0 client-visible failures: retried="
        f"{ft['retried']} failed_over={ft['failed_over']} breaker open="
        f"{ft['breaker']['open']}")
    # (e) a ragged= service over deploy(ragged=True, batch=8), 16 events a
    # launch of the service, held against serve_events on the same
    # deployment
    rpipe = pipes["ragged"]

    def ragged_service():
        return ShardedTriggerService(ragged=rpipe, n_replicas=1,
                                     microbatch=DISPATCH, window_s=2e-3,
                                     loop="streaming")
    svc = ragged_service()
    try:
        rcap = svc.capture_summary()
        served = serve.submit_all(svc, {None: rg_feeds})
        svc.drain()
        rsum = svc.stats.summary()
        rcaps = svc.capture_summary()
    finally:
        svc.close()
    released_once_in_order(served, rsum, "ragged", RAGGED_EVENTS)
    lanes_captured_before_traffic(rcaps, "ragged")
    if rcap != rcaps:
        fail(f"[service ragged] captures {rcap} -> {rcaps}")
    rwant, rlat, relapsed = serve.serve_events(rpipe, rg_feeds)
    leaves_equal(serve.stack_results(served.results[None]), rwant, "ragged")
    rlaunch, ridle = profiled("ragged", ragged_service, {None: rg_feeds})
    if not (rlaunch["knn_build"] and rlaunch["knn_aggregate"]
            and rlaunch["knn_build"] == rlaunch["knn_aggregate"]):
        fail(f"[service ragged] launches {rlaunch}")
    row("ragged", served, rsum, {
        "events_s": RAGGED_EVENTS / relapsed,
        "p50_us": float(np.percentile(rlat, 50) * 1e6),
        "p99_us": float(np.percentile(rlat, 99) * 1e6)}, ridle, rlaunch)
    ph9 = capture_rows["mixed_trained"]["captured"]
    say(f"[service] phase 9's captured plain loop of the warm-trained "
        f"default ({CAPTURE_EVENTS} events, {DISPATCH} per dispatch): "
        f"{ph9['events_s']:.1f} events/s, p50={ph9['p50_us']:.1f}us "
        f"p99={ph9['p99_us']:.1f}us; the service's default: "
        f"{service_rows['default']['events_s']:.1f} events/s ({card})")
    service_rows["phase9_plain_default"] = ph9
    (OUT / "service.json").write_text(json.dumps(service_rows, indent=1,
                                                 default=str))
    say(f"phase 10 done at {time.perf_counter() - t_start:.1f}s "
        f"({time.perf_counter() - t10:.1f}s)")

    # 11. the kernel line and the result -----------------------------------
    # each kernel's numbers per chunk (per launch of the ragged
    # executable) of the path it serves: its launches from that path's
    # run, its times at that path's micro-batch (bins)
    home = {"fused_dense": ["fp"], "gravnet_block": ["fp"],
            "fused_dense_int8": ["mixed", "mixed_trained"],
            "gravnet_block_int8": ["mixed", "mixed_trained"],
            "gravnet_aggregate": ["mixed_no_fuse_int8", "fp_dp1"],
            "knn_build": ["ragged", "ragged_dp1"],
            "knn_aggregate": ["ragged", "ragged_dp1"],
            "edge_aggregate": ["gatedgcn", "graphsage"],
            "flash_attention": ["attention"]}
    # the service runs count on top (phase 10): the main path's pair from
    # the default run, the routes' and the ragged path's kernels
    home["fused_dense_int8"].append("service default")
    home["gravnet_block_int8"].append("service default")
    home["fused_dense"] += ["service routes", "service ragged"]
    home["edge_aggregate"].append("service routes")
    home["knn_build"].append("service ragged")
    home["knn_aggregate"].append("service ragged")
    line = []
    for name, meta in KERNELS.items():
        path = home[name][0]
        mb = pipes[path].microbatch
        rows_ = [r for r in results[name]["per_launch"]
                 if r["path"] == path and r["events"] == mb]
        # a library call's time where it covers every launch of the
        # chunk; torch._int_mm, which covers the int8 product alone,
        # summed over the launches whose shapes it accepts
        lib = [r["library_ms"] for r in rows_ if r["library_ms"] is not None]
        lib_ms = sum(lib) if lib and (len(lib) == len(rows_)
                                      or name == "fused_dense_int8") else None
        lib_label = sorted({r["library"] for r in rows_ if r["library"]})
        if name == "fused_dense_int8":
            lib_label = [f"torch._int_mm, int8 product only (no epilogue), "
                         f"at {len(lib)} of {len(rows_)} launches; it "
                         "refuses K or N not a multiple of 8"]
        if not lib_label:
            lib_label = ["none (no single PyTorch call)"]
        nbytes = sum(r["bytes"] for r in rows_)
        ops: dict[str, float] = {}
        for r in rows_:
            for kind, n in r["ops"].items():
                ops[kind] = ops.get(kind, 0.0) + n
        b_ms, b_by = bound(nbytes, ops)
        n_launch = sum(path_launches[p][name] for p in home[name])
        if n_launch == 0:
            fail(f"{name} was launched no time on its path {home[name]}")
        line.append({
            "name": name, **meta, "status": "ported",
            "launches": n_launch,
            "launches_from": {p: path_launches[p][name] for p in home[name]},
            "max_abs_err": results[name]["max_abs_err"],
            "tolerance": "bitwise" if name in BITWISE else (
                f"|err| <= {ATOL:g} + {RTOL:g}*|plain|" + (
                    f" (bf16: {BF16_ATOL:g} + {BF16_RTOL:g}*|plain|)"
                    if name == "flash_attention" else "")),
            "per": (f"one launch of the {path} executable ({len(rows_)} "
                    f"launches, {mb} bins)" if name.startswith("knn") else
                    f"one chunk of the {path} path ({len(rows_)} launches, "
                    f"{mb} events)"),
            "ms": sum(r["ms"] for r in rows_),
            "plain_ms": sum(r["plain_ms"] for r in rows_),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "library": lib_label or None,
            "per_launch": results[name]["per_launch"],
        })
    (OUT / "kernels.json").write_text(json.dumps(line, indent=1))
    (OUT / "gnn_chunks.json").write_text(json.dumps(gnn_chunk_ms, indent=1))
    say(f"done in {time.perf_counter() - t_start:.1f}s")
    _save_log()
    # each launch's row stays in kernels.json; the line keeps the totals
    print(json.dumps({"kernels": [
        {k: v for k, v in e.items() if k != "per_launch"} for e in line]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
