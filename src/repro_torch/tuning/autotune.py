"""Kernel autotuner: measure candidate configs, persist winners.

Counterpart of ``repro/tuning/autotune.py``. ``tune_*`` times one kernel
family at one problem shape through the public ``kernels/ops.py``
entry points (so padding and routing cost what a deployment's calls
cost), on inputs made by ``numpy.random.default_rng(seed)`` as the
reference makes them, their float operands in the problem's dtype
(``"bf16"`` or f32, :func:`float_dtype`), and writes the winner into a
``TuningCache``.
``autotune_graph`` walks a deployed graph and tunes every problem its
ops emit (``op_registry.tuning_problem``, the keys the binders look
up), so a later ``deploy(..., tuning_cache=...)`` hits every entry.

The backend names the device: ``"cuda"`` runs the hand-written kernels
on the card, ``"cpu"`` their plain versions. Every family's candidates
(``candidates.py``: the dense's and the edge kernel's tiles, the GravNet
and kNN kernels' rows a CTA, flash's blocks) reach the kernel through
the ``ops`` entry points' knobs. The default candidate, the plan the
wrapper picks with no knob, is measured first and dethroned only by a
win of more than ``MIN_GAIN``.
On the card a candidate is timed on the card's clock: CUDA events around
back-to-back calls, enqueued behind a sleep kernel that holds the card
until the host has enqueued them all, so the events read the calls'
device work and neither the host's enqueue nor a synchronization (a
host clock would: a launch and its syncs outweigh a 30 µs kernel). The
plain versions ignore every launch knob, so on ``"cpu"`` a search would
time one program several times: there the default is measured alone,
on the host clock as the reference does on ``"xla"``; its entry still
tells warm-up which shapes the deployment launches.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.phase_split import device_ms, sleep_cycles_per_ms
from repro_torch.tuning import candidates as cand
from repro_torch.tuning.cache import (KernelKey, TuningCache,
                                      edge_aggregate_key,
                                      flash_attention_key, fused_dense_key,
                                      gravnet_block_int8_key,
                                      gravnet_block_key, gravnet_key,
                                      knn_aggregate_key, knn_build_key)

MIN_GAIN = 0.03

# backends whose ops ignore launch knobs (the plain versions): tuning
# degenerates to timing the default config once
_KNOB_INERT_BACKENDS = frozenset({"cpu"})


def device_of(backend: str) -> torch.device:
    """The device a tuning backend runs on: 'cuda' (raises without
    CUDA) or 'cpu'; the reference's backends have no device here."""
    if backend not in ("cuda", "cpu"):
        raise ValueError(f"the port tunes on 'cuda' or 'cpu', not "
                         f"{backend!r}")
    return resolve_device(backend)


def _time_call(fn, *, warmup: int = 2, iters: int = 5) -> float:
    """Min host seconds per call (the plain versions on the CPU). Min,
    not median: noise on a busy host only adds."""
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.min(ts))


def _device_time_call(fn, *, iters: int = 5, reps: int = 20) -> float:
    """Min device seconds per call on the card: ``phase_split.device_ms``
    (``reps`` calls back to back behind a sleep kernel, bracketed by CUDA
    events) over ``iters`` runs."""
    cycles_per_ms = sleep_cycles_per_ms(torch)
    return min(device_ms(torch, fn, cycles_per_ms, reps)
               for _ in range(iters)) * 1e-3


def _pick(timed: list[tuple[dict, float]], *, min_gain: float):
    """timed[0] is the heuristic default; a challenger must beat it by
    ``min_gain`` relative to win."""
    default_cfg, default_t = timed[0]
    best_cfg, best_t = default_cfg, default_t
    for cfg, t in timed[1:]:
        if t < best_t:
            best_cfg, best_t = cfg, t
    if best_t >= default_t * (1.0 - min_gain):
        best_cfg, best_t = default_cfg, default_t
    return best_cfg, best_t, default_t


def _finish(cache: TuningCache | None, key: KernelKey, timed,
            *, min_gain: float, extras: dict | None = None) -> dict:
    """Pick the winner, store it (with ``extras``, the problem's dims
    that its key does not carry, for warm-up) and return it."""
    best_cfg, best_t, default_t = _pick(timed, min_gain=min_gain)
    if cache is not None:
        cache.put(key, {**best_cfg, **(extras or {})}, us=best_t * 1e6,
                  default_us=default_t * 1e6, candidates=len(timed))
    return best_cfg


def _search(call, cands, backend, iters):
    if backend in _KNOB_INERT_BACKENDS:
        return [(cands[0], _time_call(lambda: call(cands[0]), iters=iters))]
    return [(cfg, _device_time_call(lambda c=cfg: call(c), iters=iters))
            for cfg in cands]


def float_dtype(dtype: str) -> torch.dtype:
    """The float operands' dtype of a problem keyed ``dtype``: bfloat16
    for ``"bf16"``, else float32 (the reference's ``_np_dtype``)."""
    return torch.bfloat16 if dtype == "bf16" else torch.float32


class _Inputs:
    """numpy draws moved to the backend's device; ``normal`` in the
    problem's float dtype (``fdt``)."""

    def __init__(self, seed: int, backend: str, dtype: str = "float32"):
        self.rng = np.random.default_rng(seed)
        self.dev = device_of(backend)
        self.fdt = float_dtype(dtype)

    def t(self, a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.dev)

    def normal(self, shape, scale=1.0):
        return self.t(self.rng.normal(size=shape) * scale, self.fdt)

    def int8(self, shape, hi=127):
        return self.t(self.rng.integers(-127, hi, size=shape), torch.int8)


# ------------------------------------------------------------ fused dense ----
def tune_fused_dense(rows: int, d_in: int, d_out: int, *,
                     dtype: str = "float32", backend: str = "cuda",
                     cache: TuningCache | None = None, iters: int = 5,
                     min_gain: float = MIN_GAIN, seed: int = 0) -> dict:
    from repro_torch.kernels import ops
    r = _Inputs(seed, backend, dtype)
    if dtype == "int8":
        x = r.int8((rows, d_in))
        w = r.int8((d_in, d_out))
        b = r.normal((d_out,))
        ws = r.t(r.rng.uniform(1e-3, 5e-2, size=(d_out,)))

        def call(cfg):
            return ops.fused_dense_int8(x, w, b, 0.02, ws, **cfg)
        cands = cand.fused_dense_int8_candidates(rows, d_in, d_out)
    else:
        x = r.normal((rows, d_in))
        w = r.normal((d_in, d_out))
        b = r.normal((d_out,))

        def call(cfg):
            return ops.fused_dense(x, w, b, **cfg)
        cands = cand.fused_dense_candidates(rows, d_in, d_out)
    timed = _search(call, cands, backend, iters)
    key = fused_dense_key(rows, d_in, d_out, dtype, backend)
    return _finish(cache, key, timed, min_gain=min_gain)


# ---------------------------------------------------------------- gravnet ----
def tune_gravnet(n: int, d_s: int, d_f: int, k: int, *,
                 batch: int = 1, events: int | None = None,
                 dtype: str = "float32", backend: str = "cuda",
                 cache: TuningCache | None = None, iters: int = 5,
                 min_gain: float = MIN_GAIN, seed: int = 0) -> dict:
    """``batch > 1`` tunes the batched launch at (batch, n); batch=1
    keeps the per-event problem and key. ``events`` (:func:`_launch`) is
    how many events a launch of the problem takes, where that is not
    ``batch``."""
    from repro_torch.kernels import ops
    r = _Inputs(seed, backend, dtype)
    key = gravnet_key(n, d_s, d_f, k, dtype, backend, batch=batch)
    batch = events or batch      # the inputs: the events of a launch
    lead = (batch,) if batch > 1 else ()
    s = r.normal((*lead, n, d_s))
    f = r.normal((*lead, n, d_f))
    mask = r.t(r.rng.uniform(size=(*lead, n)) < 0.8)
    fn = ops.gravnet_aggregate_batched if batch > 1 else \
        ops.gravnet_aggregate

    def call(cfg):
        return fn(s, f, mask, k=k, **cfg)

    timed = _search(call, cand.gravnet_candidates(n, batch=batch, d_f=d_f),
                    backend, iters)
    return _finish(cache, key, timed, min_gain=min_gain)


# ---------------------------------------------------------- gravnet block ----
def tune_gravnet_block(n: int, d_hidden: int, d_s: int, d_f: int,
                       d_out: int, k: int, *, batch: int = 1,
                       events: int | None = None, activation: str = "relu",
                       concat_x: bool = True, ragged: bool = False,
                       dtype: str = "float32", backend: str = "cuda",
                       cache: TuningCache | None = None, iters: int = 5,
                       min_gain: float = MIN_GAIN, seed: int = 0) -> dict:
    """Tune the fused GravNet block at one problem shape; ``dtype="int8"``
    tunes the quantized block under its own ``gravnet_block_int8`` key.
    The dims the key does not carry (d_s, d_out, activation, concat_x)
    ride in the cached config so warm-up can replay the problem; without
    ``concat_x`` the output dense reads the aggregate alone; ``events``
    as :func:`tune_gravnet`'s. ``ragged`` tunes a raggedized block, the
    chain of ``ops.gravnet_block_ragged`` over packed bins, whose knob is
    its kNN pair's bm (f32: the ragged path is fp only)."""
    from repro_torch.kernels import ops
    r = _Inputs(seed, backend, dtype)
    dcat = d_hidden + 2 * d_f if concat_x else 2 * d_f
    key = (gravnet_block_int8_key(n, d_hidden, d_f, k, backend, batch=batch)
           if dtype == "int8" else
           gravnet_block_key(n, d_hidden, d_f, k, dtype, backend, batch=batch))
    batch = events or batch      # the inputs: the events of a launch
    lead = (batch,) if batch > 1 else ()
    if dtype == "int8":
        ws = r.int8((d_hidden, d_s), 128)
        wf = r.int8((d_hidden, d_f), 128)
        wo = r.int8((dcat, d_out), 128)
        bs, bf, bo = r.normal((d_s,)), r.normal((d_f,)), r.normal((d_out,))
        wss, wfs, wos = (r.t(r.rng.uniform(1e-3, 5e-2, size=(m,)))
                         for m in (d_s, d_f, d_out))
        x = r.normal((*lead, n, d_hidden))
        mask = r.t(r.rng.uniform(size=(*lead, n)) < 0.8)
        fn = ops.gravnet_block_int8_batched if batch > 1 else \
            ops.gravnet_block_int8

        def call(cfg):
            return fn(x, mask, ws, bs, wf, bf, wo, bo, wss, wfs, wos,
                      x_scale=0.02, agg_scale=0.01, h_scale=0.02, k=k,
                      activation=activation, concat_x=concat_x, **cfg)

        cands = cand.gravnet_block_int8_candidates(
            n, d_hidden, d_f, d_out, d_s=d_s, concat_x=concat_x,
            batch=batch)
    else:
        ws, bs = r.normal((d_hidden, d_s), 0.3), r.normal((d_s,))
        wf, bf = r.normal((d_hidden, d_f), 0.3), r.normal((d_f,))
        wo, bo = r.normal((dcat, d_out), 0.3), r.normal((d_out,))
        x = r.normal((*lead, n, d_hidden))
        if ragged:
            seg = r.t(_ragged_segids(r.rng, (batch, n)), torch.int32)

            def call(cfg):
                return ops.gravnet_block_ragged(
                    x if lead else x[None], seg, ws, bs, wf, bf, wo, bo,
                    k=k, activation=activation, concat_x=concat_x, **cfg)

            cands = cand.gravnet_block_ragged_candidates(n, batch=batch,
                                                         d_f=d_f)
        else:
            mask = r.t(r.rng.uniform(size=(*lead, n)) < 0.8)
            fn = ops.gravnet_block_batched if batch > 1 \
                else ops.gravnet_block

            def call(cfg):
                return fn(x, mask, ws, bs, wf, bf, wo, bo, k=k,
                          activation=activation, concat_x=concat_x, **cfg)

            cands = cand.gravnet_block_candidates(
                n, d_hidden, d_f, d_out, d_s=d_s, concat_x=concat_x,
                batch=batch)
    timed = _search(call, cands, backend, iters)
    return _finish(cache, key, timed, min_gain=min_gain,
                   extras={"d_s": d_s, "d_out": d_out,
                           "activation": activation, "concat_x": concat_x})


# --------------------------------------------------------- edge aggregate ----
def tune_edge_aggregate(n: int, e: int, d: int, *, reduce: str = "sum",
                        batch: int = 1, events: int | None = None,
                        dtype: str = "float32", backend: str = "cuda",
                        cache: TuningCache | None = None, iters: int = 5,
                        min_gain: float = MIN_GAIN, seed: int = 0) -> dict:
    """Tune the edge aggregation at one (n, e, d); ``reduce`` rides in the
    cached config for warm-up; ``events`` as :func:`tune_gravnet`'s."""
    from repro_torch.kernels import ops
    r = _Inputs(seed, backend, dtype)
    key = edge_aggregate_key(n, e, d, dtype, backend, batch=batch)
    batch = events or batch      # the inputs: the events of a launch
    lead = (batch,) if batch > 1 else ()
    msgs = r.normal((*lead, e, d))
    ei = r.t(r.rng.integers(0, n, size=(*lead, 2, e)), torch.int32)
    mask = r.t(r.rng.uniform(size=(*lead, e)) < 0.8)
    fn = ops.edge_aggregate_batched if batch > 1 else ops.edge_aggregate

    def call(cfg):
        return fn(msgs, ei, n, mask, reduce=reduce, **cfg)

    timed = _search(call, cand.edge_aggregate_candidates(n, e, d=d,
                                                         batch=batch),
                    backend, iters)
    return _finish(cache, key, timed, min_gain=min_gain,
                   extras={"reduce": reduce})


# ------------------------------------------------------------- ragged kNN ----
def _ragged_segids(rng, shape) -> np.ndarray:
    """Representative bin-packed segment ids: a few contiguous events
    per bin with a padded tail (``data/ragged.bin_pack``'s layout)."""
    n = shape[-1]
    seg = np.full(shape, -1, np.int32)
    flat = seg.reshape(-1, n)
    for row in flat:
        fill = int(rng.integers(n // 2, n + 1))
        cuts = np.sort(rng.choice(np.arange(1, fill), size=min(2, fill - 1),
                                  replace=False)) if fill > 2 else []
        prev, ev = 0, 0
        for c in list(cuts) + [fill]:
            row[prev:c] = ev
            prev, ev = c, ev + 1
    return seg


def tune_knn_build(n: int, d_s: int, k: int, *, batch: int = 1,
                   dtype: str = "float32", backend: str = "cuda",
                   cache: TuningCache | None = None, iters: int = 5,
                   min_gain: float = MIN_GAIN, seed: int = 0) -> dict:
    """Tune the ragged neighbour selection; ``n`` is the bin capacity,
    ``batch`` the bins per launch."""
    from repro_torch.kernels import ops
    r = _Inputs(seed, backend, dtype)
    if batch > 1:
        s = r.normal((batch, n, d_s))
        seg = r.t(_ragged_segids(r.rng, (batch, n)), torch.int32)
        fn = ops.knn_build_batched
    else:
        s = r.normal((n, d_s))
        seg = r.t(_ragged_segids(r.rng, (1, n))[0], torch.int32)
        fn = ops.knn_build

    def call(cfg):
        return fn(s, seg, k=k, **cfg)

    timed = _search(call, cand.knn_build_candidates(n, batch=batch),
                    backend, iters)
    key = knn_build_key(n, d_s, k, dtype, backend, batch=batch)
    return _finish(cache, key, timed, min_gain=min_gain)


def tune_knn_aggregate(n: int, d_f: int, k: int, *, batch: int = 1,
                       scale: float = 10.0, dtype: str = "float32",
                       backend: str = "cuda",
                       cache: TuningCache | None = None, iters: int = 5,
                       min_gain: float = MIN_GAIN, seed: int = 0) -> dict:
    """Tune the ragged aggregation over representative knn_build outputs
    (``scale`` rides in the cached config for warm-up)."""
    from repro_torch.kernels import ops
    r = _Inputs(seed, backend, dtype)
    lead = (batch,) if batch > 1 else ()
    f = r.normal((*lead, n, d_f))
    idx = r.t(r.rng.integers(0, n, size=(*lead, n, k)), torch.int32)
    d2 = r.t(r.rng.uniform(0.0, 4.0, size=(*lead, n, k)))
    fn = ops.knn_aggregate_batched if batch > 1 else ops.knn_aggregate

    def call(cfg):
        return fn(f, idx, d2, scale=scale, **cfg)

    timed = _search(call, cand.knn_aggregate_candidates(n, batch=batch,
                                                        d_f=d_f),
                    backend, iters)
    key = knn_aggregate_key(n, d_f, k, dtype, backend, batch=batch)
    return _finish(cache, key, timed, min_gain=min_gain,
                   extras={"scale": scale})


# -------------------------------------------------------- flash attention ----
def tune_flash_attention(bh: int, s: int, t: int, d: int, *,
                         causal: bool = True, dtype: str = "float32",
                         backend: str = "cuda",
                         cache: TuningCache | None = None, iters: int = 5,
                         min_gain: float = MIN_GAIN, seed: int = 0) -> dict:
    """Time the kept (bq, bk) plans at one (bh, s, t, d) problem, on
    q, k, v of ``dtype`` (``"bf16"`` or f32)."""
    from repro_torch.kernels import ops
    r = _Inputs(seed, backend, dtype)
    q = r.normal((bh, s, d))
    k = r.normal((bh, t, d))
    v = r.normal((bh, t, d))

    def call(cfg):
        return ops.flash_attention(q, k, v, causal=causal, **cfg)

    timed = _search(call, cand.flash_attention_candidates(s, t, d),
                    backend, iters)
    key = flash_attention_key(bh, s, t, d, dtype, backend)
    return _finish(cache, key, timed, min_gain=min_gain)


# ------------------------------------------------------------ graph walk ----
def graph_kernel_problems(g, *, n_rows: int, backend: str,
                          batch: int = 1) -> list[KernelKey]:
    """The tuning problems a deployed graph emits, through the
    registry's per-spec tuning-key hooks (``op_registry.tuning_problem``)
    — the keys ``kernel_opt``'s binders look up, so a later deploy hits
    every entry. ``batch`` is the packed micro-batch of a batch-packed
    executable (1 = per-event shapes)."""
    from repro_torch.core.op_registry import tuning_problem
    problems: list[KernelKey] = []
    seen: set[KernelKey] = set()
    for op in g:
        key = tuning_problem(op, n_rows=n_rows, backend=backend,
                             batch=batch)
        if key is not None and key not in seen:
            seen.add(key)
            problems.append(key)
    return problems


def _op_extras(g, key) -> dict:
    """The dims of a problem that its key does not carry, from the op of
    ``g`` that emits it (the reference's defaults when none matches)."""
    if key.kernel in ("gravnet_block", "gravnet_block_int8"):
        dh, d_f, k = key.shape[-3:]
        for op in g:
            if (op.op_type == "gravnet_block"
                    and op.attrs.get("d_hidden") == dh
                    and op.attrs.get("d_f") == d_f
                    and op.attrs.get("k") == k):
                return {"d_s": op.attrs["d_s"], "d_out": op.out_dim or dh,
                        "activation": op.attrs.get("activation", "relu"),
                        "concat_x": op.attrs.get("concat_x", True)}
        return {"d_s": 4, "d_out": dh, "activation": "relu",
                "concat_x": True}
    if key.kernel == "edge_aggregate":
        d = key.shape[-1]
        for op in g:
            if op.op_type == "edge_aggregate" and (op.out_dim or 1) == d:
                return {"reduce": op.attrs.get("reduce", "sum")}
        return {"reduce": "sum"}
    if key.kernel == "knn_aggregate":
        d_f, k = key.shape[-2:]
        for op in g:
            if (op.op_type == "knn_aggregate"
                    and op.attrs.get("d_f") == d_f
                    and op.attrs.get("k") == k):
                return {"scale": op.attrs.get("scale", 10.0)}
        return {"scale": 10.0}
    return {}


def _launch(g, key, *, n_rows: int, backend: str,
            batch: int) -> tuple[int, bool]:
    """(events, ragged) of a launch of ``key``'s problem in the
    deployment of ``g``: how many events it takes, the packed ``batch``
    or, for a per-event key, the segment's P events (at most the
    micro-batch: the executor's chunks), which the key does not carry;
    and whether a raggedized GravNet block emits it. The tuner times the
    problem so: the plans of the GravNet and edge kernels follow the
    events of a launch, and a raggedized block runs the kNN pair."""
    from repro_torch.core.op_registry import tuning_problem
    mb = g.meta.get("parallelization", {}).get("microbatch") or 1
    for op in g:
        if tuning_problem(op, n_rows=n_rows, backend=backend,
                          batch=batch) == key:
            events = batch if batch > 1 else max(
                1, min(op.attrs_opt.get("P", 1), mb))
            return events, bool(op.attrs.get("ragged"))
    return batch, False


def autotune_graph(g, *, n_rows: int, backend: str, cache: TuningCache,
                   batch: int = 1, iters: int = 5,
                   min_gain: float = MIN_GAIN, force: bool = False,
                   verbose: bool = False) -> int:
    """Tune every kernel problem in ``g``; returns how many were
    (re)searched. Existing cache entries are kept unless ``force``."""
    tuned = 0
    for key in graph_kernel_problems(g, n_rows=n_rows, backend=backend,
                                     batch=batch):
        if not force and key in cache:
            continue
        kw = dict(dtype=key.dtype, backend=backend, cache=cache,
                  iters=iters, min_gain=min_gain)
        shape = key.shape
        extras = _op_extras(g, key)
        events, ragged = _launch(g, key, n_rows=n_rows, backend=backend,
                                 batch=batch)
        if key.kernel == "fused_dense":
            tune_fused_dense(*shape, **kw)
        elif key.kernel == "gravnet":
            kb = shape[0] if len(shape) == 5 else 1
            tune_gravnet(*shape[-4:], batch=kb, events=events, **kw)
        elif key.kernel in ("gravnet_block", "gravnet_block_int8"):
            kb = shape[0] if len(shape) == 5 else 1
            n, dh, d_f, k = shape[-4:]
            tune_gravnet_block(n, dh, extras["d_s"], d_f, extras["d_out"],
                               k, batch=kb, events=events, ragged=ragged,
                               activation=extras["activation"],
                               concat_x=extras["concat_x"], **kw)
        elif key.kernel == "edge_aggregate":
            kb = shape[0] if len(shape) == 4 else 1
            tune_edge_aggregate(*shape[-3:], reduce=extras["reduce"],
                                batch=kb, events=events, **kw)
        elif key.kernel == "knn_build":
            kb = shape[0] if len(shape) == 4 else 1
            tune_knn_build(*shape[-3:], batch=kb, **kw)
        elif key.kernel == "knn_aggregate":
            kb = shape[0] if len(shape) == 4 else 1
            tune_knn_aggregate(*shape[-3:], scale=extras["scale"], batch=kb,
                               **kw)
        elif key.kernel == "flash_attention":
            tune_flash_attention(*shape, **kw)
        else:
            continue
        tuned += 1
        if verbose:
            e = cache.entry(key)
            print(f"[tune] {key.encode()} -> {e.config} "
                  f"({e.us:.1f}us vs default {e.default_us:.1f}us, "
                  f"{e.candidates} candidates)")
    return tuned
