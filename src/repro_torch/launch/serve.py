"""Serving entry point: ``python -m repro_torch.launch.serve [...]``.

Counterpart of ``repro/launch/serve.py`` run with ``--replicas 1``: each
model named by ``--model`` (default ``ccn``) is a route of the
serve-side registry ``MODELS``. A route deploys its model through the
whole design flow (``core/pipeline.py:deploy``; the model joins through
its ``core.graph_ir`` exporter, with ``--target-throughput`` and
``--tpu-native-gravnet`` in its ``Requirements``, whose cost-model
platform follows the device: "h100" on ``cuda``, so the P search picks
the micro-batch on the card's model, and "cpu", the reference's
constants, on the CPU) and makes its own synthetic events:

- ``ccn``: CaloClusterNet on synthetic Belle II events, CPS for the
  trigger bit, and a report of trigger efficiency / fake rate against
  the events' truth. Its weights are random from seed 0; served alone
  (``--model ccn``, the default), it first warm-trains them as the
  reference does, ``--train-steps`` steps (default 40) of the
  condensation loss with AdamW (weight decay 0.01) on a cosine warm-up
  schedule (peak 2e-3, 10 warm-up steps), each on 32 events of seed
  500 + step, with autograd through ``CaloClusterNet.forward`` on the
  pipeline's device; ``--train-steps 0`` serves the random weights. As
  in the reference, ``--precision`` defaults to ``mixed`` (int8
  interior, calibrated on 64 events of seed 123), and
  ``--no-fuse-gravnet-block`` / ``--no-fuse-int8`` keep the GravNet
  chain unfused;
- ``gatedgcn`` and ``graphsage``: the reference's route configs of the
  edge-based GNNs (weights from generator seeds 1 and 2), fp, on random
  graphs of 64 nodes and 256 edges.

Design points 1 to 3 deploy every route. The events are split over the
routes (route i gets seed 7 + i), as the reference splits them.

``--tuning-cache PATH`` loads a kernel-tuning cache
(``repro_torch.tuning``) whose winners every route's deployment binds;
an unreadable or stale file prints a warning and leaves the heuristic
defaults. ``--tune`` first times the kernel problems of every route's
deployment that the cache lacks (``autotune_graph``), saves the cache to
``--tuning-cache`` when given, and redeploys with the winners bound, as
the reference's non-bucketed path does. When the cache holds entries,
they are replayed once (``make_warmup``) before the timed dispatches.

As the reference does, it serves through ``ShardedTriggerService``
(``repro_torch/serving/``): ``ccn`` alone with the micro-batch
``max(pipe.microbatch, 16)`` and a 2 ms window, any other ``--model``
selection through one replica group per route with the shared
micro-batch ``max(8, *microbatches)``, the routes' events submitted one
of each in turn. ``--replicas`` replicas per route (thread-backed lanes
on one card), ``--loop`` (``streaming``, the default, or ``deadline``),
``--policy`` and the fault-tolerance flags ``--inject-faults``,
``--fault-seed``, ``--breaker``, ``--max-retries`` and ``--shed`` are
the reference's. It prints events/s, latency p50/p99 (an event's latency
runs from its submission to its release), the latency budget
(queue_wait, dispatch, compute), a line per replica and per route, and
under faults the chaos line. Every future is waited for with a bound;
the release order is checked against the submission order.

Runs on ``cuda`` unless ``--device cpu`` is given. Each route is first
called once at the serving width (events of seed 99), which on ``cuda``
captures its chunk shapes as CUDA graphs (``core/pipeline.py``); then
every replica's lane captures those shapes for itself, before traffic,
and nothing is captured under traffic (checked). The padding-free ragged
path has no flag, as in the reference: ``build_pipeline(...,
ragged=True, batch=8)`` deploys it and
``ShardedTriggerService(ragged=...)`` serves it.

``ccn`` alone also takes the reference's demonstrator flags:

- ``--buckets N ...`` deploys one batch-packed executable per occupancy
  bucket (``deploy_bucketed``, ``--bucket-microbatch`` events a launch,
  default 8) and serves them through ``ShardedTriggerService(buckets=)``:
  each event goes to the smallest bucket that fits its non-zero hits,
  each bucket's replicas on lanes of its executable, each bucket called
  once before its lanes capture. ``--tune`` then searches every bucket's
  graph at ``batch=microbatch``, as the reference's bucketed branch does;
- ``--monitor-port PORT`` (0: any free port) serves the live monitor
  over HTTP on localhost (``/snapshot``, ``/events``, ``/``), and after
  serving checks that ``/snapshot`` counts the events the service
  completed (``SystemExit`` otherwise); ``--event-display PATH`` writes
  the first ``--event-display-n`` events' display records as JSON. Either
  turns the service's monitor on (one ``TriggerMonitor`` a replica on the
  detector's grid, ``display_n = max(n, 64)``) and submits each event's
  truth bit with it; without them the run takes the path it takes
  without a monitor.

Any other ``--model`` selection takes ``--bench-out PATH``: the run's
events/s, latency and per-route rows as JSON, the reference's
multi-model stats.

``serve_routes`` and ``serve_events`` are the plain captured in-order
loop (one dispatch of each route in turn, each dispatch's results on
the host before the next is sent), which ``chip_smoke.py`` times the
service against.
"""
from __future__ import annotations

import argparse
import itertools
import json
import time
import urllib.request
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import caloclusternet as ccn
from repro_torch.core.condensation import condensation_loss
from repro_torch.core.graph_ir import export_graph
from repro_torch.core.pipeline import (BucketedPipeline, Requirements,
                                       deploy, deploy_bucketed)
from repro_torch.data.belle2 import Belle2Config, current_detector, generate
from repro_torch.device import resolve_device
from repro_torch.models.gnn import gatedgcn, graphsage
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_warmup)
from repro_torch.optim.adamw import tree_map
from repro_torch.optim.step import value_and_grad
from repro_torch.serving import (POLICIES, FaultPlan, MonitorServer,
                                 ShardedTriggerService, event_display,
                                 write_display)
from repro_torch.tuning import (TuningCache, autotune_graph,
                                graph_kernel_problems, make_warmup)

#: the serving micro-batch floor of repro/launch/serve.py (ccn alone)
MIN_SERVE_BATCH = 16
#: its floor on the shared micro-batch of several routes
MIN_ROUTES_BATCH = 8
#: its default throughput target for the design flow's P search, events/s
TARGET_THROUGHPUT = 1e5
#: its default number of warm-training steps before ccn alone is served
TRAIN_STEPS = 40
#: its service's micro-batching window, seconds
WINDOW_S = 2e-3
#: its bound on the wait for one event's result, seconds
RESULT_TIMEOUT_S = 120
#: its bucketed path's default launch width
BUCKET_MICROBATCH = 8
#: the fewest display records its monitor keeps
MIN_DISPLAY_N = 64


def detector_configs(detector: str):
    """(CCNConfig, Belle2Config) of the 'upgrade' or 'current' detector."""
    if detector == "current":
        return ccn.current_detector_config(), current_detector()
    if detector == "upgrade":
        return ccn.CCNConfig(), Belle2Config()
    raise ValueError(f"unknown detector {detector!r}")


def calibration_feeds(gen_cfg) -> dict:
    """The calibration batch of repro/launch/serve.py: 64 events of
    seed 123."""
    calib = generate(gen_cfg, 64, seed=123)
    return {"hits": calib["feats"], "mask": calib["mask"]}


def platform_of(device=None) -> str:
    """The design flow's cost-model platform for a deployment on
    ``device``: "h100" on ``cuda`` (the card's model), "cpu" on the CPU
    (the reference's constants, so the CPU picks the reference's P)."""
    return "h100" if resolve_device(device).type == "cuda" else "cpu"


def build_pipeline(cfg: ccn.CCNConfig, gen_cfg, *, design_point: int = 3,
                   precision: str = "mixed", fuse_gravnet_block: bool = True,
                   fuse_int8: bool = True, batch: int = 1,
                   ragged: bool = False, tuning_cache=None,
                   target_throughput: float = TARGET_THROUGHPUT,
                   tpu_native_gravnet: bool = False, params=None,
                   buckets=None, device=None, platform=None):
    """CaloClusterNet weights ``params`` (default: random from seed 0),
    exported and deployed as repro/launch/serve.py deploys it (its
    calibration batch from ``gen_cfg``, its 2 ms budget), with the cost
    model of ``platform``: by default the device's (:func:`platform_of`:
    the H100's on ``cuda``; on the CPU the reference's CPU constants, so
    the design flow picks the reference's P and micro-batch).
    ``target_throughput`` and ``tpu_native_gravnet`` are the
    ``Requirements``'; ``batch``, ``ragged`` and ``tuning_cache`` are
    ``deploy``'s: ``ragged=True`` returns the padding-free
    ``RaggedPipeline`` with ``batch`` bins per launch. ``buckets``
    (occupancy caps) returns ``deploy_bucketed``'s ``BucketedPipeline``
    instead, ``batch`` events a launch of each bucket."""
    if params is None:
        params = ccn.init(torch.Generator().manual_seed(0), cfg)
    req = Requirements(design_point=design_point,
                       platform=platform or platform_of(device),
                       precision_policy=precision, n_hits=cfg.n_hits,
                       target_throughput=target_throughput,
                       max_latency_s=2e-3,
                       tpu_native_gravnet=tpu_native_gravnet)
    graph = export_graph("caloclusternet", params, cfg)
    if buckets:
        return deploy_bucketed(graph, req, buckets=buckets, microbatch=batch,
                               calibration_feeds=calibration_feeds(gen_cfg),
                               tuning_cache=tuning_cache,
                               fuse_gravnet_block=fuse_gravnet_block,
                               fuse_int8=fuse_int8, device=device)
    return deploy(graph, req,
                  calibration_feeds=calibration_feeds(gen_cfg),
                  tuning_cache=tuning_cache,
                  fuse_gravnet_block=fuse_gravnet_block,
                  fuse_int8=fuse_int8, batch=batch, ragged=ragged,
                  device=device)


# --------------------------------------------------------- warm-training ----
def train_batch(gen_cfg, n: int, seed: int, device=None) -> dict:
    """``n`` generated events of ``seed`` as tensors on ``device``:
    feats, mask, object_id, energy, cls."""
    raw = generate(gen_cfg, n, seed=seed)
    dev = resolve_device(device)
    return {k: torch.from_numpy(raw[k]).to(dev)
            for k in ("feats", "mask", "object_id", "energy", "cls")}


def train_step(params, opt, batch, *, cfg: ccn.CCNConfig,
               ocfg: AdamWConfig, lr):
    """One step of the warm-training: the condensation loss of
    ``ccn.apply`` on ``batch``, its gradients by autograd,
    one AdamW update at rate ``lr``. Returns (new params, new optimizer
    state, loss); ``params`` and ``opt`` are left as they are."""
    def loss_fn(p):
        out = ccn.apply(p, batch["feats"], batch["mask"], cfg)
        labels = {k: batch[k] for k in ("object_id", "energy", "cls")}
        return condensation_loss(out, labels, batch["mask"],
                                 k_max=cfg.k_max)
    (loss, _), grads = value_and_grad(loss_fn, params)
    new_params, new_opt, _ = adamw_update(grads, opt, params, lr=lr,
                                          cfg=ocfg)
    return new_params, new_opt, loss


def warm_train(cfg: ccn.CCNConfig, gen_cfg, steps: int, *, device=None):
    """The reference's warm-training of the default serve run: random
    weights from seed 0, then ``steps`` AdamW steps (weight decay 0.01,
    ``cosine_warmup(peak_lr=2e-3, warmup_steps=10, total_steps=steps)``)
    on 32 events of seed 500 + step each, on ``device``. Returns (params
    on ``device``, each step's loss as a 0-dim tensor)."""
    dev = resolve_device(device)
    params = tree_map(lambda t: t.to(dev),
                      ccn.init(torch.Generator().manual_seed(0), cfg))
    ocfg = AdamWConfig(weight_decay=0.01)
    lrf = cosine_warmup(peak_lr=2e-3, warmup_steps=10, total_steps=steps)
    opt = adamw_init(params, ocfg)
    losses = []
    for st in range(steps):
        batch = train_batch(gen_cfg, 32, 500 + st, device=dev)
        params, opt, loss = train_step(params, opt, batch, cfg=cfg,
                                       ocfg=ocfg, lr=lrf(opt["step"]))
        losses.append(loss)
    return params, losses


# ------------------------------------------------------------ model zoo ----
class Servable(NamedTuple):
    """One deployed route: the pipeline, and its synthetic events
    ``events(n, seed) -> (feeds, trigger_truth)``: the feeds as numpy
    arrays with the events on the leading axis, the truth of CCN's
    trigger bit per event (None for a route without one)."""
    name: str
    pipe: Callable
    events: Callable


_EDGE_N, _EDGE_E = 64, 256     # E = 4N, the registry's edge budget


def _edge_events(d_in, d_edge_in=None):
    """The reference's random graphs, drawn in its order, event after
    event, and stacked."""
    def events(n, seed):
        rng = np.random.default_rng(seed)
        evs = []
        for _ in range(n):
            ev = {
                "nodes": rng.normal(
                    size=(_EDGE_N, d_in)).astype(np.float32),
                "edge_index": rng.integers(
                    0, _EDGE_N, size=(2, _EDGE_E)).astype(np.int32),
                "node_mask": (rng.uniform(size=(_EDGE_N,)) < 0.8)
                .astype(np.float32),
                "edge_mask": (rng.uniform(size=(_EDGE_E,)) < 0.7)
                .astype(np.float32),
            }
            if d_edge_in is not None:
                ev["edges"] = rng.normal(
                    size=(_EDGE_E, d_edge_in)).astype(np.float32)
            evs.append(ev)
        return {k: np.stack([ev[k] for ev in evs]) for k in evs[0]}, None
    return events


def _edge_req(args) -> Requirements:
    return Requirements(design_point=args.design_point,
                        platform=args.platform or platform_of(args.device),
                        precision_policy="fp", n_hits=_EDGE_N,
                        target_throughput=args.target_throughput,
                        max_latency_s=2e-3,
                        tpu_native_gravnet=args.tpu_native_gravnet)


def _ccn_servable(args, cfg=None, tuning_cache=None,
                  params=None) -> Servable:
    """CaloClusterNet of ``--detector`` (or ``cfg`` on that detector's
    events) under ``--precision``, with weights ``params`` (default:
    random from seed 0); under ``--buckets`` a ``BucketedPipeline`` of
    ``--bucket-microbatch`` events a launch."""
    det_cfg, gen_cfg = detector_configs(args.detector)
    bucket_kw = (dict(buckets=args.buckets, batch=args.bucket_microbatch)
                 if args.buckets else {})
    pipe = build_pipeline(cfg or det_cfg, gen_cfg,
                          design_point=args.design_point,
                          precision=args.precision,
                          fuse_gravnet_block=not args.no_fuse_gravnet_block,
                          fuse_int8=not args.no_fuse_int8,
                          tuning_cache=tuning_cache,
                          target_throughput=args.target_throughput,
                          tpu_native_gravnet=args.tpu_native_gravnet,
                          params=params, device=args.device,
                          platform=args.platform, **bucket_kw)

    def events(n, seed):
        ev = generate(gen_cfg, n, seed=seed)
        return {"hits": ev["feats"], "mask": ev["mask"]}, ev["trigger_truth"]

    return Servable("ccn", pipe, events)


def _gatedgcn_servable(args, cfg=None, tuning_cache=None) -> Servable:
    """The reference's GatedGCN route (4 layers × 32), or ``cfg``."""
    cfg = cfg or gatedgcn.GatedGCNConfig(n_layers=4, d_hidden=32, d_in=8,
                                         d_edge_in=4, n_classes=2)
    params = gatedgcn.init(torch.Generator().manual_seed(1), cfg)
    pipe = deploy(export_graph("gatedgcn", params, cfg),
                  _edge_req(args), tuning_cache=tuning_cache,
                  device=args.device)
    return Servable("gatedgcn", pipe, _edge_events(cfg.d_in, cfg.d_edge_in))


def _graphsage_servable(args, cfg=None, tuning_cache=None) -> Servable:
    """The reference's GraphSAGE route (2 layers × 32), or ``cfg``."""
    cfg = cfg or graphsage.GraphSAGEConfig(n_layers=2, d_hidden=32, d_in=16,
                                           n_classes=5)
    params = graphsage.init(torch.Generator().manual_seed(2), cfg)
    pipe = deploy(export_graph("graphsage", params, cfg),
                  _edge_req(args), tuning_cache=tuning_cache,
                  device=args.device)
    return Servable("graphsage", pipe, _edge_events(cfg.d_in))


MODELS: dict[str, Callable] = {
    "ccn": _ccn_servable,
    "gatedgcn": _gatedgcn_servable,
    "graphsage": _graphsage_servable,
}


# ----------------------------------------------------------------- tuning ----
def load_tuning_cache(args):
    """The cache of ``--tuning-cache`` (a fresh one for ``--tune``
    alone), or None without either flag. A file that cannot be used
    prints a warning and loads empty: the heuristic defaults stay."""
    if not (args.tuning_cache or args.tune):
        return None
    cache = (TuningCache.load(args.tuning_cache) if args.tuning_cache
             else TuningCache())
    if cache.load_error:
        print(f"[serve] WARNING: {cache.load_error}; falling back to "
              "heuristic kernel defaults")
    return cache


def _tune_and_rebind(cache, args, problems, redeploy):
    """Autotune the given (graph, n_rows, batch, backend) problems,
    persist the winners, and redeploy with them bound; returns the fresh
    deployment, or None when nothing new was searched."""
    n_new = sum(autotune_graph(g, n_rows=nr, batch=bt, backend=be,
                               cache=cache, verbose=True)
                for g, nr, bt, be in problems)
    print(f"[serve] autotuned {n_new} kernel problem(s), "
          f"cache holds {len(cache)}")
    if args.tuning_cache:
        cache.save(args.tuning_cache)
        print(f"[serve] tuning cache -> {args.tuning_cache}")
    return redeploy() if n_new else None   # rebind fresh winners


def cache_hits(pipe, cache) -> tuple[int, int]:
    """(problems of ``pipe``'s graph that ``cache`` holds, problems); of
    every bucket's graph at its launch width for a ``BucketedPipeline``."""
    if isinstance(pipe, BucketedPipeline):
        parts = [cache_hits(p, cache) for p in pipe.pipes.values()]
        return sum(h for h, _ in parts), sum(n for _, n in parts)
    g = pipe.graph
    keys = graph_kernel_problems(g, n_rows=g.meta["n_hits"],
                                 backend=pipe.backend,
                                 batch=pipe.microbatch
                                 if pipe.batch_packed else 1)
    return sum(k in cache for k in keys), len(keys)


def tuning_problems(pipe) -> list:
    """The (graph, n_rows, batch, backend) problems ``--tune`` searches:
    the graph at one event's shapes, or, for a ``BucketedPipeline``, every
    bucket's graph at its launch width (the reference's bucketed
    branch)."""
    if isinstance(pipe, BucketedPipeline):
        return [(p.graph, b, pipe.microbatch, p.backend)
                for b, p in pipe.pipes.items()]
    return [(pipe.graph, pipe.graph.meta["n_hits"], 1, pipe.backend)]


# ---------------------------------------------------------------- serving ----
def _to_host(out) -> dict:
    if isinstance(out, dict):
        return {k: _to_host(v) for k, v in out.items()}
    return out if isinstance(out, np.ndarray) else out.cpu().numpy()


def _cat(*xs):
    if isinstance(xs[0], dict):
        return {k: _cat(*(x[k] for x in xs)) for k in xs[0]}
    return np.concatenate(xs, axis=0)


def serve_routes(routes: dict, width: int | None = None
                 ) -> tuple[dict, float]:
    """Answer every event of every route: ``routes`` maps a name to
    ``(pipe, feeds)`` (feeds as numpy, the events on the leading axis of
    every array). Dispatches ``width`` events (default: per route
    ``max(pipe.microbatch, 16)``) of one route after another in turn
    until all are answered; each dispatch's results reach the host
    before the next is sent.

    Returns ``({name: (results, latencies_s, busy_s)}, elapsed_s)``: per
    route its outputs for all its events in submission order, each
    event's decision latency and the time spent in its dispatches; and
    the wall time of the whole loop."""
    todo = {}
    for name, (pipe, feeds) in routes.items():
        n = len(next(iter(feeds.values())))
        todo[name] = dict(n=n, next=0, parts=[], lat=np.empty(n), busy=0.0,
                          batch=width or max(pipe.microbatch,
                                             MIN_SERVE_BATCH))
    live = list(todo)
    t0 = time.perf_counter()
    while live:
        for name in list(live):
            pipe, feeds = routes[name]
            st = todo[name]
            s, batch = st["next"], st["batch"]
            t_disp = time.perf_counter()
            out = _to_host(pipe({k: v[s:s + batch]
                                 for k, v in feeds.items()}))
            dt = time.perf_counter() - t_disp
            st["lat"][s:s + batch] = dt
            st["busy"] += dt
            st["parts"].append(out)
            st["next"] = s + batch
            if st["next"] >= st["n"]:
                live.remove(name)
    elapsed = time.perf_counter() - t0
    return {name: (_cat(*st["parts"]), st["lat"], st["busy"])
            for name, st in todo.items()}, elapsed


def serve_events(pipe, feeds: dict):
    """Answer every event of ``feeds`` (numpy, the events on the leading
    axis of every array) in submission order, ``max(pipe.microbatch,
    16)`` events per dispatch. ``pipe`` is a deployed pipeline, or a
    ``RaggedPipeline`` (its micro-batch is its bins per launch), which
    returns numpy already.

    Returns (results, latencies_s, elapsed_s): the pipeline's outputs
    for all events as numpy arrays, in order, each event's decision
    latency, and the wall time of the whole loop."""
    res, elapsed = serve_routes({"": (pipe, feeds)})
    results, lat, _ = res[""]
    return results, lat, elapsed


def trigger_rates(trigger, truth):
    """(efficiency, fake rate) of trigger decisions against truth."""
    trig = np.asarray(trigger, bool)
    truth = np.asarray(truth) > 0
    eff = float((trig & truth).sum() / max(truth.sum(), 1))
    fake = float((trig & ~truth).sum() / max((~truth).sum(), 1))
    return eff, fake


# ---------------------------------------------------------------- service ----
def fault_kwargs(args) -> dict:
    """The service's fault-tolerance arguments from the command line, as
    the reference takes them: a seeded fault plan (``--inject-faults``
    implies the breaker: injecting chaos without health tracking just
    loses events), circuit breaking, bounded failover and shedding."""
    faults = (FaultPlan.parse(args.inject_faults, seed=args.fault_seed)
              if args.inject_faults else None)
    if faults is not None:
        print(f"[serve] chaos plan: {faults.describe()}")
    return {"faults": faults, "breaker": args.breaker or faults is not None,
            "max_retries": args.max_retries, "shed": args.shed}


def print_chaos(ft: dict, failed: int) -> None:
    """The reference's chaos line from a ``fault_tolerance_summary``."""
    br = ft["breaker"]
    print(f"[serve] chaos: {failed} client-visible failure(s), "
          f"shed={ft['shed']} retried={ft['retried']} "
          f"failed_over={ft['failed_over']} "
          f"breaker open={br['open']} half_open={br['half_open']}")


def service_width(servables) -> int:
    """The service's micro-batch: ``max(pipe.microbatch, 16)`` for ccn
    alone (a bucketed ccn: its launch width), ``max(8, *microbatches)``
    over several routes."""
    if [sv.name for sv in servables] == ["ccn"]:
        pipe = servables[0].pipe
        if isinstance(pipe, BucketedPipeline):
            return pipe.microbatch
        return max(pipe.microbatch, MIN_SERVE_BATCH)
    return max(MIN_ROUTES_BATCH, *(sv.pipe.microbatch for sv in servables))


def monitor_config(args):
    """The service's ``monitor=`` of the reference: on the detector's
    grid, keeping ``max(--event-display-n, 64)`` display records, when
    ``--monitor-port`` or ``--event-display`` is given; else False."""
    if args.monitor_port is None and not args.event_display:
        return False
    return {"detector": detector_configs(args.detector)[1],
            "display_n": max(args.event_display_n, MIN_DISPLAY_N)}


def build_service(args, servables, *, warmup_fn=None, monitor=False,
                  **fault_kw):
    """The reference's service over the deployed routes: ccn alone as
    ``infer_fn`` (a bucketed ccn as ``buckets=``), several routes as
    ``routes=``; each replica serves through a lane of its route's (its
    bucket's) pipeline, captured at construction."""
    kw = dict(n_replicas=args.replicas, microbatch=service_width(servables),
              window_s=WINDOW_S, hedge_after_s=None, policy=args.policy,
              loop=args.loop, warmup_fn=warmup_fn, monitor=monitor,
              **fault_kw)
    if [sv.name for sv in servables] == ["ccn"]:
        pipe = servables[0].pipe
        if isinstance(pipe, BucketedPipeline):
            return ShardedTriggerService(buckets=pipe, **kw)
        return ShardedTriggerService(pipe, **kw)
    return ShardedTriggerService(routes={sv.name: sv.pipe
                                         for sv in servables}, **kw)


class Served(NamedTuple):
    """What :func:`submit_all` saw: per route the results of its events
    in submission order (None where an event failed), the failures, the
    submission indices in the order their futures resolved, and the wall
    time from the first submission to the last result."""
    results: dict
    failed: int
    order: list
    elapsed_s: float


def submit_all(svc, feeds: dict, truths: dict | None = None) -> Served:
    """Submit every event of ``feeds`` (route name, or None for a service
    without routes, to stacked numpy feeds) to ``svc``, one event of each
    route in turn, as the reference interleaves its routes' streams; then
    wait for every future, each for at most ``RESULT_TIMEOUT_S``. A
    callback on each future records when it resolved: registered before
    the next event is submitted, so the recorded order is the release
    order. ``truths`` (route to one truth bit per event) go to
    ``submit(truth=)``, for a monitored service."""
    counts = {r: len(next(iter(f.values()))) for r, f in feeds.items()}
    stamp = itertools.count()
    resolved: list[tuple[int, int]] = []
    futs = []
    t0 = time.perf_counter()
    for i in range(max(counts.values())):
        for route, f in feeds.items():
            if i >= counts[route]:
                continue
            truth = None if truths is None or truths.get(route) is None \
                else bool(truths[route][i])
            fut = svc.submit({k: v[i] for k, v in f.items()}, route=route,
                             truth=truth)
            fut.add_done_callback(lambda _f, n=len(futs): resolved.append(
                (next(stamp), n)))
            futs.append((route, fut))
    results = {r: [] for r in feeds}
    failed = 0
    for route, fut in futs:
        try:
            results[route].append(fut.result(timeout=RESULT_TIMEOUT_S))
        except Exception:  # noqa: BLE001 — only under injected chaos
            results[route].append(None)
            failed += 1
    elapsed = time.perf_counter() - t0
    return Served(results, failed, [n for _, n in sorted(resolved)],
                  elapsed)


def stack_results(results) -> dict:
    """Per-event result trees stacked along a new leading axis."""
    if isinstance(results[0], dict):
        return {k: stack_results([r[k] for r in results])
                for k in results[0]}
    return np.stack(results)


class Report(NamedTuple):
    """One serve run, for callers that check it (``chip_smoke.py``):
    the parsed arguments, the deployed routes, each route's served feeds
    and trigger truth, what :func:`submit_all` saw, the service's
    summary, its lanes' captures (``capture_summary``), the fault
    tolerance summary, the per-bucket rows (``bucket_summary``, empty
    without buckets), the monitor's snapshot and ``/snapshot``'s answer
    (None without a monitor, without ``--monitor-port``), and the event
    display records written (None without ``--event-display``)."""
    args: argparse.Namespace
    servables: list
    feeds: dict
    truth: dict
    served: Served
    summary: dict
    captures: list
    fault_tolerance: dict
    buckets: list
    monitor: dict | None
    live_snapshot: dict | None
    displays: list | None


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", nargs="+", default=["ccn"],
                    choices=sorted(MODELS), metavar="NAME",
                    help="registered model route(s) to serve, one replica "
                         f"group each: {sorted(MODELS)} (default ccn)")
    ap.add_argument("--detector", choices=["current", "upgrade"],
                    default="upgrade")
    ap.add_argument("--design-point", type=int, default=3,
                    choices=[1, 2, 3])
    ap.add_argument("--precision", choices=["fp", "mixed"],
                    default="mixed",
                    help="the ccn route's policy; the edge-based GNNs "
                         "deploy fp, as in the reference")
    ap.add_argument("--no-fuse-gravnet-block", action="store_true",
                    help="keep the unfused dense→aggregate→dense GravNet "
                         "chains instead of the fused block")
    ap.add_argument("--no-fuse-int8", action="store_true",
                    help="under --precision mixed, keep the unfused "
                         "calibrated int8 chain instead of the quantized "
                         "block; fp deployments still fuse")
    ap.add_argument("--events", type=int, default=512,
                    help="events in all, split over the routes")
    ap.add_argument("--target-throughput", type=float,
                    default=TARGET_THROUGHPUT,
                    help="events/s target for the design flow's P search, "
                         "on the cost model of the device (the H100's on "
                         "cuda, the reference's CPU constants on the CPU)")
    ap.add_argument("--platform", choices=["h100", "cpu"], default=None,
                    help="the cost model the P search prices ops on "
                         "(default: the device's, h100 on cuda and cpu on "
                         "the CPU)")
    ap.add_argument("--tpu-native-gravnet", action="store_true",
                    help="partition the GravNet aggregation onto the "
                         "kernel target (Requirements.tpu_native_gravnet)")
    ap.add_argument("--train-steps", type=int, default=TRAIN_STEPS,
                    help="warm-training steps before --model ccn alone is "
                         "deployed (0: serve the random weights)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serving replicas per route (thread-backed lanes "
                         "on one card, placed on the cards when several "
                         "are visible)")
    ap.add_argument("--loop", choices=["streaming", "deadline"],
                    default="streaming",
                    help="replica hot loop: 'streaming' (default) runs the "
                         "persistent dataflow pipeline — rolling batching "
                         "into preallocated rings, no deadline tick; "
                         "'deadline' is the original micro-batch deadline "
                         "loop")
    ap.add_argument("--policy", default="round_robin", choices=POLICIES)
    ap.add_argument("--inject-faults", default=None, metavar="SPEC",
                    help="deterministic chaos: seeded fault plan, e.g. "
                         "'fail:p=0.05;stall:p=0.02,s=0.01' or "
                         "'fail:p=1.0,replica=1' (dead lane); grammar in "
                         "serving/faults.py. Implies --breaker")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed for --inject-faults (bit-identical replay)")
    ap.add_argument("--breaker", action="store_true",
                    help="per-replica health tracking + circuit breaking "
                         "(closed/open/half-open)")
    ap.add_argument("--max-retries", type=int, default=0, metavar="N",
                    help="failover: re-dispatch a failed batch's events to "
                         "a healthy sibling up to N times before failing "
                         "to the client")
    ap.add_argument("--shed", action="store_true",
                    help="load shedding: a full replica queue fails the "
                         "event fast with ShedError instead of blocking "
                         "submit()")
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="default: cuda (raises when CUDA is absent)")
    ap.add_argument("--tuning-cache", default=None, metavar="PATH",
                    help="JSON kernel-tuning cache consulted when binding "
                         "kernels and warming replicas (absent/corrupt -> "
                         "heuristic defaults)")
    ap.add_argument("--tune", action="store_true",
                    help="autotune every route's kernel problems before "
                         "serving; winners are saved to --tuning-cache "
                         "when given")
    ap.add_argument("--buckets", type=int, nargs="+", default=None,
                    metavar="N_HITS",
                    help="ccn alone: occupancy buckets (e.g. 32 64 128): "
                         "one batch-packed executable per bucket, each "
                         "event dispatched to the smallest bucket that fits "
                         "its non-zero hit count")
    ap.add_argument("--bucket-microbatch", type=int,
                    default=BUCKET_MICROBATCH, metavar="B",
                    help="events each bucket executable packs per launch "
                         f"(default {BUCKET_MICROBATCH})")
    ap.add_argument("--monitor-port", type=int, default=None,
                    metavar="PORT",
                    help="ccn alone: serve the live monitor over HTTP on "
                         "localhost at this port (0 = any free port): "
                         "/snapshot JSON, /events NDJSON tail, / the event "
                         "display")
    ap.add_argument("--event-display", default=None, metavar="PATH",
                    help="ccn alone: write a JSON event display (the "
                         "detector's grid) of the first --event-display-n "
                         "events")
    ap.add_argument("--event-display-n", type=int, default=16, metavar="N",
                    help="events in the --event-display file (default 16)")
    ap.add_argument("--bench-out", default=None, metavar="PATH",
                    help="any --model selection but ccn alone: write the "
                         "run's per-route serving stats as JSON")
    args = ap.parse_args(argv)
    if args.events < len(args.model):
        ap.error(f"--events {args.events} leaves a route of "
                 f"{args.model} without events")
    if args.replicas < 1:
        ap.error("--replicas must be at least 1")
    single = args.model == ["ccn"]
    demo = [f for f, on in (("--buckets", args.buckets),
                            ("--monitor-port", args.monitor_port is not None),
                            ("--event-display", args.event_display)) if on]
    if demo and not single:
        ap.error(f"{', '.join(demo)} serve(s) --model ccn alone, as in the "
                 "reference")
    if args.bench_out and single:
        ap.error("--bench-out writes the stats of a --model selection other "
                 "than ccn alone, as in the reference")
    if args.bucket_microbatch < 1 or (args.buckets and min(args.buckets) < 1):
        ap.error("--buckets and --bucket-microbatch must be positive")
    return args


def deploy_routes(args, cache=None) -> list:
    """Every ``--model`` route deployed (ccn alone warm-trained first,
    ``--tune`` searched and rebound), each called once at the serving
    width on events of seed 99 (on ``cuda`` this captures its chunk
    shapes for the lanes to copy); a bucketed ccn is not called here,
    the service's warm-up calls each bucket."""
    single = args.model == ["ccn"]
    trained = None
    if single and args.train_steps > 0:
        cfg, gen_cfg = detector_configs(args.detector)
        trained, losses = warm_train(cfg, gen_cfg, args.train_steps,
                                     device=args.device)
        print(f"[serve] warm-trained {args.train_steps} steps, "
              f"loss {float(losses[-1]):.3f}")

    def servable(m):
        if m == "ccn" and trained is not None:
            return _ccn_servable(args, tuning_cache=cache, params=trained)
        return MODELS[m](args, tuning_cache=cache)

    servables = []
    for m in args.model:
        sv = servable(m)
        if args.tune:
            fresh = _tune_and_rebind(cache, args, tuning_problems(sv.pipe),
                                     lambda m=m: servable(m))
            if fresh is not None:
                sv = fresh
        servables.append(sv)
    width = service_width(servables)
    for sv in servables:
        pipe = sv.pipe
        precision = args.precision if sv.name == "ccn" else "fp"
        where = (f"design point {args.design_point}, {precision} on "
                 f"{pipe.device} ({device_name(pipe.device)})")
        if isinstance(pipe, BucketedPipeline):
            # each bucket is called once by the service's warm-up
            print(f"[serve] deployed {sv.name}: {where}: buckets="
                  f"{pipe.buckets} microbatch={pipe.microbatch} (one "
                  "batch-packed executable per bucket)")
        else:
            print(f"[serve] deployed {sv.name}: {where}: segments="
                  f"{len(pipe.segments)} microbatch={pipe.microbatch} "
                  "blocks="
                  f"{sum(op.op_type == 'gravnet_block' for op in pipe.graph)}")
        if cache is not None:
            hits, n_keys = cache_hits(pipe, cache)
            print(f"[serve] route {sv.name}: {hits} of {n_keys} kernel "
                  "problems bound from the tuning cache")
        if not isinstance(pipe, BucketedPipeline):
            pipe(sv.events(width, 99)[0])
    if not single:
        print(f"[serve] routes {[sv.name for sv in servables]}: "
              f"microbatch={width}")
    return servables


def device_name(dev) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def run(argv=None) -> Report:
    """The command line's run: deploy, build the service, serve every
    event through it, print the reference's lines; returns the
    :class:`Report`. Raises ``SystemExit`` when the release order is not
    the submission order, when a lane captured under traffic, when,
    without injected faults, an event went unanswered, or when the live
    ``/snapshot`` does not count the events the service completed."""
    args = parse_args(argv)
    cache = load_tuning_cache(args)
    servables = deploy_routes(args, cache)
    pipe0 = servables[0].pipe
    bucketed = isinstance(pipe0, BucketedPipeline)
    dev = pipe0.device
    # a bucketed service warms each bucket itself, as the reference's does
    warmup_fn = (make_warmup(cache, backend=pipe0.backend)
                 if cache is not None and len(cache) and not bucketed
                 else None)
    monitor = monitor_config(args)
    fk = fault_kwargs(args)
    svc = build_service(args, servables, warmup_fn=warmup_fn,
                        monitor=monitor, **fk)
    server = None
    try:
        if bucketed:
            print(f"[serve] bucket executables warmed at startup: "
                  f"{sum(r.warmed for r in svc.replicas)}")
        elif warmup_fn is not None:
            print(f"[serve] replicas warmed "
                  f"{sum(r.warmed for r in svc.replicas)} cached kernel "
                  "shape(s) at startup")
        start = svc.capture_summary()
        print("[serve] lanes captured before traffic: " + ", ".join(
            f"replica {c['replica_id']} {c['captured_at_start']}"
            for c in start))
        if args.monitor_port is not None:
            server = MonitorServer.for_service(svc, port=args.monitor_port)
            print(f"[serve] monitor live at {server.url} "
                  "(/snapshot, /events, / = event display)")
        feeds, truth = {}, {}
        for i, sv in enumerate(servables):
            n = args.events // len(servables) + (
                i < args.events % len(servables))
            feeds[sv.name], truth[sv.name] = sv.events(n, 7 + i)
        single = args.model == ["ccn"]
        routed = {(None if single else name): f
                  for name, f in feeds.items()}
        served = submit_all(svc, routed,
                            {None: truth["ccn"]} if monitor else None)
        svc.drain()
        summary = svc.stats.summary()
        route_rows = svc.route_summary()
        bucket_rows = svc.bucket_summary()
        captures = svc.capture_summary()
        ft = svc.fault_tolerance_summary()
        snap = svc.monitor_snapshot() if monitor else None
        live = None
        if server is not None:
            # the live endpoint, read back over HTTP on localhost
            with urllib.request.urlopen(f"{server.url}/snapshot",
                                        timeout=10) as r:
                live = json.load(r)
    finally:
        if server is not None:
            server.close()
        svc.close()
    total = sum(len(v) for v in served.results.values())
    dt = served.elapsed_s
    print(f"[serve] {total} events in {dt:.3f}s -> {total / dt:,.0f} ev/s "
          f"({device_name(dev)}, {args.replicas} replica(s) per route, "
          f"{args.policy}, {args.loop} loop)")
    print(f"[serve] latency p50={summary['p50_us']:.0f}us "
          f"p99={summary['p99_us']:.0f}us batches={summary['batches']} "
          f"padded={summary['padded_events']}")
    bud = summary["budget"]
    print(f"[serve] budget queue_wait={bud['queue_wait_us_mean']:.0f}us "
          f"dispatch={bud['dispatch_us_mean']:.0f}us "
          f"compute={bud['compute_us_mean']:.0f}us")
    for rs in summary["per_replica"]:
        print(f"[serve]   replica {rs['replica_id']}: {rs['completed']} "
              f"events, {rs['batches']} batches, "
              f"{rs['throughput_ev_s']:,.0f} ev/s")
    for row in route_rows:
        print(f"[serve]   route {row['route']}: {row['submitted']} "
              f"submitted, {row['completed']} completed, {row['batches']} "
              f"batches, {row['padded_events']} padded")
    for row in bucket_rows:
        print(f"[serve]   bucket n_hits<={row['bucket']}: "
              f"{row['submitted']} events, {row['batches']} batches, "
              f"{row['padded_events']} padded")
    in_order = served.order == list(range(total))
    for (route, res), sv in zip(served.results.items(), servables):
        answered = sum(r is not None for r in res)
        print(f"[serve] route {sv.name}: {len(res)} events, "
              f"answered={answered} in-order={in_order}")
        if truth[sv.name] is not None:
            trig = np.asarray([bool(r["cps"]["trigger"]) if r is not None
                               else False for r in res])
            eff, fake = trigger_rates(trig, truth[sv.name])
            print(f"[serve] route {sv.name}: trigger efficiency={eff:.3f} "
                  f"fake rate={fake:.3f}")
    during = sum(c["captures"] - c["captured_at_start"] for c in captures)
    print(f"[serve] lanes captured during traffic: {during}")
    if fk["faults"] is not None:
        print_chaos(ft, served.failed)
    if snap is not None:
        def f3(x):      # snapshot stats are None when undefined (e.g.
            return "n/a" if x is None else f"{x:.3f}"   # one-class truth)

        print(f"[serve] monitor: {snap['events']} events, "
              f"trigger_rate={f3(snap['trigger_rate'])}, "
              f"efficiency={f3(snap['efficiency'])}, "
              f"fake_rate={f3(snap['fake_rate'])}, "
              f"rate={snap['rate_ev_s']:,.0f} ev/s (windowed)")
    if live is not None:
        ok = live["events"] == summary["completed"]
        print(f"[serve] /snapshot events={live['events']} vs stats "
              f"completed={summary['completed']} -> "
              f"{'MATCH' if ok else 'MISMATCH'}")
    disp = None
    if args.event_display:
        gen_cfg = detector_configs(args.detector)[1]
        disp = [event_display(r["cps"], event_id=i, detector=gen_cfg,
                              truth=bool(truth["ccn"][i]))
                for i, r in enumerate(
                    served.results[None][:args.event_display_n])
                if r is not None]
        write_display(args.event_display, disp)
        print(f"[serve] event display ({len(disp)} events) -> "
              f"{args.event_display}")
    if args.bench_out:
        bench = {"events": args.events, "elapsed_s": dt, "loop": args.loop,
                 "throughput_ev_s": total / dt,
                 "p50_us": summary["p50_us"], "p99_us": summary["p99_us"],
                 "routes": {row["route"]: {k: v for k, v in row.items()
                                           if k != "route"}
                            for row in route_rows},
                 "released_nonzero": total > 0}
        with open(args.bench_out, "w") as f:
            json.dump(bench, f, indent=2)
        print(f"[serve] multi-model stats -> {args.bench_out}")
    if not in_order:
        raise SystemExit("results were released out of submission order")
    if during:
        raise SystemExit(f"lanes captured {during} chunk shape(s) under "
                         "traffic")
    if fk["faults"] is None and served.failed:
        raise SystemExit(f"{served.failed} of {total} events went "
                         "unanswered without injected faults")
    if live is not None and live["events"] != summary["completed"]:
        raise SystemExit("monitor snapshot disagrees with serving stats")
    return Report(args, servables, feeds, truth, served, summary, captures,
                  ft, bucket_rows, snap, live, disp)


def main(argv=None):
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
