"""Serving entry point: ``python -m repro_torch.launch.serve [...]``.

Counterpart of ``repro/launch/serve.py`` run with ``--replicas 1``: each
model named by ``--model`` (default ``ccn``) is a route of the
serve-side registry ``MODELS``. A route deploys its model through the
whole design flow (``core/pipeline.py:deploy``; the model joins through
its ``core.graph_ir`` exporter, with ``--target-throughput`` and
``--tpu-native-gravnet`` in its ``Requirements``) and makes its own
synthetic events:

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

The JAX package's ``launch/serve.py`` serves through
``ShardedTriggerService`` (router, per-route replica groups, in-order
release). This one is a plain in-order loop instead, at the service's
micro-batch width there: ``max(pipe.microbatch, 16)`` events per
dispatch for ``ccn`` alone; for any other ``--model`` selection
``max(8, *microbatches)`` over the routes, each route first warmed with
that many events of seed 99. It dispatches one route after another in
turn, as the reference interleaves its routes' streams, and brings each
dispatch's results to the host before it sends the next, so every
route's results come back in submission order. An event's decision
latency is the time from the dispatch of its micro-batch to its results
being on the host. The serving layer, occupancy buckets (and with them
the bucketed deployment's tuning branch) and the padding-free ragged
path's flag are not ported: ``build_pipeline(..., ragged=True,
batch=8)`` deploys the ragged path (the reference has no flag for it
either) and ``serve_events`` serves it.

Runs on ``cuda`` unless ``--device cpu`` is given. On ``cuda`` each
route's warm-up dispatch (events of seed 99) captures its chunk shapes
as CUDA graphs (``core/pipeline.py``), so the timed loop replays the
captured graphs only.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import caloclusternet as ccn
from repro_torch.core.condensation import condensation_loss
from repro_torch.core.graph_ir import export_graph
from repro_torch.core.pipeline import Requirements, deploy
from repro_torch.data.belle2 import Belle2Config, current_detector, generate
from repro_torch.device import resolve_device
from repro_torch.models.gnn import gatedgcn, graphsage
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_warmup)
from repro_torch.optim.adamw import tree_map
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


def build_pipeline(cfg: ccn.CCNConfig, gen_cfg, *, design_point: int = 3,
                   precision: str = "mixed", fuse_gravnet_block: bool = True,
                   fuse_int8: bool = True, batch: int = 1,
                   ragged: bool = False, tuning_cache=None,
                   target_throughput: float = TARGET_THROUGHPUT,
                   tpu_native_gravnet: bool = False, params=None,
                   device=None):
    """CaloClusterNet weights ``params`` (default: random from seed 0),
    exported and deployed as repro/launch/serve.py deploys it (its CPU
    cost constants, so the design flow picks the same P and
    micro-batch; its calibration batch from ``gen_cfg``).
    ``target_throughput`` and ``tpu_native_gravnet`` are the
    ``Requirements``'; ``batch``, ``ragged`` and ``tuning_cache`` are
    ``deploy``'s: ``ragged=True`` returns the padding-free
    ``RaggedPipeline`` with ``batch`` bins per launch."""
    if params is None:
        params = ccn.init(torch.Generator().manual_seed(0), cfg)
    req = Requirements(design_point=design_point, platform="cpu",
                       precision_policy=precision, n_hits=cfg.n_hits,
                       target_throughput=target_throughput,
                       max_latency_s=2e-3,
                       tpu_native_gravnet=tpu_native_gravnet)
    return deploy(export_graph("caloclusternet", params, cfg), req,
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
    ``CaloClusterNet.forward`` on ``batch``, its gradients by autograd,
    one AdamW update at rate ``lr``. Returns (new params, new optimizer
    state, loss); ``params`` and ``opt`` are left as they are."""
    model = ccn.CaloClusterNet(params, cfg)
    leaves = {name: {key: getattr(model.layers[name], key) for key in p}
              for name, p in params.items()}
    flat = [t for p in leaves.values() for t in p.values()]
    for t in flat:
        t.requires_grad_(True)
    out = model(batch["feats"], batch["mask"])
    labels = {k: batch[k] for k in ("object_id", "energy", "cls")}
    loss, _ = condensation_loss(out, labels, batch["mask"],
                                k_max=cfg.k_max)
    it = iter(torch.autograd.grad(loss, flat))
    grads = {name: {key: next(it) for key in p}
             for name, p in leaves.items()}
    new_params, new_opt, _ = adamw_update(grads, opt, params, lr=lr,
                                          cfg=ocfg)
    return new_params, new_opt, loss.detach()


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
    return Requirements(design_point=args.design_point, platform="cpu",
                        precision_policy="fp", n_hits=_EDGE_N,
                        target_throughput=args.target_throughput,
                        max_latency_s=2e-3,
                        tpu_native_gravnet=args.tpu_native_gravnet)


def _ccn_servable(args, cfg=None, tuning_cache=None,
                  params=None) -> Servable:
    """CaloClusterNet of ``--detector`` (or ``cfg`` on that detector's
    events) under ``--precision``, with weights ``params`` (default:
    random from seed 0)."""
    det_cfg, gen_cfg = detector_configs(args.detector)
    pipe = build_pipeline(cfg or det_cfg, gen_cfg,
                          design_point=args.design_point,
                          precision=args.precision,
                          fuse_gravnet_block=not args.no_fuse_gravnet_block,
                          fuse_int8=not args.no_fuse_int8,
                          tuning_cache=tuning_cache,
                          target_throughput=args.target_throughput,
                          tpu_native_gravnet=args.tpu_native_gravnet,
                          params=params, device=args.device)

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
    """(problems of ``pipe``'s graph that ``cache`` holds, problems)."""
    g = pipe.graph
    keys = graph_kernel_problems(g, n_rows=g.meta["n_hits"],
                                 backend=pipe.backend)
    return sum(k in cache for k in keys), len(keys)


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


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", nargs="+", default=["ccn"],
                    choices=sorted(MODELS), metavar="NAME",
                    help="registered model route(s) to serve, one "
                         f"dispatch of each in turn: {sorted(MODELS)} "
                         "(default ccn)")
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
                    help="events/s target for the design flow's P search "
                         "(CPU scale)")
    ap.add_argument("--tpu-native-gravnet", action="store_true",
                    help="partition the GravNet aggregation onto the "
                         "kernel target (Requirements.tpu_native_gravnet)")
    ap.add_argument("--train-steps", type=int, default=TRAIN_STEPS,
                    help="warm-training steps before --model ccn alone is "
                         "deployed (0: serve the random weights)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="default: cuda (raises when CUDA is absent)")
    ap.add_argument("--tuning-cache", default=None, metavar="PATH",
                    help="JSON kernel-tuning cache consulted when binding "
                         "kernels and warming up (absent/corrupt -> "
                         "heuristic defaults)")
    ap.add_argument("--tune", action="store_true",
                    help="autotune every route's kernel problems before "
                         "serving; winners are saved to --tuning-cache "
                         "when given")
    args = ap.parse_args(argv)
    if args.events < len(args.model):
        ap.error(f"--events {args.events} leaves a route of "
                 f"{args.model} without events")
    return args


def main(argv=None):
    args = parse_args(argv)
    cache = load_tuning_cache(args)
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
            g = sv.pipe.graph
            fresh = _tune_and_rebind(
                cache, args, [(g, g.meta["n_hits"], 1, sv.pipe.backend)],
                lambda m=m: servable(m))
            if fresh is not None:
                sv = fresh
        servables.append(sv)
    # the service's micro-batch: ccn alone, its own; several routes, one
    # width for all
    width = None if single else max(
        MIN_ROUTES_BATCH, *(sv.pipe.microbatch for sv in servables))
    routes, truth = {}, {}
    dev = servables[0].pipe.device
    dev_name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu")
    for i, sv in enumerate(servables):
        pipe = sv.pipe
        precision = args.precision if sv.name == "ccn" else "fp"
        print(f"[serve] deployed {sv.name}: design point "
              f"{args.design_point}, {precision} on {dev} ({dev_name}): "
              f"segments={len(pipe.segments)} "
              f"microbatch={pipe.microbatch} blocks="
              f"{sum(op.op_type == 'gravnet_block' for op in pipe.graph)}")
        if cache is not None:
            hits, n_keys = cache_hits(pipe, cache)
            print(f"[serve] route {sv.name}: {hits} of {n_keys} kernel "
                  "problems bound from the tuning cache")
        # one warm-up dispatch per route: its first launches, and on the
        # card the capture of every chunk shape it serves
        if width is None:
            batch = max(pipe.microbatch, MIN_SERVE_BATCH)
            serve_events(pipe, sv.events(batch, 99)[0])
        else:
            pipe(sv.events(width, 99)[0])
        n = args.events // len(servables) + (i < args.events % len(servables))
        feeds, truth[sv.name] = sv.events(n, 7 + i)
        routes[sv.name] = (pipe, feeds)
    if width is not None:
        print(f"[serve] routes {list(routes)}: microbatch={width}")
    if cache is not None and len(cache):
        warmed = make_warmup(cache, backend=servables[0].pipe.backend)()
        print(f"[serve] warmed {warmed} cached kernel shape(s) before "
              "serving")
    print("[serve] chunk shapes captured as CUDA graphs before serving: "
          + ", ".join(f"{name} {pipe.captures}"
                      for name, (pipe, _) in routes.items()))

    res, dt = serve_routes(routes, width)
    total = sum(len(r[1]) for r in res.values())
    print(f"[serve] {total} events in {dt:.3f}s -> {total / dt:,.0f} ev/s "
          f"({dev_name}, in-order loop, one dispatch per route in turn: "
          f"{', '.join(routes)})")
    for rname, (out, lat, busy) in res.items():
        pipe = routes[rname][0]
        n = len(lat)
        answered = len(next(iter(out.values())))
        print(f"[serve] route {rname}: {n} events, "
              f"{width or max(pipe.microbatch, MIN_SERVE_BATCH)} per "
              f"dispatch, {n / busy:,.0f} ev/s in its dispatches, latency "
              f"p50={np.percentile(lat, 50) * 1e6:.0f}us "
              f"p99={np.percentile(lat, 99) * 1e6:.0f}us "
              f"answered={answered} in-order=True")
        if answered != n:
            raise SystemExit(f"route {rname} answered {answered} of {n} "
                             "events")
        if truth[rname] is not None:
            eff, fake = trigger_rates(out["cps"]["trigger"], truth[rname])
            print(f"[serve] route {rname}: trigger efficiency={eff:.3f} "
                  f"fake rate={fake:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
