"""Sharded real-time trigger serving.

Mirrors the paper's demonstrator runtime (§III-B) and scales it out:
the paper sustains 2.94 M events/s by spatially parallelizing one
dataflow pipeline; here a ``ShardedTriggerService`` owns N replica
engines (each wrapping a ``deploy()``-produced executable), a router
that shards incoming events across them, and one merged release stage
so the three hard requirements from §I survive replication:

  (1) bounded decision latency  → per-replica micro-batching window
      with a deadline (zero-padded, like the paper's padding of
      missing inputs);
  (2) throughput                → batched dispatch + double buffering
      per replica, and replication across devices (lanes placed on
      the cards when more than one is visible, thread-backed lanes on
      one card otherwise);
  (3) strict in-order results   → a single ``InOrderReleaser`` keyed
      on the global submission sequence, so results complete in
      submission order no matter which replica finishes first.

Straggler mitigation: ``hedge_after_s`` re-dispatches a batch to a
backup lane if the primary hasn't returned in time; first result wins
(duplicate-safe because inference is pure).

``TriggerServingEngine`` (the original single-replica API) is kept as
a thin shim over a 1-replica service.

The port of ``repro/serving/engine.py``. On the card each replica given
a deployed pipeline serves through a lane of its own
(``core/pipeline.py:Lane``/``RaggedLane``): its own ``torch.cuda.Stream``,
its own captured chunk graphs, its own executor, and pinned host rings in
the streaming loop. A jitted JAX function may be shared by every replica;
the port's captured chunk may not (its static feeds and outputs would be
overwritten by another thread's replay), hence the lanes. A plain
callable is shared as in the reference. Not ported: the monitor
(``monitor=``, ``monitor_snapshot``, ``event_displays``) and a
``BucketedPipeline`` as ``buckets=`` (the port has no bucketed
deployment); both raise ``NotImplementedError``.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future

import numpy as np

from repro_torch.serving.health import BreakerConfig, ReplicaHealth
from repro_torch.serving.replica import (EventTiming, InOrderReleaser,
                                         ReplicaEngine, ServingStats,
                                         ShedError)
from repro_torch.serving.router import (POLICIES, Router, event_occupancy,
                                        pick_bucket_sorted)
from repro_torch.serving.streaming import LOOPS, StreamingReplicaEngine

#: where the parts that are not ported yet are queued
_MONITOR_TODO = ("the serving monitor (monitor=, monitor_snapshot, "
                 "event_displays) is not ported: ROADMAP.md queue 1, 'The "
                 "monitor, the monitor server and the event display'")
_BUCKETS_TODO = ("a BucketedPipeline as buckets= is not ported (the port has "
                 "no deploy_bucketed): ROADMAP.md queue 1, 'Bucketed "
                 "deployment and the design flow's report'; pass a "
                 "{n_hits: infer_fn} dict")

__all__ = ["AggregateStats", "ServingStats", "ShardedTriggerService",
           "ShedError", "TriggerServingEngine", "POLICIES", "LOOPS"]


class AggregateStats:
    """Merged view over the per-replica ``ServingStats``.

    The throughput clock starts at the *first submission*, not at
    construction — a service built early (e.g. before event generation)
    must not report a diluted rate."""

    def __init__(self, replicas):
        self._replicas = replicas
        self.first_submit_at: float | None = None

    def note_submission(self, t: float):
        """Called (under the service's sequence lock) on every submit;
        only the first one starts the clock."""
        if self.first_submit_at is None:
            self.first_submit_at = t

    # aggregate counters mirror the ServingStats field names so callers
    # can treat the two uniformly.
    def _sum(self, field):
        return sum(getattr(r.stats, field) for r in self._replicas)

    @property
    def completed(self):
        return self._sum("completed")

    @property
    def batches(self):
        return self._sum("batches")

    @property
    def hedged(self):
        return self._sum("hedged")

    @property
    def padded_events(self):
        return self._sum("padded_events")

    @property
    def latencies_s(self):
        out = []
        for r in self._replicas:
            out.extend(r.stats.samples("latencies_s"))
        return out

    def percentile(self, p):
        lat = self.latencies_s
        return float(np.percentile(lat, p)) if lat else float("nan")

    def throughput_ev_s(self):
        if self.first_submit_at is None:
            return 0.0
        dt = time.perf_counter() - self.first_submit_at
        return self.completed / dt if dt > 0 else 0.0

    def summary(self):
        lat = np.asarray(self.latencies_s)   # one merged copy per call

        def merged_mean_us(field):
            xs = []
            for r in self._replicas:
                xs.extend(r.stats.samples(field))
            return float(np.mean(xs)) * 1e6 if xs else None

        agg = {
            "replicas": len(self._replicas),
            "completed": self.completed,
            "failed": self._sum("failed"),
            "batches": self.batches,
            "hedged": self.hedged,
            "padded_events": self.padded_events,
            "shed": self._sum("shed"),
            "retried": self._sum("retried"),
            "failed_over": self._sum("failed_over"),
            "p50_us": float(np.percentile(lat, 50)) * 1e6
            if lat.size else None,
            "p99_us": float(np.percentile(lat, 99)) * 1e6
            if lat.size else None,
            "mean_us": float(lat.mean()) * 1e6 if lat.size else None,
            "throughput_ev_s": self.throughput_ev_s(),
            "budget": {
                "queue_wait_us_mean": merged_mean_us("queue_wait_s"),
                "dispatch_us_mean": merged_mean_us("dispatch_s"),
                "compute_us_mean": merged_mean_us("compute_s"),
            },
        }
        agg["per_replica"] = [r.stats.summary() for r in self._replicas]
        return agg


class ShardedTriggerService:
    """N replica engines behind a sharding router and one merged
    in-order release stage.

    ``infer_fn`` maps a dict of stacked numpy feeds (B=microbatch) to
    an output tree (dicts of arrays or tensors) with a leading batch
    dim, and must be pure (hedging re-executes).  Pass one callable
    shared by every replica, or a list of N callables (e.g. per-device
    executables). A deployed pipeline (anything with a ``lane``
    method: ``CompiledPipeline``, ``RaggedPipeline``), as ``infer_fn``,
    a ``routes=`` or bucket value or ``ragged=``, is not shared: each
    replica serves through ``pipe.lane(device)``, a lane of its own.

    ``devices``: ``"auto"`` places replica i on card ``i % n_cards``
    when more than one card is visible (see
    ``launch.mesh.replica_devices``; a lane there holds its own copy of
    the weights, a plain callable gets its feeds moved there); ``None``
    keeps every replica on the pipeline's device (thread-backed
    replicas, one lane each); a list pins replicas explicitly.

    Warm-up, before any replica takes traffic, one replica after
    another: each lane captures every chunk shape it serves
    (``Lane.warmup``; a capture fails if another thread calls CUDA
    meanwhile, and nothing is captured under traffic). This runs once
    per *lane*, where the reference warms once per distinct device: its
    jit cache is per device, the port's captures are per lane. Then
    ``warmup_fn``, an optional no-arg callable — pass
    ``repro_torch.tuning.make_warmup(cache)`` to replay every kernel
    shape the tuning cache knows about — runs once per distinct
    device, as in the reference. A failing warm-up raises (the
    reference swallows it): the port carries no failed capture on.

    ``monitor``: the reference's opt-in monitoring is not ported; a
    truthy value raises ``NotImplementedError``.

    ``loop``: the replica hot-loop flavor. ``"deadline"`` (default —
    the original behavior, bit-for-bit) launches a micro-batch when it
    fills or ``window_s`` elapses; ``"streaming"`` runs the persistent
    streaming-dataflow pipeline (``streaming.py``): rolling batching
    into preallocated input rings, async launch dispatch, and a
    harvest stage draining a host output ring — no deadline tick, so
    an arriving event joins the next in-flight launch instead of
    waiting for a batch boundary. Hedging is deadline-only.

    ``buckets``: occupancy-bucketed dispatch (paper-adjacent: size the
    datapath to per-event occupancy instead of the detector maximum).
    Pass a ``{n_hits: infer_fn}`` dict (a ``BucketedPipeline`` raises:
    not ported). Each bucket gets its own group of
    ``n_replicas`` replicas behind its own router; ``submit`` counts an
    event's non-zero hits (``mask_feed``), slices its feeds to the
    smallest bucket that fits (overflow falls back to the largest —
    hits are energy-sorted upstream, so truncation sheds the softest
    hits), and dispatches to that group. The shared in-order releaser
    spans *all* groups, so global submission order survives bucketing.

    ``routes``: heterogeneous-model dispatch. Pass a ``{name:
    infer_fn}`` dict — each named model gets its own group of
    ``n_replicas`` replicas behind its own router, and ``submit(event,
    route=name)`` picks the group (with a single route the argument may
    be omitted). Unlike ``buckets`` (one model, many launch shapes)
    this serves *different deployed pipelines* side by side — e.g. the
    CCN trigger next to an edge-based GNN — behind one shared in-order
    releaser, so global submission order survives heterogeneous
    routing. ``warmup_fn`` may be a ``{name: callable}`` dict to warm
    each route's kernels separately. Mutually exclusive with
    ``infer_fn`` and ``buckets``. Read per-route intake/completion with
    ``route_summary()``.

    ``ragged``: padding-free dispatch. Pass a
    ``core.pipeline.RaggedPipeline`` (from ``deploy(ragged=True)``) —
    submissions of *any* occupancy share one replica group, and each
    micro-batch bin-packs the events' actual hits on dispatch instead
    of padding every event to a bucket cap. High-variance occupancy
    mixes stop paying bucket quantization, and an event larger than
    every bucket cap is served exactly (no overflow-to-largest-bucket
    truncation). Host-side the protocol still stacks events at the
    detector's full hit capacity; the packing happens before the
    device launch, where the padding actually costs. Mutually
    exclusive with ``infer_fn``, ``buckets`` and ``routes``.
    """

    def __init__(self, infer_fn=None, *, n_replicas: int = 1,
                 microbatch: int, window_s: float = 1e-3,
                 queue_depth: int = 1024,
                 hedge_after_s: float | None = None,
                 policy: str = "round_robin", devices="auto",
                 inflight: int = 2, warmup_fn=None, monitor=False,
                 buckets=None, mask_feed: str = "mask",
                 routes=None, ragged=None, loop: str = "deadline",
                 faults=None, breaker=None, max_retries: int = 0,
                 shed: bool = False):
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        if monitor:
            raise NotImplementedError(_MONITOR_TODO)
        if loop not in LOOPS:
            raise ValueError(f"unknown replica loop {loop!r}; expected "
                             f"one of {LOOPS}")
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        self.loop = loop
        # fault tolerance (docs/serving.md): a seeded FaultPlan to
        # inject deterministic chaos, a circuit-breaker config (True
        # for defaults), bounded failover re-dispatch, and fast-fail
        # load shedding.  All default off — healthy-path behavior is
        # bit-identical without them.
        self.faults = faults
        if breaker is None or breaker is False:
            self.breaker = None
        elif breaker is True:
            self.breaker = BreakerConfig()
        elif isinstance(breaker, BreakerConfig):
            self.breaker = breaker
        else:
            raise TypeError("breaker= expects True/False/None or a "
                            "health.BreakerConfig")
        self.max_retries = int(max_retries)
        self.shed = bool(shed)
        self._retry_counts: dict[int, int] = {}
        self._retry_lock = threading.Lock()
        engine_cls = StreamingReplicaEngine if loop == "streaming" \
            else ReplicaEngine
        self.mask_feed = mask_feed
        route_warmups = None
        self.routes = ()
        self.ragged = ragged is not None
        if ragged is not None:
            if (infer_fn is not None or buckets is not None
                    or routes is not None):
                raise ValueError(
                    "pass exactly one of infer_fn, buckets=, routes= "
                    "or ragged= — a ragged service dispatches all "
                    "traffic through the padding-free executable")
            if not hasattr(ragged, "capacity"):
                raise TypeError(
                    "ragged= expects a core.pipeline.RaggedPipeline "
                    "(deploy(ragged=True) builds one)")
            self._ragged_capacity = int(ragged.capacity)
            # each replica's lane warms (captures) itself
            self.buckets = ()
            infer_fns = [ragged] * n_replicas
        elif routes is not None:
            if infer_fn is not None or buckets is not None:
                raise ValueError(
                    "pass exactly one of infer_fn, buckets= or routes= "
                    "— routed services dispatch all traffic through "
                    "the named route executables")
            route_fns = dict(routes)
            if not route_fns:
                raise ValueError("routes must name at least one route")
            self.routes = tuple(route_fns)
            if isinstance(warmup_fn, dict):
                route_warmups = {r: warmup_fn.get(r) for r in self.routes}
                warmup_fn = None
            infer_fns = [route_fns[r]
                         for r in self.routes for _ in range(n_replicas)]
            self.buckets = ()
        elif buckets is not None:
            if infer_fn is not None:
                raise ValueError(
                    "pass either infer_fn or buckets=, not both — "
                    "bucketed services route all traffic through the "
                    "bucket executables")
            if hasattr(buckets, "infer_fns"):     # BucketedPipeline
                raise NotImplementedError(_BUCKETS_TODO)
            bucket_fns = {int(b): fn for b, fn in dict(buckets).items()}
            if not bucket_fns:
                raise ValueError("buckets must name at least one bucket")
            self.buckets = tuple(sorted(bucket_fns))
            infer_fns = [bucket_fns[b]
                         for b in self.buckets for _ in range(n_replicas)]
        else:
            if infer_fn is None:
                raise ValueError(
                    "infer_fn is required unless buckets= or routes= "
                    "is given")
            self.buckets = ()
            infer_fns = infer_fn if isinstance(infer_fn, (list, tuple)) \
                else [infer_fn] * n_replicas
            if len(infer_fns) != n_replicas:
                raise ValueError(f"got {len(infer_fns)} infer_fns for "
                                 f"{n_replicas} replicas")
        total = len(infer_fns)
        if devices == "auto":
            from repro_torch.launch.mesh import replica_devices
            devices = replica_devices(total)
        elif devices is None:
            devices = [None] * total
        if len(devices) != total:
            raise ValueError(
                f"got {len(devices)} devices for {total} replicas")

        self.microbatch = microbatch
        self.window = window_s
        self.hedge_after = hedge_after_s
        self._seq = 0
        self._seq_lock = threading.Lock()
        self._releaser = InOrderReleaser(self._on_release)
        if route_warmups is not None:
            warmup_fns = [route_warmups[r]
                          for r in self.routes for _ in range(n_replicas)]
        else:
            warmup_fns = [warmup_fn] * total
        # per-replica health drives the breaker-aware router and the
        # failover target choice; None when the breaker is disabled.
        self.healths = {i: ReplicaHealth(i, self.breaker)
                        for i in range(total)} if self.breaker else None
        on_batch_failure = self._handle_batch_failure \
            if self.max_retries > 0 else None
        self.replicas = []
        warmed = set()   # (device, warmup identity): the tuning cache's
        #                  kernel shapes warm once per device
        try:
            for i, (fn, dev) in enumerate(zip(infer_fns, devices)):
                key = (dev, id(warmup_fns[i]))
                wf = warmup_fns[i] if key not in warmed else None
                warmed.add(key)
                # a deployed pipeline: this replica's own lane (its
                # warm-up in the engine captures before the engine's
                # threads start)
                if hasattr(fn, "lane"):
                    fn = fn.lane(dev)
                self.replicas.append(
                    engine_cls(fn, self._releaser, microbatch=microbatch,
                               window_s=window_s, queue_depth=queue_depth,
                               hedge_after_s=hedge_after_s, device=dev,
                               replica_id=i, inflight=inflight,
                               warmup_fn=wf, faults=faults,
                               health=self.healths[i]
                               if self.healths else None,
                               on_batch_failure=on_batch_failure,
                               shed=shed))
        except BaseException:
            # a warm-up that raised: the replicas already running stop
            # before the error goes on
            for r in self.replicas:
                r.close()
            raise
        if self.buckets:
            self._bucket_groups = {
                b: self.replicas[gi * n_replicas:(gi + 1) * n_replicas]
                for gi, b in enumerate(self.buckets)}
            self._bucket_routers = {
                b: Router(grp, policy, healths=self.healths)
                for b, grp in self._bucket_groups.items()}
            # per-bucket intake counters double as gap-free round-robin
            # indices within each bucket's replica group.
            self.bucket_counts = {b: 0 for b in self.buckets}
            self.router = None
            groups = self._bucket_groups.items()
            labels = {b: f"bucket {b}" for b in self.buckets}
        elif self.routes:
            self._route_groups = {
                r: self.replicas[gi * n_replicas:(gi + 1) * n_replicas]
                for gi, r in enumerate(self.routes)}
            self._route_routers = {
                r: Router(grp, policy, healths=self.healths)
                for r, grp in self._route_groups.items()}
            self.route_counts = {r: 0 for r in self.routes}
            self.router = None
            groups = self._route_groups.items()
            labels = {r: f"route {r}" for r in self.routes}
        else:
            self.router = Router(self.replicas, policy,
                                 healths=self.healths)
            groups = [(None, self.replicas)]
            labels = {None: ""}
        # replica_id -> (its failover group, human label) — failover
        # stays within the group (same executable/launch shape), and
        # drain() names the group when a lane wedges.
        self._group_of = {r.replica_id: grp
                          for g, grp in groups for r in grp}
        self._label_of = {r.replica_id: labels[g]
                          for g, grp in groups for r in grp}
        self._agg = AggregateStats(self.replicas)

    # ------------------------------------------------------------ client ----
    @staticmethod
    def _cut_event(event: dict, n: int) -> dict:
        """Slice (or zero-pad) every per-event feed's hit axis (axis 0)
        to exactly ``n`` rows — the chosen bucket's launch shape."""
        out = {}
        for key, v in event.items():
            v = np.asarray(v)
            if v.shape[0] >= n:
                out[key] = v[:n]
            else:
                pw = [(0, n - v.shape[0])] + [(0, 0)] * (v.ndim - 1)
                out[key] = np.pad(v, pw)
        return out

    def classify(self, event: dict) -> int:
        """The occupancy bucket this event would dispatch to."""
        if not self.buckets:
            raise RuntimeError("service is not occupancy-bucketed")
        # self.buckets is a sorted tuple -> allocation-free lookup
        return pick_bucket_sorted(
            event_occupancy(event, self.mask_feed), self.buckets)

    def submit(self, event: dict, *, truth: bool | None = None,
               route: str | None = None,
               deadline_s: float | None = None) -> Future:
        """Shard the event to a replica; returns a Future that resolves
        in global submission order.  Blocks (backpressure) when the
        chosen replica's bounded queue is full.

        With ``buckets``, the event is first classified by non-zero hit
        count and its feeds cut to the bucket's launch shape; dispatch
        then round-robins (or least-loads) within that bucket's replica
        group. Ordering is still global across buckets.

        With ``routes``, ``route`` names the model group the event
        dispatches to (optional when only one route is configured).
        Ordering is still global across routes.

        ``truth``: the reference's ground-truth bit for its monitor,
        which is not ported; accepted and unused.

        ``deadline_s``: optional per-event latency budget measured
        from this submit; an event still undispatched when it expires
        is shed (``ShedError``) instead of served late.  Combine with
        the service-level ``shed=True`` to also fail fast on a full
        lane queue."""
        t_submit = time.perf_counter()
        bucket = None
        if self.routes:
            if route is None:
                if len(self.routes) > 1:
                    raise ValueError(
                        "route= is required on a multi-route service; "
                        f"routes: {', '.join(self.routes)}")
                route = self.routes[0]
            if route not in self._route_groups:
                raise KeyError(f"unknown route {route!r}; routes: "
                               f"{', '.join(self.routes)}")
        elif route is not None:
            raise ValueError("service has no routes= configured")
        if self.buckets:
            # classify outside the sequence lock (O(hits) numpy count;
            # self.buckets is pre-sorted, the lookup allocates nothing)
            bucket = pick_bucket_sorted(
                event_occupancy(event, self.mask_feed), self.buckets)
            event = self._cut_event(event, bucket)
        elif self.ragged:
            # normalize every submission to the full hit capacity so
            # the batch loop can stack mixed occupancies; the ragged
            # executable re-packs actual hits before the launch
            event = self._cut_event(event, self._ragged_capacity)
        with self._seq_lock:
            seq = self._seq
            self._seq += 1
            self._agg.note_submission(t_submit)
            # pick under the lock so round-robin sees a gap-free seq
            # and least-loaded sees a consistent load snapshot.
            if bucket is not None:
                idx = self.bucket_counts[bucket]
                self.bucket_counts[bucket] = idx + 1
                replica = self._bucket_routers[bucket].pick(idx)
            elif route is not None:
                idx = self.route_counts[route]
                self.route_counts[route] = idx + 1
                replica = self._route_routers[route].pick(idx)
            else:
                replica = self.router.pick(seq)
        fut: Future = Future()
        if deadline_s is not None:
            # stamped on the future (always the item tuple's last
            # element) so neither loop's item shapes change
            fut.deadline = t_submit + deadline_s
        replica.enqueue(seq, t_submit, event, fut)
        return fut

    # ----------------------------------------------------------- release ----
    def _on_release(self, seq: int, outcome, timing: EventTiming,
                    fut: Future):
        if self.max_retries:
            with self._retry_lock:
                self._retry_counts.pop(seq, None)
        st = self.replicas[timing.replica_id].stats
        kind, value = outcome
        if kind == "ok":
            st.record_release(timing)
            if not fut.cancelled():   # client gave up; stats still count
                fut.set_result(value)
        else:
            st.failed += 1
            if not fut.cancelled():
                fut.set_exception(value)

    # ---------------------------------------------------------- failover ----
    def _failover_target(self, source):
        """A healthy sibling in the failing replica's group, or None
        when the batch must fail to the client."""
        group = self._group_of[source.replica_id]
        cands = [r for r in group if r is not source and not r.stopping]
        if not cands:
            return None
        if self.healths is not None:
            cands = [r for r in cands
                     if self.healths[r.replica_id].available()]
            if not cands:
                return None
            return min(cands, key=lambda r: (
                r.load(), self.healths[r.replica_id].score(),
                r.replica_id))
        return min(cands, key=lambda r: (r.load(), r.replica_id))

    def _handle_batch_failure(self, replica, items, exc):
        """Failover hook (runs on the failing replica's dispatch or
        harvest thread): re-dispatch each event of a failed batch to a
        healthy sibling, bounded by ``max_retries`` per event; returns
        the items that could not be moved — the replica releases those
        as errors, so every event still resolves exactly once."""
        remaining = []
        for it in items:
            try:
                seq, t_submit, event, fut = it[0], it[1], it[-2], it[-1]
                with self._retry_lock:
                    n = self._retry_counts.get(seq, 0)
                    if n >= self.max_retries:
                        remaining.append(it)
                        continue
                    self._retry_counts[seq] = n + 1
                target = self._failover_target(replica)
                if target is None or not target.requeue(
                        seq, t_submit, event, fut):
                    remaining.append(it)
            except Exception:  # noqa: BLE001 — failover is best-effort;
                remaining.append(it)   # the event fails to the client
        return remaining

    # -------------------------------------------------------- monitoring ----
    @property
    def monitoring(self) -> bool:
        return False

    def monitor_snapshot(self):
        raise NotImplementedError(_MONITOR_TODO)

    def fault_tolerance_summary(self) -> dict:
        """Shed / retried / failed-over counters plus per-replica
        breaker state — the fault-path view."""
        states = {str(i): h.state()
                  for i, h in (self.healths or {}).items()}
        return {
            "shed": sum(r.stats.shed for r in self.replicas),
            "retried": sum(r.stats.retried for r in self.replicas),
            "failed_over": sum(r.stats.failed_over
                               for r in self.replicas),
            "max_retries": self.max_retries,
            "breaker": {
                "enabled": self.healths is not None,
                "open": sum(1 for s in states.values() if s == "open"),
                "half_open": sum(1 for s in states.values()
                                 if s == "half_open"),
                "states": states,
            },
        }

    def event_displays(self, n: int | None = None) -> list[dict]:
        raise NotImplementedError(_MONITOR_TODO)

    def capture_summary(self) -> list[dict]:
        """Per replica: the chunk shapes its lane captured in its warm-up
        (``captured_at_start``) and has now (``captures``); equal unless
        a lane captured under traffic. A replica without a lane reads 0."""
        return [{"replica_id": r.replica_id, "captured_at_start": r.captured,
                 "captures": r.lane.captures if r.lane is not None else 0}
                for r in self.replicas]

    def route_summary(self) -> list[dict]:
        """Per-route intake/completion view (empty when unrouted)."""
        out = []
        for r in self.routes:
            grp = self._route_groups[r]
            out.append({
                "route": r,
                "replicas": len(grp),
                "submitted": self.route_counts[r],
                "completed": sum(e.stats.completed for e in grp),
                "batches": sum(e.stats.batches for e in grp),
                "padded_events": sum(e.stats.padded_events for e in grp),
            })
        return out

    def bucket_summary(self) -> list[dict]:
        """Per-bucket intake/completion view (empty when unbucketed)."""
        out = []
        for b in self.buckets:
            grp = self._bucket_groups[b]
            out.append({
                "bucket": b,
                "replicas": len(grp),
                "submitted": self.bucket_counts[b],
                "completed": sum(r.stats.completed for r in grp),
                "batches": sum(r.stats.batches for r in grp),
                "padded_events": sum(r.stats.padded_events for r in grp),
            })
        return out

    # ----------------------------------------------------------- control ----
    @property
    def stats(self) -> AggregateStats:
        return self._agg

    def drain(self, timeout: float = 30.0):
        t0 = time.perf_counter()
        while (any(r.queued for r in self.replicas)
               or self._releaser.pending
               or self._releaser.released < self._seq):
            if time.perf_counter() - t0 > timeout:
                raise TimeoutError("serving service drain timeout: "
                                   + self._drain_report())
            time.sleep(1e-3)

    def _drain_report(self) -> str:
        """Name the stuck lanes (id, group, queued/in-flight counts)
        so a wedged replica is identifiable from the exception
        alone."""
        parts = []
        for r in self.replicas:
            queued = r.queued
            in_flight = r.load() - queued
            if queued or in_flight > 0:
                label = self._label_of.get(r.replica_id, "")
                where = f" ({label})" if label else ""
                parts.append(f"replica {r.replica_id}{where}: "
                             f"queued={queued} in_flight={in_flight}")
        if not parts:
            parts.append("no replica reports load")
        parts.append(f"releaser: released={self._releaser.released} "
                     f"pending={self._releaser.pending} "
                     f"submitted={self._seq}")
        return "; ".join(parts)

    def close(self):
        for r in self.replicas:
            r.close()


class TriggerServingEngine(ShardedTriggerService):
    """Single-replica engine — the original demonstrator-style API.

    ``stats`` is the replica's own ``ServingStats`` (mutable counters +
    raw latency lists), exactly as before the sharded refactor."""

    def __init__(self, infer_fn, *, microbatch: int, window_s: float = 1e-3,
                 queue_depth: int = 1024,
                 hedge_after_s: float | None = None, monitor=False,
                 loop: str = "deadline", faults=None, breaker=None,
                 max_retries: int = 0, shed: bool = False):
        super().__init__(infer_fn, n_replicas=1, microbatch=microbatch,
                         window_s=window_s, queue_depth=queue_depth,
                         hedge_after_s=hedge_after_s, devices=None,
                         monitor=monitor, loop=loop, faults=faults,
                         breaker=breaker, max_retries=max_retries,
                         shed=shed)

    @property
    def stats(self) -> ServingStats:
        return self.replicas[0].stats
