"""Per-replica serving machinery: stats, the merged in-order release
stage, and the replica micro-batch loop.

The port of ``repro/serving/replica.py``. What differs on the card: a
replica given a deployed pipeline serves through its own lane
(``core/pipeline.py:Lane``: a CUDA stream, captures and executor of its
own), and the reference's ``jax.default_device``, ``jax.device_put`` and
``tree_flatten`` + ``np.asarray`` become the lane's warm-up, its copies
in and out, and :mod:`repro_torch.serving.tree`. A lane's result is in
flight (``InFlight``) until its event has passed; the batch's compute
time includes that wait. The lane captures every chunk shape it serves
in its warm-up, before the replica's threads start, and a warm-up that
fails raises: where the reference swallows a failed warm-up, the port
catches no failed capture.

A ``ReplicaEngine`` is one lane of the sharded service: it owns a
bounded event queue, a micro-batching collector (batch launches when
``microbatch`` events are queued *or* ``window_s`` has elapsed — the
paper's bounded-decision-latency deadline), and a double-buffered
dispatch loop (up to ``inflight`` batches executing while the next
fills, the FPGA analogue of overlapping Load/compute/Store).  Replicas
never release results themselves: every completion is handed to a
shared ``InOrderReleaser`` keyed on the *global* submission sequence
number, so strict submission order is preserved across replicas no
matter how their batches interleave.

This module implements the **deadline** loop (the original
request/response-shaped micro-batcher); ``streaming.py`` subclasses
``ReplicaEngine`` with the persistent streaming-dataflow loop
(preallocated input/output rings, rolling batching, no deadline tick).
The service selects between them with ``loop=``.

Latency budget accounting (paper §III): each event's end-to-end latency
is split into

  queue_wait — submit() until the collector pops the event;
  dispatch   — batch assembly: fill-window residency after the pop,
               stacking/zero-padding, and device placement;
  compute    — the inference call itself (including any hedged retry).

Fault tolerance (docs/serving.md): ``faults=`` wraps the replica's
``infer_fn`` with a deterministic injector (``serving.faults``),
``health=`` feeds a circuit breaker (``serving.health``) one outcome
per batch, ``on_batch_failure=`` lets the service re-dispatch a failed
batch's events to a healthy sibling before they fail to the client,
and ``shed=`` plus a per-event deadline turn the blocking enqueue into
fail-fast admission control (``ShedError``).  All four default off,
reproducing the original behavior bit-for-bit.
"""
from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from collections import deque
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeout
from concurrent.futures import wait as futures_wait

import numpy as np
import torch

from repro_torch.core.pipeline import InFlight, Lane, RaggedLane
from repro_torch.serving.tree import host_array, tree_flatten, tree_unflatten

# per-replica sliding window for latency/budget samples; counters stay
# exact, percentiles reflect the most recent window.
STAT_WINDOW = 65536


class ShedError(RuntimeError):
    """The service refused an event instead of blocking: its lane's
    bounded queue was full under a shed policy, or its deadline
    expired before dispatch.  Load-shedding admission control — the
    client sees the rejection immediately and can drop or resubmit."""


@dataclasses.dataclass
class EventTiming:
    """perf_counter timestamps for one event's trip through a replica."""
    replica_id: int
    t_submit: float
    t_collect: float
    t_dispatch: float
    t_done: float

    @property
    def latency_s(self):
        return self.t_done - self.t_submit

    @property
    def queue_wait_s(self):
        return self.t_collect - self.t_submit

    @property
    def dispatch_s(self):
        return self.t_dispatch - self.t_collect

    @property
    def compute_s(self):
        return self.t_done - self.t_dispatch


def _pct(xs, p):
    return float(np.percentile(np.fromiter(xs, float), p)) if xs \
        else float("nan")


def _stat_window():
    return deque(maxlen=STAT_WINDOW)


@dataclasses.dataclass
class ServingStats:
    """Per-replica counters + bounded sliding-window latency samples
    (the counters are exact for the lifetime of the replica; the
    sample deques hold the last ``STAT_WINDOW`` events so a
    long-running service neither grows without bound nor slows down
    ``summary()``).

    ``latencies_s``/``completed`` are updated by the release stage (so
    they observe strict release order); the batch counters are updated
    by the replica's dispatch loop.  Readers (``summary``, monitoring
    threads) must go through ``samples()``, which snapshots a deque
    under the stats lock — iterating a deque while the releaser
    appends to it raises RuntimeError.
    """
    replica_id: int = 0
    submitted: int = 0
    completed: int = 0
    failed: int = 0
    batches: int = 0
    hedged: int = 0
    padded_events: int = 0
    # fault-tolerance counters: events refused by admission control,
    # events this replica accepted as failover retries, and events a
    # failed batch handed off to a healthy sibling (all 0 on the
    # healthy path).
    shed: int = 0
    retried: int = 0
    failed_over: int = 0
    latencies_s: deque = dataclasses.field(default_factory=_stat_window)
    queue_wait_s: deque = dataclasses.field(default_factory=_stat_window)
    dispatch_s: deque = dataclasses.field(default_factory=_stat_window)
    compute_s: deque = dataclasses.field(default_factory=_stat_window)
    # throughput clock: stamped by the first enqueue, not construction,
    # so a replica built long before traffic reports an honest rate.
    started_at: float | None = None
    lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    def samples(self, field: str) -> list:
        """Consistent copy of one sample deque, safe against a live
        release stage."""
        with self.lock:
            return list(getattr(self, field))

    def percentile(self, p):
        return _pct(self.samples("latencies_s"), p)

    def record_release(self, timing: EventTiming):
        with self.lock:
            self.completed += 1
            self.latencies_s.append(timing.latency_s)
            self.queue_wait_s.append(timing.queue_wait_s)
            self.dispatch_s.append(timing.dispatch_s)
            self.compute_s.append(timing.compute_s)

    def throughput_ev_s(self):
        if self.started_at is None:
            return 0.0
        dt = time.perf_counter() - self.started_at
        return self.completed / dt if dt > 0 else 0.0

    def budget(self):
        """Mean per-event latency-budget split, in µs."""
        def mean_us(xs):
            return float(np.fromiter(xs, float).mean()) * 1e6 \
                if xs else None
        return {
            "queue_wait_us_mean": mean_us(self.samples("queue_wait_s")),
            "dispatch_us_mean": mean_us(self.samples("dispatch_s")),
            "compute_us_mean": mean_us(self.samples("compute_s")),
        }

    def summary(self):
        lat = self.samples("latencies_s")
        return {
            "replica_id": self.replica_id,
            "submitted": self.submitted,
            "completed": self.completed,
            "failed": self.failed,
            "batches": self.batches,
            "hedged": self.hedged,
            "padded_events": self.padded_events,
            "shed": self.shed,
            "retried": self.retried,
            "failed_over": self.failed_over,
            "p50_us": _pct(lat, 50) * 1e6 if lat else None,
            "p99_us": _pct(lat, 99) * 1e6 if lat else None,
            "mean_us": float(np.fromiter(lat, float).mean()) * 1e6
            if lat else None,
            "throughput_ev_s": self.throughput_ev_s(),
            "budget": self.budget(),
        }


class InOrderReleaser:
    """Merged release stage: completes futures in global submission
    order regardless of which replica finished first.

    ``complete`` may be called from any replica's dispatch thread; the
    shared lock serializes releases, and a completion for sequence
    number ``k`` is only released once every ``j < k`` has been."""

    def __init__(self, on_release):
        # on_release(seq, outcome, timing, fut); outcome is
        # ("ok", value) or ("err", exception).
        self._on_release = on_release
        self._next = 0
        self._held: dict[int, tuple] = {}
        self._lock = threading.Condition()
        self.released = 0

    def complete(self, seq: int, outcome, timing: EventTiming, fut):
        with self._lock:
            if seq < self._next:
                # exactly-once backstop: a late duplicate (e.g. a buggy
                # failover hook) must not park a stale entry in _held
                # and wedge drain() forever.
                return
            self._held[seq] = (outcome, timing, fut)
            while self._next in self._held:
                out, tm, f = self._held.pop(self._next)
                try:
                    self._on_release(self._next, out, tm, f)
                except Exception:  # noqa: BLE001 — a client-cancelled
                    pass  # future (InvalidStateError) or a bad done-
                    #       callback must not wedge every later seq
                self._next += 1
                self.released += 1
            self._lock.notify_all()

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._held)


class ReplicaEngine:
    """One serving lane: bounded queue -> deadline micro-batcher ->
    double-buffered dispatch -> shared in-order releaser."""

    loop = "deadline"

    def __init__(self, infer_fn, releaser: InOrderReleaser, *,
                 microbatch: int, window_s: float = 1e-3,
                 queue_depth: int = 1024, hedge_after_s: float | None = None,
                 device=None, replica_id: int = 0, inflight: int = 2,
                 warmup_fn=None, faults=None, health=None,
                 on_batch_failure=None, shed: bool = False):
        # an infer_fn that is this replica's own lane of a deployed
        # pipeline (Lane / RaggedLane) captures before traffic below.
        # The reference's monitor tap (``monitor``, ``truth_map``) is not
        # ported.
        # chaos wrapping happens here — before either loop flavor sees
        # ``self._infer`` — so deadline and streaming dispatch inject
        # at the same point.  ``health`` is this lane's ReplicaHealth
        # (one outcome per batch); ``on_batch_failure(replica, items,
        # exc) -> remaining`` is the service's failover hook; ``shed``
        # turns a full queue into a fast ShedError instead of blocking.
        self._faults = None
        if faults is not None:
            self._faults = faults.for_replica(replica_id)
            self._infer = self._faults.wrap(infer_fn)
        else:
            self._infer = infer_fn
        self._health = health
        self._on_batch_failure = on_batch_failure
        self.shed = bool(shed)
        self._releaser = releaser
        self.microbatch = microbatch
        self.window = window_s
        self.hedge_after = hedge_after_s
        self.device = device
        self.inflight = inflight
        self.replica_id = replica_id
        self.stats = ServingStats(replica_id=replica_id)
        # warm-up runs BEFORE the batcher thread starts accepting work:
        # the lane captures every chunk shape it serves (the first real
        # event must never pay a capture, and a capture fails if another
        # thread calls CUDA meanwhile), then ``warmup_fn`` (e.g. replaying
        # tuning-cache winners). A failing warm-up raises.
        self.lane = infer_fn if isinstance(infer_fn, (Lane, RaggedLane)) \
            else None
        self.captured = self.lane.warmup() if self.lane is not None else 0
        self.warmed = 0
        if warmup_fn is not None:
            with (torch.cuda.device(self.device) if self.device is not None
                  else contextlib.nullcontext()):
                out = warmup_fn()
            self.warmed = int(out) if isinstance(out, int) else 1
        self._q: queue.Queue = queue.Queue(maxsize=queue_depth)
        self._stop = threading.Event()
        self._count_lock = threading.Lock()
        self._inflight_sem = threading.Semaphore(inflight)
        self._dispatch_pool = ThreadPoolExecutor(
            max_workers=inflight,
            thread_name_prefix=f"replica{replica_id}-dispatch")
        self._hedge_pool = ThreadPoolExecutor(
            max_workers=2 * inflight,
            thread_name_prefix=f"replica{replica_id}-hedge") \
            if hedge_after_s is not None else None
        self._batcher = threading.Thread(
            target=self._run, daemon=True,
            name=f"replica{replica_id}-batcher")
        # loop-specific state (e.g. the streaming engine's rings and
        # harvest thread) must exist before the batcher thread runs.
        self._setup_loop()
        self._batcher.start()

    def _setup_loop(self):
        """Hook for subclasses to build loop state (rings, extra
        stage threads) before the batcher thread starts."""

    # ------------------------------------------------------------ intake ----
    def enqueue(self, seq: int, t_submit: float, event: dict, fut):
        """Blocks when the bounded queue is full (the paper's limited
        buffer capacity -> backpressure on the client).  A close() that
        happens while we are blocked (or raced with the put) fails this
        event's future instead of stranding it in a dead queue.

        With ``shed=True`` a full queue sheds the event immediately
        (``ShedError``) instead of spinning; an event whose deadline
        (stamped on the future by ``submit(deadline_s=)``) has already
        expired is shed regardless of the policy."""
        with self._count_lock:
            self.stats.submitted += 1
            if self.stats.started_at is None:
                self.stats.started_at = t_submit
        item = (seq, t_submit, event, fut)
        dl = getattr(fut, "deadline", None)
        if dl is not None and time.perf_counter() > dl:
            self._shed_items([item], "deadline expired before enqueue")
            return
        if self.shed:
            try:
                self._q.put_nowait(item)
            except queue.Full:
                self._shed_items(
                    [item], f"replica {self.replica_id} queue full "
                            f"({self._q.maxsize} events)")
                return
            if self._stop.is_set():
                self._fail_queued()   # put may have landed after close()
            return
        placed = False
        while not placed and not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                placed = True
            except queue.Full:
                continue
        if not placed:
            self._fail_items([item])
        elif self._stop.is_set():
            self._fail_queued()   # put may have landed after close()

    def requeue(self, seq: int, t_submit: float, event: dict,
                fut) -> bool:
        """Failover intake: accept an event from another replica's
        failed batch without ever blocking.  False (caller keeps
        ownership of the event) when this lane is stopping or full."""
        if self._stop.is_set():
            return False
        try:
            self._q.put_nowait((seq, t_submit, event, fut))
        except queue.Full:
            return False
        with self._count_lock:
            self.stats.submitted += 1
            self.stats.retried += 1
            if self.stats.started_at is None:
                self.stats.started_at = t_submit
        if self._stop.is_set():
            self._fail_queued()   # close() raced the put; still released
        return True

    def load(self) -> int:
        """Events accepted but not yet released — the least-loaded
        router's ranking signal.  Failed-over events were released by
        a *different* replica, so they are subtracted here to keep the
        signal from drifting."""
        return self.stats.submitted - self.stats.completed \
            - self.stats.failed - self.stats.failed_over

    @property
    def stopping(self) -> bool:
        return self._stop.is_set()

    @property
    def queued(self) -> int:
        return self._q.qsize()

    # ----------------------------------------------------------- batcher ----
    def _collect(self):
        items = []
        deadline = None
        while len(items) < self.microbatch and not self._stop.is_set():
            timeout = self.window if deadline is None else \
                max(1e-4, deadline - time.perf_counter())
            try:
                seq, t_submit, event, fut = self._q.get(timeout=timeout)
            except queue.Empty:
                if items:
                    break
                continue
            dl = getattr(fut, "deadline", None)
            if dl is not None and time.perf_counter() > dl:
                self._shed_items([(seq, t_submit, event, fut)],
                                 "deadline expired in queue")
                continue
            items.append((seq, t_submit, time.perf_counter(), event, fut))
            if deadline is None:
                deadline = time.perf_counter() + self.window
            if deadline and time.perf_counter() > deadline:
                break
        return items

    def _run(self):
        while not self._stop.is_set():
            items = self._collect()
            if not items:
                continue
            if self._faults is not None \
                    and self._faults.batcher_kill_due():
                # chaos: the batcher thread dies mid-batch.  The
                # collected items are failed exactly once first (a
                # stranded future would hold every later seq hostage);
                # later arrivals queue until close() sweeps them.
                from repro_torch.serving.faults import InjectedFault
                self._resolve_err(items, InjectedFault(
                    f"injected batcher kill "
                    f"(replica {self.replica_id})"))
                return
            # double buffering: hand the batch to the dispatch pool and
            # immediately go back to collecting the next one; the
            # semaphore bounds how many batches are in flight.
            acquired = False
            while not (acquired := self._inflight_sem.acquire(timeout=0.1)):
                if self._stop.is_set():
                    break
            if not acquired:
                self._fail_items(items)   # closing: don't strand futures
                return
            self._dispatch_pool.submit(self._dispatch, items)

    def _fail_items(self, items):
        """Fail events that will never be dispatched — routed through
        the shared releaser so their sequence numbers still advance
        ``_next``; bypassing it would hold every later sequence (on any
        replica) hostage forever."""
        self._resolve_err(items, RuntimeError(
            "serving replica closed before dispatch"))

    def _shed_items(self, items, reason: str):
        """Admission control: release refused events (full queue or
        expired deadline) as ``ShedError`` — fail fast, never block,
        sequence numbers still advance."""
        with self._count_lock:
            self.stats.shed += len(items)
        self._resolve_err(items, ShedError(reason))

    def _resolve_err(self, items, exc):
        """Release every item as ``("err", exc)``.  Accepts both queue
        items (seq, t_submit, event, fut) and collected items
        (seq, t_submit, t_collect, event, fut)."""
        now = time.perf_counter()
        for it in items:
            seq, t_submit, fut = it[0], it[1], it[-1]
            t_collect = it[2] if len(it) == 5 else now
            timing = EventTiming(self.replica_id, t_submit, t_collect,
                                 now, now)
            self._releaser.complete(seq, ("err", exc), timing, fut)

    def _dispatch(self, items):
        try:
            self._run_batch(items)
        finally:
            self._inflight_sem.release()

    def _run_batch(self, items):
        n = len(items)
        pad = self.microbatch - n
        feeds = {}
        for key in items[0][3]:
            stacked = np.stack([it[3][key] for it in items])
            if pad:
                z = np.zeros((pad, *stacked.shape[1:]), stacked.dtype)
                stacked = np.concatenate([stacked, z])
            feeds[key] = stacked
        with self._count_lock:
            # batches counts *launched* batches — a failing inference
            # below still launched one.
            self.stats.batches += 1
            self.stats.padded_events += pad
        feeds = self._place(feeds)
        t_dispatch = time.perf_counter()
        try:
            # a lane's result is in flight: wait for its event BEFORE
            # stamping t_done, so the compute budget includes the actual
            # device time (and a device fault fails this batch)
            out = _landed(self._call(feeds))
        except Exception as exc:  # noqa: BLE001 — fault isolation: fail
            self._fail_batch(items, exc, t_dispatch)   # the batch, not
            return                                     # the replica
        if self._health is not None:
            self._health.record_success()
        leaves, tdef = tree_flatten(out)
        np_leaves = [host_array(l) for l in leaves]
        t_done = time.perf_counter()
        for i, (seq, t_submit, t_collect, _, fut) in enumerate(items):
            res = tree_unflatten(tdef, [l[i] for l in np_leaves])
            timing = EventTiming(self.replica_id, t_submit, t_collect,
                                 t_dispatch, t_done)
            self._releaser.complete(seq, ("ok", res), timing, fut)

    def _place(self, feeds):
        """A plain callable of a replica pinned to a device gets its feeds
        there (the reference's ``jax.device_put``); a lane copies them in
        itself."""
        if self.device is None or self.lane is not None:
            return feeds
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in feeds.items()}

    def _fail_batch(self, items, exc, t_dispatch):
        """Batch-failure path: feed the breaker, offer the events to
        the service's failover hook (bounded re-dispatch to a healthy
        sibling in the same group), then fail whatever could not be
        moved — each event is released exactly once either way."""
        if self._health is not None:
            self._health.record_failure()
        remaining = items
        if self._on_batch_failure is not None:
            try:
                remaining = self._on_batch_failure(self, items, exc)
            except Exception:  # noqa: BLE001 — a broken hook must not
                remaining = items  # strand the batch
        moved = len(items) - len(remaining)
        if moved:
            with self._count_lock:
                self.stats.failed_over += moved
        if not remaining:
            return
        t_done = time.perf_counter()
        for seq, t_submit, t_collect, _, fut in remaining:
            timing = EventTiming(self.replica_id, t_submit, t_collect,
                                 t_dispatch, t_done)
            self._releaser.complete(seq, ("err", exc), timing, fut)

    def _call(self, feeds):
        if self.hedge_after is None:
            return self._infer(feeds)
        # a close() can race an in-flight dispatch: the hedge pool is
        # already shut down and submit() raises RuntimeError.  Route
        # that to the batch-failure path (clean per-batch failure)
        # instead of leaking an unresolved future.
        try:
            primary = self._hedge_pool.submit(self._infer, feeds)
        except RuntimeError as exc:
            raise RuntimeError(
                "hedge pool shut down during dispatch") from exc
        try:
            return primary.result(timeout=self.hedge_after)
        except FuturesTimeout:
            pass  # straggler: hedge below. Real faults propagate to
            #       the batch-failure path instead of being re-run.
        with self._count_lock:
            self.stats.hedged += 1
        # re-dispatch to the backup lane and take whichever lane
        # returns first (duplicate-safe because inference is pure);
        # a lane that *fails* defers to the other one.
        try:
            backup = self._hedge_pool.submit(self._infer, feeds)
        except RuntimeError:
            backup = None   # closing: ride the primary out alone
        lanes = {primary, backup} if backup is not None else {primary}
        last_exc = None
        while lanes:
            done, lanes = futures_wait(lanes, return_when=FIRST_COMPLETED)
            for lane in done:
                if lane.exception() is None:
                    return lane.result()
                last_exc = lane.exception()
        raise last_exc

    # ----------------------------------------------------------- control ----
    def _fail_queued(self):
        """Fail anything still queued so no client hangs in
        fut.result(); idempotent — also called from a racing enqueue."""
        leftovers = []
        while True:
            try:
                leftovers.append(self._q.get_nowait())
            except queue.Empty:
                break
        if leftovers:
            self._fail_items(leftovers)

    def close(self):
        self._stop.set()
        self._batcher.join(timeout=5)
        self._dispatch_pool.shutdown(wait=True)
        if self._hedge_pool is not None:
            self._hedge_pool.shutdown(wait=False)
        self._fail_queued()


def _landed(out):
    """A lane's in-flight result once its copies have landed; any other
    result as it is."""
    return out.wait() if isinstance(out, InFlight) else out
