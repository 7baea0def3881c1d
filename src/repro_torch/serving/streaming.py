"""Streaming dataflow replica loop (the DGNNFlow direction).

The port of ``repro/serving/streaming.py``. On the card a replica serves
through its lane (``core/pipeline.py:Lane``), and the rings become the
lane's host ends: the input ring is pinned host tensors, which the lane
copies in without blocking on its stream; the output ring is pinned host
buffers, which the lane fills by non-blocking device-to-host copies
followed by a recorded ``torch.cuda.Event``; and the harvest thread polls
that event's ``query()`` where the reference polls ``is_ready()``. A slot
(input and output) is refilled only after the launch that used it has
been harvested, and the harvested event follows the slot's copy in on
the same stream, so the reference's ``inflight + 1`` argument below
still holds. Nothing on this path synchronizes the card: a pageable
copy would block the host until the stream drains. With a plain
callable (the tests), or a lane on the CPU, the rings are numpy as in
the reference.

The deadline loop in ``replica.py`` tears down and re-forms a
micro-batch every tick: collect until a batch boundary or the window
deadline, stack fresh arrays, dispatch, wait, repeat.  That is the
request/response shape DGNNFlow (arXiv 2603.20364) argues against for
trigger systems — the paper's 7.15 µs / 2.94 M events/s figure is a
*continuously streaming* pipeline's number.  ``StreamingReplicaEngine``
replaces the tick with a persistent, device-resident pipeline of four
overlapped stages:

  intake   — ``enqueue`` appends to the bounded queue (the router
             contract is unchanged; backpressure still applies);
  assemble — the launcher thread copies queued events straight into a
             preallocated staging slot of the **input ring**
             (``inflight + 1`` slots of shape ``(microbatch, …)``,
             allocated once from the first event) and launches as soon
             as at least one event is staged and the pipeline has a
             free in-flight slot.  There is no deadline tick and no
             batch-boundary wait: an event that arrives while a launch
             is in flight joins the *next* launch, and the batch width
             self-regulates with the offered load (near 1 when idle,
             up to ``microbatch`` at saturation);
  compute  — launches are handed to the dispatch pool and run
             asynchronously; the launcher never blocks on a result and
             nothing synchronizes the card on the hot path;
  harvest  — a dedicated thread polls completed launch futures in FIFO
             order, waits for their results to land in the host
             **output ring** (the D2H stage), and hands each event to
             the shared ``InOrderReleaser``.

Stage overlap: while launch k computes, launch k+1 assembles in the
next input-ring slot and launch k-1 drains through the output ring —
the double-buffered Load/compute/Store of the paper's dataflow engine,
reproduced at the serving layer.  Ring safety needs no per-slot locks:
the in-flight semaphore bounds concurrent launches to ``inflight``, so
by the time the launcher cycles back to a slot (``inflight + 1``
launches later) its previous occupant has been harvested.

Global in-order release, per-bucket routing (each bucket group's
replicas own their own rings), and the lane's warm-up and tuning-cache
warm-up all behave exactly as in the deadline loop.
Hedged dispatch is deadline-only: the streaming loop keeps the
pipeline full instead of re-dispatching stragglers.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import TimeoutError as FuturesTimeout

import numpy as np
import torch

from repro_torch.core.pipeline import InFlight
from repro_torch.serving.replica import EventTiming, ReplicaEngine
from repro_torch.serving.tree import host_array, tree_flatten, tree_unflatten

# replica loop flavors a ShardedTriggerService can run
LOOPS = ("deadline", "streaming")

# poll granularity for the stop-responsive waits (semaphore, compute
# futures, device buffers); the hot path itself never sleeps on this.
_POLL_S = 0.05


class StreamingReplicaEngine(ReplicaEngine):
    """One persistent streaming lane: bounded queue -> rolling batch
    assembly into the input ring -> async compute -> harvested D2H
    through the output ring -> shared in-order releaser."""

    loop = "streaming"

    def __init__(self, infer_fn, releaser, *, microbatch: int,
                 window_s: float = 1e-3, queue_depth: int = 1024,
                 hedge_after_s: float | None = None, device=None,
                 replica_id: int = 0, inflight: int = 2,
                 warmup_fn=None, faults=None, health=None,
                 on_batch_failure=None, shed: bool = False):
        if hedge_after_s is not None:
            raise ValueError(
                "hedge_after_s is a deadline-loop feature; the "
                "streaming loop keeps the pipeline full instead of "
                "re-dispatching stragglers (use loop='deadline')")
        # window_s is accepted for constructor compatibility but the
        # streaming loop has no deadline tick to apply it to.
        super().__init__(infer_fn, releaser, microbatch=microbatch,
                         window_s=window_s, queue_depth=queue_depth,
                         hedge_after_s=None, device=device,
                         replica_id=replica_id, inflight=inflight,
                         warmup_fn=warmup_fn, faults=faults,
                         health=health,
                         on_batch_failure=on_batch_failure, shed=shed)

    # ------------------------------------------------------------- setup ----
    def _setup_loop(self):
        # input ring: inflight staging slots may sit under in-flight
        # launches while one more is being assembled.
        self._n_slots = self.inflight + 1
        self._slots: list[dict | None] = [None] * self._n_slots
        self._slot_idx = 0
        # a lane on the card: pinned host rings (the lane's own stream
        # copies them in and out without blocking)
        self._pinned = self.lane is not None and self.lane.stream is not None
        # output ring: one host landing tree per input slot, which the
        # lane's device-to-host copies of that slot's launch fill; the
        # slot's next launch reuses it once that launch is harvested
        self._out_ring: list = [None] * self._n_slots
        # FIFO of in-flight launch records, drained by the harvester.
        self._records: deque[dict] = deque()
        self._rec_cond = threading.Condition()
        self._harvester = threading.Thread(
            target=self._harvest_loop, daemon=True,
            name=f"replica{self.replica_id}-harvest")
        self._harvester.start()

    # ---------------------------------------------------------- launcher ----
    def _run(self):
        """Launcher: pop the first waiting event, gate on a free
        in-flight slot, then sweep everything else that queued in the
        meantime into the same launch (rolling batching)."""
        while not self._stop.is_set():
            try:
                seq, t_submit, event, fut = self._q.get(timeout=_POLL_S)
            except queue.Empty:
                continue
            dl = getattr(fut, "deadline", None)
            if dl is not None and time.perf_counter() > dl:
                self._shed_items([(seq, t_submit, event, fut)],
                                 "deadline expired in queue")
                continue
            if self._faults is not None \
                    and self._faults.batcher_kill_due():
                # chaos: the launcher dies mid-batch; the popped event
                # is failed exactly once, close() sweeps the rest.
                from repro_torch.serving.faults import InjectedFault
                self._resolve_err([(seq, t_submit, event, fut)],
                                  InjectedFault(
                                      f"injected launcher kill "
                                      f"(replica {self.replica_id})"))
                return
            staged = [(seq, t_submit, time.perf_counter(), event, fut)]
            acquired = False
            while not (acquired := self._inflight_sem.acquire(
                    timeout=_POLL_S)):
                if self._stop.is_set():
                    break
            if not acquired:
                self._fail_items(staged)   # closing: don't strand futures
                return
            now = time.perf_counter()
            while len(staged) < self.microbatch:
                try:
                    s, t, ev, f = self._q.get_nowait()
                except queue.Empty:
                    break
                dl = getattr(f, "deadline", None)
                if dl is not None and now > dl:
                    self._shed_items([(s, t, ev, f)],
                                     "deadline expired in queue")
                    continue
                staged.append((s, t, now, ev, f))
            try:
                self._launch(staged)
            except Exception:  # noqa: BLE001 — a malformed event (e.g.
                # missing feed key) fails its own launch, never the lane
                self._inflight_sem.release()
                self._fail_items(staged)

    def _pack(self, items, slot_i: int) -> dict:
        """Copy the staged events into input-ring slot ``slot_i`` and
        zero the padded tail.  The slot is allocated once, from the
        first event's feed shapes; a heterogeneous event (shape or
        dtype drift within one replica — never the bucketed path,
        which cuts feeds to the bucket shape) falls back to a fresh
        stack for this launch only."""
        mb = self.microbatch
        n = len(items)
        ev0 = items[0][3]
        try:
            slot = self._slots[slot_i]
            if slot is None:
                slot = self._slots[slot_i] = self._ring_slot(mb, ev0)
            feeds, views = slot
            for k, buf in views.items():
                for i, it in enumerate(items):
                    v = np.asarray(it[3][k])
                    if v.shape != buf.shape[1:] or v.dtype != buf.dtype:
                        raise ValueError("feed drift")
                    buf[i, ...] = v
                if n < mb:
                    buf[n:] = 0
            return feeds
        except (KeyError, ValueError, TypeError):
            feeds = {}
            for k in ev0:
                stacked = np.stack([np.asarray(it[3][k]) for it in items])
                if n < mb:
                    z = np.zeros((mb - n, *stacked.shape[1:]),
                                 stacked.dtype)
                    stacked = np.concatenate([stacked, z])
                feeds[k] = stacked
            return feeds

    def _ring_slot(self, mb, ev0):
        """(feeds, numpy views to pack into) of one input-ring slot:
        pinned host tensors for a lane on the card, else numpy arrays."""
        arrays = {k: np.zeros((mb, *np.asarray(v).shape),
                              np.asarray(v).dtype) for k, v in ev0.items()}
        if not self._pinned:
            return arrays, arrays
        feeds = {k: torch.from_numpy(a).pin_memory()
                 for k, a in arrays.items()}
        return feeds, {k: t.numpy() for k, t in feeds.items()}

    def _launch(self, items):
        slot_i = self._slot_idx
        self._slot_idx = (slot_i + 1) % self._n_slots
        feeds = self._pack(items, slot_i)
        with self._count_lock:
            self.stats.batches += 1
            self.stats.padded_events += self.microbatch - len(items)
        feeds = self._place(feeds)
        rec = {"items": items, "t_dispatch": time.perf_counter(),
               "slot": slot_i}
        # a lane fills the slot's output ring tree (absent on its first
        # launch: the lane allocates it, and the harvest keeps it)
        kw = {"out": self._out_ring[slot_i]} if self.lane is not None \
            else {}

        def _call(feeds=feeds, rec=rec):
            rec["t_dispatch"] = time.perf_counter()
            return self._infer(feeds, **kw)

        # async dispatch: the launcher hands the launch off and goes
        # straight back to assembling the next one.
        rec["fut"] = self._dispatch_pool.submit(_call)
        with self._rec_cond:
            self._records.append(rec)
            self._rec_cond.notify()

    # --------------------------------------------------------- harvester ----
    def _harvest_loop(self):
        """Drain in-flight launches in FIFO order.  Keeps running past
        ``close()`` until every launched record has been released —
        exactly-once release is the launcher/harvester contract."""
        while True:
            with self._rec_cond:
                while not self._records:
                    if self._stop.is_set() and not self._batcher.is_alive():
                        return
                    self._rec_cond.wait(timeout=_POLL_S)
                rec = self._records.popleft()
            try:
                self._harvest(rec)
            finally:
                self._inflight_sem.release()   # frees the input slot

    def _poll_result(self, fut):
        """Poll the launch future (never an unbounded block, so a
        wedged backend can't make shutdown unresponsive)."""
        while True:
            try:
                return fut.result(timeout=_POLL_S)
            except FuturesTimeout:
                continue

    def _to_host_ring(self, out, slot_i) -> tuple:
        """D2H stage: poll a lane's event until its copies into the
        slot's output ring have landed (keeping the ring tree for the
        slot's next launch); then every leaf as a host array."""
        if isinstance(out, InFlight):
            while not out.ready():
                time.sleep(5e-5)
            self._out_ring[slot_i] = out = out.out
        return tree_flatten(out)

    def _harvest(self, rec):
        items = rec["items"]
        try:
            leaves, tdef = self._to_host_ring(
                self._poll_result(rec["fut"]), rec["slot"])
        except Exception as exc:  # noqa: BLE001 — fault isolation: fail
            # the launch, not the lane; breaker + failover as in the
            # deadline loop's batch-failure path
            self._fail_batch(items, exc, rec["t_dispatch"])
            return
        if self._health is not None:
            self._health.record_success()
        host = [host_array(l) for l in leaves]
        t_done = time.perf_counter()
        for i, (seq, t_submit, t_collect, _, fut) in enumerate(items):
            # per-event copies: futures outlive the ring slot's next
            # reuse.
            res = tree_unflatten(tdef, [np.array(l[i]) for l in host])
            timing = EventTiming(self.replica_id, t_submit, t_collect,
                                 rec["t_dispatch"], t_done)
            self._releaser.complete(seq, ("ok", res), timing, fut)

    # ----------------------------------------------------------- control ----
    def close(self):
        self._stop.set()
        self._batcher.join(timeout=5)
        # in-flight launches complete and release normally; everything
        # never launched is failed exactly once below.
        self._dispatch_pool.shutdown(wait=True)
        with self._rec_cond:
            self._rec_cond.notify_all()
        self._harvester.join(timeout=10)
        self._fail_queued()
