"""Event sharding across replica engines.

A copy of ``repro/serving/router.py`` (pure Python and numpy). The port
has no bucketed deployment yet (``deploy_bucketed``): a bucketed service
takes a ``{n_hits: infer_fn}`` dict.

Two policies, both O(1) per event:

  round_robin  — event ``seq`` goes to replica ``seq % N``; perfectly
                 even, deterministic (the testable default);
  least_loaded — event goes to the replica with the fewest accepted-
                 but-unreleased events (ties break by replica index),
                 which absorbs skew when one replica hedges or runs on
                 a slower device.

Occupancy bucketing: with a bucketed deployment (one batch-packed
executable per n_hits tier — see ``core.pipeline.deploy_bucketed``)
the service classifies each event by its non-zero hit count
(``event_occupancy``) and dispatches to the replica group serving the
smallest bucket that fits (``pick_bucket``); events overflowing the
largest bucket fall back to it (hits are energy-sorted upstream, so
truncation drops the softest hits first). Classification is O(hits)
numpy on the submit path — no jax, no copies.

Health-aware routing: when the service runs with a circuit breaker
(``serving.health``) the router is handed the per-replica
``ReplicaHealth`` objects and ``pick`` skips lanes whose breaker is
open, tie-breaks by health among the healthy, and falls back to the
least-bad lane when every breaker is open — the trigger keeps
deciding, degraded, rather than stalling the stream.  Without health
objects both policies are bit-identical to the original behavior.
"""
from __future__ import annotations

from bisect import bisect_left

import numpy as np

POLICIES = ("round_robin", "least_loaded")


def pick_bucket_sorted(occupancy: int, sorted_buckets) -> int:
    """``pick_bucket`` over an already-sorted sequence: O(log n)
    bisect, no per-event allocation — the submit-path variant."""
    i = bisect_left(sorted_buckets, occupancy)
    return sorted_buckets[i] if i < len(sorted_buckets) \
        else sorted_buckets[-1]


def pick_bucket(occupancy: int, buckets) -> int:
    """Smallest bucket >= ``occupancy``; overflow → largest bucket.

    ``buckets`` must be a non-empty iterable of positive ints; a 0-hit
    event lands in the smallest bucket (a real launch shape — padding
    handles it like the paper's zero-padded missing inputs).  Callers
    on a per-event path should sort once and use
    ``pick_bucket_sorted``."""
    bs = sorted(buckets)
    if not bs:
        raise ValueError("pick_bucket: no buckets")
    return pick_bucket_sorted(occupancy, bs)


def event_occupancy(event: dict, mask_feed: str = "mask") -> int:
    """Non-zero hit count of one (un-batched) event dict."""
    return int(np.count_nonzero(np.asarray(event[mask_feed]) > 0))


class Router:
    def __init__(self, replicas, policy: str = "round_robin",
                 healths=None):
        if policy not in POLICIES:
            raise ValueError(
                f"unknown shard policy {policy!r}; expected one of "
                f"{POLICIES}")
        self.replicas = list(replicas)
        self.policy = policy
        # healths: {replica_id: ReplicaHealth} covering (at least) this
        # router's replicas; aligned once here so pick() never indexes
        # a dict on the per-event path.
        self._healths = None if healths is None else \
            [healths[r.replica_id] for r in self.replicas]

    def pick(self, seq: int):
        if self._healths is None:
            if self.policy == "round_robin":
                return self.replicas[seq % len(self.replicas)]
            return min(self.replicas,
                       key=lambda r: (r.load(), r.replica_id))
        pairs = [(r, h) for r, h in zip(self.replicas, self._healths)
                 if h.available()]
        if not pairs:
            # every breaker open: the least-bad lane keeps serving
            # (degraded) — a trigger must not stall the event stream.
            r, h = min(zip(self.replicas, self._healths),
                       key=lambda rh: (rh[1].score(),
                                       rh[0].replica_id))
        elif self.policy == "round_robin":
            r, h = pairs[seq % len(pairs)]
        else:
            r, h = min(pairs, key=lambda rh: (rh[0].load(),
                                              rh[1].score(),
                                              rh[0].replica_id))
        h.note_dispatch()   # consumes a half-open probe token
        return r
