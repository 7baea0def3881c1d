"""Per-replica health tracking and circuit breaking.

A copy of ``repro/serving/health.py`` (pure Python).

A replica whose ``infer_fn`` fails permanently must stop receiving its
full share of traffic — the paper's trigger degrades gracefully or not
at all.  ``ReplicaHealth`` tracks three signals per lane, fed by the
batch loops on every batch outcome:

  * EWMA failure rate (``ewma_alpha`` smoothing over batch outcomes);
  * consecutive-failure count;
  * last-success clock (monotonic).

They drive a standard three-state circuit breaker:

  closed     healthy: full traffic.  Trips to *open* after
             ``fail_threshold`` consecutive failures, or when the EWMA
             failure rate crosses ``ewma_threshold`` (with at least
             ``min_samples`` outcomes observed);
  open       no traffic for a cool-down (``open_s``); the router skips
             the lane entirely.  When the cool-down expires the
             breaker moves to *half-open*;
  half-open  probe: the router may send ``half_open_probes`` batches
             through.  A success closes the breaker; a failure
             re-opens it with an exponentially longer cool-down
             (``backoff``×, capped at ``max_open_s``) — the bounded
             exponential backoff of the failover path.

``Router.pick`` (``router.py``) consumes this via ``available()`` /
``score()``: skip open lanes, tie-break by health among the healthy,
fall back to the least-bad lane when every breaker is open (the
trigger must keep deciding, even degraded).  All state transitions are
lock-protected and clock-injected, so tests drive them with a fake
clock.
"""
from __future__ import annotations

import dataclasses
import threading
import time

BREAKER_STATES = ("closed", "open", "half_open")


@dataclasses.dataclass(frozen=True)
class BreakerConfig:
    """Circuit-breaker tuning; the defaults suit sub-ms batch loops
    (trip fast, probe fast, back off to ``max_open_s``)."""
    fail_threshold: int = 3       # consecutive failures -> open
    ewma_alpha: float = 0.25      # failure-rate smoothing
    ewma_threshold: float = 0.6   # smoothed failure rate -> open
    min_samples: int = 4          # outcomes before the EWMA can trip
    open_s: float = 0.25          # first cool-down before half-open
    backoff: float = 2.0          # cool-down growth per re-open
    max_open_s: float = 10.0      # cool-down cap
    half_open_probes: int = 1     # probe batches per half-open window


class ReplicaHealth:
    """One replica's health signals + breaker state machine.

    ``record_success``/``record_failure`` are called by the batch
    loops (one call per batch outcome); ``available``/``score``/
    ``note_dispatch`` are called by the router under the service's
    sequence lock.  ``clock`` is injectable for deterministic tests.
    """

    def __init__(self, replica_id: int = 0,
                 config: BreakerConfig | None = None, *,
                 clock=time.perf_counter):
        self.replica_id = replica_id
        self.config = config or BreakerConfig()
        self._clock = clock
        self._lock = threading.Lock()
        self._state = "closed"
        self._ewma = 0.0
        self._outcomes = 0
        self._consecutive = 0
        self._last_success: float | None = None
        self._opened_at = 0.0
        self._cooldown_s = self.config.open_s
        self._probes_left = 0
        self.trips = 0            # closed/half-open -> open transitions

    # ---------------------------------------------------------- outcomes ----
    def record_success(self):
        with self._lock:
            self._outcomes += 1
            self._consecutive = 0
            self._ewma *= 1.0 - self.config.ewma_alpha
            self._last_success = self._clock()
            if self._resolve_state() == "half_open":
                # probe succeeded: close and reset the backoff
                self._state = "closed"
                self._cooldown_s = self.config.open_s
                self._probes_left = 0

    def record_failure(self):
        cfg = self.config
        with self._lock:
            self._outcomes += 1
            self._consecutive += 1
            self._ewma += cfg.ewma_alpha * (1.0 - self._ewma)
            state = self._resolve_state()
            if state == "half_open":
                # probe failed: re-open with exponential backoff
                self._cooldown_s = min(self._cooldown_s * cfg.backoff,
                                       cfg.max_open_s)
                self._trip()
            elif state == "closed" and (
                    self._consecutive >= cfg.fail_threshold
                    or (self._outcomes >= cfg.min_samples
                        and self._ewma >= cfg.ewma_threshold)):
                self._cooldown_s = cfg.open_s
                self._trip()

    def _trip(self):
        self._state = "open"
        self._opened_at = self._clock()
        self._probes_left = 0
        self.trips += 1

    def _resolve_state(self) -> str:
        """Lazily advance open -> half-open when the cool-down has
        expired (no timer thread; callers hold the lock)."""
        if (self._state == "open"
                and self._clock() - self._opened_at >= self._cooldown_s):
            self._state = "half_open"
            self._probes_left = self.config.half_open_probes
        return self._state

    # ------------------------------------------------------------ router ----
    def state(self) -> str:
        with self._lock:
            return self._resolve_state()

    def available(self) -> bool:
        """May the router send this lane traffic right now?"""
        with self._lock:
            st = self._resolve_state()
            if st == "closed":
                return True
            if st == "half_open":
                return self._probes_left > 0
            return False

    def note_dispatch(self):
        """Router picked this lane; consumes a half-open probe token."""
        with self._lock:
            if self._resolve_state() == "half_open" \
                    and self._probes_left > 0:
                self._probes_left -= 1

    def score(self) -> tuple:
        """Health ordering key (lower = healthier): breaker-state rank,
        then smoothed failure rate, then consecutive failures."""
        with self._lock:
            rank = BREAKER_STATES.index(self._resolve_state())
            return (rank, self._ewma, self._consecutive)

    # --------------------------------------------------------- reporting ----
    def snapshot(self) -> dict:
        with self._lock:
            st = self._resolve_state()
            since = None if self._last_success is None \
                else self._clock() - self._last_success
            return {
                "replica_id": self.replica_id,
                "state": st,
                "ewma_failure_rate": self._ewma,
                "consecutive_failures": self._consecutive,
                "outcomes": self._outcomes,
                "since_last_success_s": since,
                "trips": self.trips,
                "cooldown_s": self._cooldown_s,
            }
