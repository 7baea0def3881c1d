"""Deterministic fault injection for the serving stack (chaos testing).

The port of ``repro/serving/faults.py``. What differs: the injector's
wrapper passes keyword arguments through (a lane takes its output ring
as ``out=``), and ``corrupt`` poisons tensors and numpy leaves alike: a
lane's in-flight result is waited for and every leaf brought to the host
first, so a poisoned result is a host result.

The paper's trigger is a hard real-time system: a wedged or failing
unit must degrade the stream gracefully, never stall it.  That
behavior is only engineerable if the failure modes themselves are
reproducible — so every chaos test, CI leg and degradation benchmark
here drives the *same* seeded ``FaultPlan`` and replays the same fault
sequence bit-identically.

A ``FaultPlan`` is a list of ``FaultSpec`` clauses plus a seed.  Each
replica derives its own stateful injector (``for_replica``) with an
independent, seed-derived RNG stream; the injector wraps the replica's
``infer_fn`` so both the deadline loop (``replica.py``) and the
streaming loop (``streaming.py``) inject at the same point — the
batch dispatch — without either loop knowing the fault kinds.

Fault kinds (per *batch*, the serving fault domain):

  fail     raise ``InjectedFault`` instead of running the batch —
           exercises the batch-failure path, breaker and failover;
  stall    sleep ``s`` seconds before running — a straggler, for
           hedging and tail-latency tests;
  wedge    hang until ``plan.release()`` — a dead device lane; the
           wait is poll-based so ``close()`` stays reachable once
           released;
  corrupt  run the batch, then poison the outputs (NaN floats,
           min-sentinel ints) — silent data corruption;
  kill     die in the *batcher/launcher thread* before dispatch (the
           loop fails the collected batch exactly once, then the
           thread exits) — exercises shutdown-under-load.

Spec grammar (``FaultPlan.parse``, also ``serve.py --inject-faults``)::

    SPEC    := clause (';' clause)*
    clause  := 'seed=' INT
             | KIND ['@' N (',' N)*] [':' kv (',' kv)*]
    kv      := 'p=' FLOAT        # per-batch probability
             | 's=' FLOAT        # stall seconds / wedge cap
             | 'replica=' INT ('+' INT)*   # target lanes (default all)

Examples: ``fail@3`` (fail batch 3 everywhere), ``fail:p=0.1``
(10% of batches), ``fail:p=1.0,replica=2`` (replica 2 is dead),
``stall:p=0.05,s=0.02;corrupt:p=0.01;seed=7``.

Determinism: each injector draws exactly one RNG value per rate-bearing
clause per batch, in clause order, under a lock — the per-replica
decision *stream* is a pure function of ``(seed, replica_id)``.  With a
serialized dispatch (``inflight=1``) the batch-index -> fault mapping
is exact; with concurrent dispatch the multiset of injected faults over
N batches is still exactly reproducible.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from random import Random

import numpy as np

from repro_torch.core.pipeline import InFlight
from repro_torch.serving.tree import host_array, tree_flatten, tree_unflatten

FAULT_KINDS = ("fail", "stall", "wedge", "corrupt", "kill")

# wedge waits poll the release gate at this granularity so a released
# plan unblocks promptly without a busy spin
_WEDGE_POLL_S = 0.02


class InjectedFault(RuntimeError):
    """A deliberately injected serving failure (``fail``/``kill``)."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault clause: what to inject, when, and where.

    ``at`` names explicit 0-based batch indices; ``rate`` adds a
    per-batch probability; ``replicas`` restricts the clause to the
    named lanes (``None`` = every replica)."""
    kind: str
    rate: float = 0.0
    at: tuple = ()
    replicas: tuple | None = None
    duration_s: float | None = None

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"fault rate must be in [0, 1], "
                             f"got {self.rate}")
        if self.kind == "kill" and self.rate:
            raise ValueError("kill faults are index-triggered only "
                             "(use kill@N, not p=)")

    def describe(self) -> str:
        parts = [self.kind]
        if self.at:
            parts.append("@" + ",".join(str(n) for n in self.at))
        kv = []
        if self.rate:
            kv.append(f"p={self.rate:g}")
        if self.duration_s is not None:
            kv.append(f"s={self.duration_s:g}")
        if self.replicas is not None:
            kv.append("replica=" + "+".join(str(r) for r in self.replicas))
        return "".join(parts) + (":" + ",".join(kv) if kv else "")


def _parse_clause(text: str) -> FaultSpec:
    head, _, tail = text.partition(":")
    head = head.strip()
    at: tuple = ()
    if "@" in head:
        kind, _, idxs = head.partition("@")
        at = tuple(int(n) for n in idxs.split(","))
    else:
        kind = head
    rate, dur, replicas = 0.0, None, None
    if tail.strip():
        for kv in tail.split(","):
            key, _, val = kv.partition("=")
            key, val = key.strip(), val.strip()
            if key == "p":
                rate = float(val)
            elif key == "s":
                dur = float(val)
            elif key in ("replica", "replicas"):
                replicas = tuple(int(r) for r in val.split("+"))
            else:
                raise ValueError(f"unknown fault-spec key {key!r} in "
                                 f"{text!r} (expected p=, s=, replica=)")
    return FaultSpec(kind.strip(), rate=rate, at=at, replicas=replicas,
                     duration_s=dur)


class FaultPlan:
    """A seeded set of fault clauses shared by every replica of a
    service; ``for_replica`` derives the per-lane injector."""

    def __init__(self, specs=(), *, seed: int = 0):
        self.specs = tuple(specs)
        self.seed = int(seed)
        self._release_gate = threading.Event()
        self._lock = threading.Lock()
        self._injectors: dict[int, ReplicaFaultInjector] = {}

    @classmethod
    def parse(cls, text: str, *, seed: int = 0) -> "FaultPlan":
        """Build a plan from the spec grammar (module docstring); a
        ``seed=N`` clause overrides the ``seed`` argument."""
        specs = []
        for clause in text.split(";"):
            clause = clause.strip()
            if not clause:
                continue
            if clause.startswith("seed="):
                seed = int(clause[len("seed="):])
                continue
            specs.append(_parse_clause(clause))
        return cls(specs, seed=seed)

    def describe(self) -> str:
        body = ";".join(s.describe() for s in self.specs)
        return f"{body};seed={self.seed}" if body else f"seed={self.seed}"

    def for_replica(self, replica_id: int) -> "ReplicaFaultInjector":
        with self._lock:
            inj = self._injectors.get(replica_id)
            if inj is None:
                inj = ReplicaFaultInjector(self, replica_id)
                self._injectors[replica_id] = inj
            return inj

    # ------------------------------------------------------------- wedges ----
    def release(self):
        """Release every wedged call, current and future.  Call before
        ``close()``/``drain()`` when the plan contains wedge clauses —
        a wedged dispatch holds its in-flight slot until released."""
        self._release_gate.set()

    @property
    def released(self) -> bool:
        return self._release_gate.is_set()

    @property
    def wedged(self) -> int:
        """Calls currently hanging on the wedge gate, fleet-wide."""
        with self._lock:
            return sum(i.wedged_now for i in self._injectors.values())

    def counts(self) -> dict:
        """Fleet-wide injected-fault counts by kind."""
        out = {k: 0 for k in FAULT_KINDS}
        with self._lock:
            injectors = list(self._injectors.values())
        for inj in injectors:
            for k, n in inj.counts.items():
                out[k] += n
        return out


class ReplicaFaultInjector:
    """Per-replica fault state: a seed-derived RNG stream, batch
    counters, and the decision log chaos tests replay against."""

    def __init__(self, plan: FaultPlan, replica_id: int):
        self.plan = plan
        self.replica_id = replica_id
        # integer-arithmetic seed derivation: hash() of tuples is
        # process-randomized (PYTHONHASHSEED) and would break replay
        self._rng = Random(plan.seed * 1_000_003 + replica_id + 1)
        self._lock = threading.Lock()
        self.batches = 0          # wrapped infer calls seen
        self.batcher_cycles = 0   # batcher/launcher kill checkpoints
        self.wedged_now = 0
        self.counts = {k: 0 for k in FAULT_KINDS}
        self.log: list[tuple[int, str]] = []   # (batch_index, kind)

    def _targets_me(self, spec: FaultSpec) -> bool:
        return spec.replicas is None or self.replica_id in spec.replicas

    def _decide(self) -> list[FaultSpec]:
        """One deterministic decision round: exactly one RNG draw per
        rate-bearing clause that targets this replica, in clause
        order."""
        with self._lock:
            n = self.batches
            self.batches += 1
            hits = []
            for spec in self.plan.specs:
                if spec.kind == "kill" or not self._targets_me(spec):
                    continue
                hit = n in spec.at
                if spec.rate > 0.0:
                    hit = (self._rng.random() < spec.rate) or hit
                if hit:
                    hits.append(spec)
                    self.counts[spec.kind] += 1
                    self.log.append((n, spec.kind))
            return hits

    def batcher_kill_due(self) -> bool:
        """Called by the batcher/launcher thread once per collected
        batch; True when a ``kill@N`` clause names this checkpoint."""
        with self._lock:
            n = self.batcher_cycles
            self.batcher_cycles += 1
            for spec in self.plan.specs:
                if (spec.kind == "kill" and self._targets_me(spec)
                        and n in spec.at):
                    self.counts["kill"] += 1
                    self.log.append((n, "kill"))
                    return True
        return False

    def _wait_released(self, spec: FaultSpec):
        with self._lock:
            self.wedged_now += 1
        try:
            t0 = time.perf_counter()
            while not self.plan._release_gate.wait(timeout=_WEDGE_POLL_S):
                if (spec.duration_s is not None
                        and time.perf_counter() - t0 >= spec.duration_s):
                    return   # capped wedge: proceed after s seconds
        finally:
            with self._lock:
                self.wedged_now -= 1

    def wrap(self, infer_fn):
        """Wrap ``infer_fn`` with this injector: stalls first, then
        wedges, then failures; corruption applies to a completed
        output."""

        def faulted(feeds, **kw):
            hits = self._decide()
            for spec in hits:
                if spec.kind == "stall":
                    time.sleep(spec.duration_s
                               if spec.duration_s is not None else 0.05)
            for spec in hits:
                if spec.kind == "wedge":
                    self._wait_released(spec)
            for spec in hits:
                if spec.kind == "fail":
                    raise InjectedFault(
                        f"injected batch failure "
                        f"(replica {self.replica_id}, "
                        f"batch {self.batches - 1})")
            out = infer_fn(feeds, **kw)
            if any(s.kind == "corrupt" for s in hits):
                out = _poison(out)
            return out

        return faulted


def _poison(out):
    """Corrupt every leaf of an output tree: NaN floats, dtype-min
    ints, all-True bools — loud enough that any downstream consumer
    (monitor, client) can detect the corruption. A lane's in-flight
    result is waited for and each leaf copied to the host first, so the
    poisoned tree holds numpy arrays."""
    if isinstance(out, InFlight):
        out = out.wait()
    leaves, tdef = tree_flatten(out)
    bad = []
    for leaf in leaves:
        a = np.array(host_array(leaf))
        if np.issubdtype(a.dtype, np.floating):
            a[...] = np.nan
        elif np.issubdtype(a.dtype, np.bool_):
            a[...] = True
        elif np.issubdtype(a.dtype, np.integer):
            a[...] = np.iinfo(a.dtype).min
        bad.append(a)
    return tree_unflatten(tdef, bad)
