"""The port's serving layer (``repro_torch/serving/``) against the
reference's (``repro/serving/``), run live on the same inputs: the
router's picks, the circuit breaker's transitions under a fake clock, the
fault plans' grammar and each injector's per-batch decisions, and the
release semantics of both replica loops (in order and exactly once under
out-of-order completion, hedging, shedding, deadlines, failover and a
killed batcher; the streaming loop's rolling admission). Each scenario
runs through both packages and their outcomes are compared; every wait
is bounded and every service is closed.
"""
import threading
import time

import numpy as np
import pytest

import repro.serving as ref_serving
import repro_torch.serving as port_serving
from repro_torch.serving.tree import tree_flatten, tree_unflatten

PKGS = {"reference": ref_serving, "port": port_serving}
TIMEOUT = 60


def _both(scenario, *args, **kw):
    """The scenario's outcome in each package: (reference, port)."""
    return tuple(scenario(PKGS[name], *args, **kw) for name in PKGS)


def _echo(feeds):
    return {"y": feeds["x"]}


def _ev(i):
    return {"x": np.float32(i)}


def _svc(pkg, infer, **kw):
    kw.setdefault("microbatch", 1)
    kw.setdefault("window_s", 1e-3)
    kw.setdefault("devices", None)
    return pkg.ShardedTriggerService(infer, **kw)


def _outcomes(futs):
    """Each future's outcome, bounded: ("ok", y) or (exception class
    name, None)."""
    out = []
    for f in futs:
        exc = f.exception(timeout=TIMEOUT)
        out.append(("ok", float(np.asarray(f.result()["y"])))
                   if exc is None else (type(exc).__name__, None))
    return out


def _ledger(futs):
    """Resolution order and count per future (callbacks registered after
    every submission; the order is read only for a gated service)."""
    counts, order = [0] * len(futs), []
    lock = threading.Lock()

    def make(i):
        def cb(_f):
            with lock:
                counts[i] += 1
                order.append(i)
        return cb

    for i, f in enumerate(futs):
        f.add_done_callback(make(i))
    return counts, order


# ------------------------------------------------------------- router ----
class _FakeReplica:
    def __init__(self, replica_id, load=0):
        self.replica_id = replica_id
        self._load = load

    def load(self):
        return self._load


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _router_picks(pkg, policy, with_health):
    loads = [3, 0, 2, 0]
    reps = [_FakeReplica(i, loads[i]) for i in range(4)]
    healths = None
    clk = _Clock()
    if with_health:
        healths = {i: pkg.ReplicaHealth(i, pkg.BreakerConfig(
            fail_threshold=1, open_s=0.5), clock=clk) for i in range(4)}
        healths[1].record_failure()            # lane 1 open
        healths[2].record_failure()
        healths[2].record_success()            # closed, worse score
    router = pkg.Router(reps, policy, healths=healths)
    picks = []
    for seq in range(12):
        if seq == 6:
            clk.t = 0.6                        # lane 1 half-open: 1 probe
        r = router.pick(seq)
        r._load += 1                           # it took the event
        picks.append(r.replica_id)
    if with_health:
        return picks, [healths[i].snapshot()["state"] for i in range(4)]
    return picks, None


@pytest.mark.parametrize("with_health", [False, True])
@pytest.mark.parametrize("policy", ["round_robin", "least_loaded"])
def test_router_picks_match_reference(policy, with_health):
    ref, port = _both(_router_picks, policy, with_health)
    assert port == ref
    assert len(set(port[0])) > 1


def test_router_least_bad_lane_when_every_breaker_is_open():
    def picks(pkg):
        clk = _Clock()
        reps = [_FakeReplica(i) for i in range(3)]
        hs = {}
        for i, n in enumerate((3, 1, 2)):      # lane 1 least bad
            hs[i] = pkg.ReplicaHealth(i, pkg.BreakerConfig(
                fail_threshold=1), clock=clk)
            for _ in range(n):
                hs[i].record_failure()
        r = pkg.Router(reps, "round_robin", healths=hs)
        return [r.pick(s).replica_id for s in range(4)]
    ref, port = _both(picks)
    assert port == ref == [1, 1, 1, 1]


def test_unknown_policy_and_bucket_helpers_match_reference():
    for pkg in PKGS.values():
        with pytest.raises(ValueError, match="unknown shard policy"):
            pkg.Router([], "random")
    for occ in (0, 1, 8, 9, 32, 33, 128, 4096):
        assert port_serving.pick_bucket(occ, (32, 8, 128)) == \
            ref_serving.pick_bucket(occ, (32, 8, 128))
        assert port_serving.pick_bucket_sorted(occ, (8, 32, 128)) == \
            ref_serving.pick_bucket_sorted(occ, (8, 32, 128))
    ev = {"mask": np.array([1, 0, 1, 1, 0], np.float32)}
    assert port_serving.event_occupancy(ev) == \
        ref_serving.event_occupancy(ev) == 3
    assert port_serving.POLICIES == ref_serving.POLICIES


# ------------------------------------------------------------- breaker ----
# outcome sequences: F failure, S success, D a router dispatch, tN the
# fake clock set to N seconds
SEQUENCES = {
    "trip-probe-close": "F F F t0.3 D S",
    "reopen-backoff": "F t0.3 F t0.9 F t2.0 S",
    "ewma-trip": "F S F S F S F",
    "probe-tokens": "F F F t0.3 D D F t0.4 t0.8 D S S",
}
CONFIGS = {
    "trip-probe-close": dict(fail_threshold=3, open_s=0.25),
    "reopen-backoff": dict(fail_threshold=1, open_s=0.25, backoff=2.0,
                           max_open_s=0.8),
    "ewma-trip": dict(fail_threshold=100, ewma_alpha=0.5,
                      ewma_threshold=0.5, min_samples=4),
    "probe-tokens": dict(fail_threshold=3, open_s=0.25),
}


def _breaker_trace(pkg, case):
    clk = _Clock()
    h = pkg.ReplicaHealth(7, pkg.BreakerConfig(**CONFIGS[case]), clock=clk)
    trace = []
    for step in SEQUENCES[case].split():
        if step == "F":
            h.record_failure()
        elif step == "S":
            h.record_success()
        elif step == "D":
            h.note_dispatch()
        else:
            clk.t = float(step[1:])
        trace.append((step, h.available(), h.score(), h.snapshot()))
    return trace


@pytest.mark.parametrize("case", sorted(SEQUENCES))
def test_breaker_transitions_match_reference(case):
    ref, port = _both(_breaker_trace, case)
    assert port == ref
    assert {t[3]["state"] for t in port} > {"closed"}
    assert port_serving.BREAKER_STATES == ref_serving.BREAKER_STATES


# -------------------------------------------------------- fault plans ----
SPECS = ["fail@3", "fail:p=0.1", "fail:p=1.0,replica=2",
         "stall:p=0.05,s=0.02;corrupt:p=0.01;seed=7",
         "fail@3;stall:p=0.05,s=0.02;wedge:replica=1+2;corrupt:p=0.01;"
         "kill@0,7;seed=9", "wedge@0:s=0.1", "fail:p=0.05;stall:p=0.02,"
         "s=0.01", "", "seed=4"]
BAD_SPECS = ["explode", "fail:p=1.5", "kill:p=0.1", "fail:q=0.1"]


def _plan_view(plan):
    return (plan.describe(), plan.seed, [
        (s.kind, s.rate, s.at, s.replicas, s.duration_s)
        for s in plan.specs])


@pytest.mark.parametrize("spec", SPECS)
def test_fault_plan_parse_and_describe_match_reference(spec):
    ref, port = (_plan_view(pkg.FaultPlan.parse(spec, seed=3))
                 for pkg in PKGS.values())
    assert port == ref
    again = port_serving.FaultPlan.parse(port[0])
    assert _plan_view(again) == port


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_fault_plan_rejects_what_the_reference_rejects(spec):
    for pkg in PKGS.values():
        with pytest.raises(ValueError):
            pkg.FaultPlan.parse(spec)
    assert port_serving.FAULT_KINDS == ref_serving.FAULT_KINDS


def _decisions(pkg, seed, replica):
    spec = "fail:p=0.3;stall:p=0.2,s=0.0;corrupt:p=0.1;fail@5,9"
    plan = pkg.FaultPlan.parse(spec, seed=seed)
    inj = plan.for_replica(replica)
    f = inj.wrap(_echo)
    kinds = []
    for i in range(150):
        try:
            out = f(_ev(i))
            kinds.append("corrupt" if np.isnan(out["y"]) else "ok")
        except pkg.InjectedFault:
            kinds.append("fail")
    return inj.log, dict(inj.counts), kinds, plan.counts()


@pytest.mark.parametrize("seed,replica", [(0, 0), (0, 1), (11, 3)])
def test_injector_decisions_match_reference(seed, replica):
    ref, port = _both(_decisions, seed, replica)
    assert port == ref
    assert "fail" in port[2] and "corrupt" in port[2]


def test_corrupt_poisons_tensors_and_in_flight_results_on_the_host():
    """The port's poison reaches tensor leaves and a lane's in-flight
    result too; every poisoned leaf is a numpy array."""
    import torch

    from repro_torch.core.pipeline import InFlight
    plan = port_serving.FaultPlan.parse("corrupt@0,1")
    f = plan.for_replica(0).wrap(
        lambda feeds: InFlight({"y": torch.ones(3), "n": torch.arange(3),
                                "t": {"b": torch.zeros(2, dtype=torch.bool)}}))
    for _ in range(2):
        out = f({})
        assert isinstance(out["y"], np.ndarray) and np.isnan(out["y"]).all()
        assert (out["n"] == np.iinfo(np.int64).min).all()
        assert out["t"]["b"].all()


def test_tree_helpers_round_trip_in_jax_order():
    import jax
    tree = {"b": np.ones(2), "a": {"z": np.zeros(1), "c": [np.ones(3), 4]}}
    leaves, tdef = tree_flatten(tree)
    jleaves = jax.tree_util.tree_leaves(tree)
    assert len(leaves) == len(jleaves)
    for a, b in zip(leaves, jleaves, strict=True):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    back = tree_unflatten(tdef, leaves)
    assert back.keys() == tree.keys() and back["a"]["c"][1] == 4


# ------------------------------------------------- release semantics ----
def _slow_replica0(feeds):
    time.sleep(float(np.max(feeds["delay"])))
    return {"y": feeds["x"]}


def _out_of_order(pkg, loop):
    """Replica 0 of 4 is slow, so later events finish first; the merged
    release stage must still resolve in submission order."""
    svc = _svc(pkg, _slow_replica0, n_replicas=4, microbatch=4,
               window_s=2e-3, loop=loop)
    try:
        futs = []
        order, lock = [], threading.Lock()
        for i in range(24):
            f = svc.submit({"x": np.float32(i), "delay": np.float32(
                0.08 if i % 4 == 0 else 0.005)})
            f.add_done_callback(lambda _f, i=i: (lock.acquire(),
                                                 order.append(i),
                                                 lock.release()))
            futs.append(f)
        out = _outcomes(futs)
        svc.drain(timeout=TIMEOUT)
        s = svc.stats.summary()
        return out, order, s["completed"], [r.stats.submitted
                                            for r in svc.replicas]
    finally:
        svc.close()


def _hedged(pkg, loop):
    """A 1 s stall on batch 0 of the only lane: the deadline loop hedges
    after 0.03 s and the backup answers first."""
    plan = pkg.FaultPlan.parse("stall@0:s=1.0")
    svc = _svc(pkg, _echo, n_replicas=1, hedge_after_s=0.03, faults=plan,
               loop=loop)
    try:
        t0 = time.perf_counter()
        out = _outcomes([svc.submit(_ev(5))])
        fast = time.perf_counter() - t0 < 1.0
        svc.drain(timeout=TIMEOUT)
        return out, fast, svc.stats.hedged, plan.counts()["stall"]
    finally:
        svc.close()


def _shed(pkg, loop):
    """A gated lane with one batch in flight and a queue of 1: events past
    what the lane holds are shed at once (``ShedError``), the rest
    answered once the gate opens. How many the lane holds depends on when
    its batcher pops (2 or 3 here), so the counts are compared as
    bounds."""
    gate = threading.Event()

    def infer(feeds):
        assert gate.wait(timeout=TIMEOUT)
        return {"y": feeds["x"]}

    svc = _svc(pkg, infer, n_replicas=1, queue_depth=1, inflight=1,
               shed=True, loop=loop)
    try:
        futs = [svc.submit(_ev(0))]
        t0 = time.perf_counter()
        while svc.replicas[0].queued and time.perf_counter() - t0 < 5:
            time.sleep(1e-3)                   # event 0 reaches the lane
        time.sleep(0.05)
        futs += [svc.submit(_ev(i)) for i in range(1, 8)]
        done_early = [f.done() for f in futs]
        gate.set()
        out = _outcomes(futs)
        svc.drain(timeout=TIMEOUT)
        kinds = [k for k, _ in out]
        shed = kinds.count("ShedError")
        return (sorted(set(kinds)), out[0], kinds.count("ok") >= 2,
                shed >= 4, len(kinds) == 8,
                svc.stats.summary()["shed"] == shed,
                all(d for d, k in zip(done_early, kinds) if k != "ok"),
                all(v == float(i) for i, (k, v) in enumerate(out)
                    if k == "ok"))
    finally:
        gate.set()
        svc.close()


def _deadlines(pkg, loop):
    svc = _svc(pkg, _echo, n_replicas=1, loop=loop)
    try:
        futs = [svc.submit(_ev(0), deadline_s=0.0),
                svc.submit(_ev(1), deadline_s=30.0),
                svc.submit(_ev(2), deadline_s=0.0)]
        out = _outcomes(futs)
        svc.drain(timeout=TIMEOUT)
        return out, svc.stats.summary()["shed"]
    finally:
        svc.close()


def _failover(pkg, loop):
    plan = pkg.FaultPlan.parse("fail:p=1.0,replica=1")
    svc = _svc(pkg, _echo, n_replicas=2, microbatch=2, faults=plan,
               breaker=True, max_retries=2, loop=loop)
    try:
        futs = [svc.submit(_ev(i)) for i in range(24)]
        counts, _ = _ledger(futs)
        out = _outcomes(futs)
        svc.drain(timeout=TIMEOUT)
        s = svc.stats.summary()
        return (out, counts, s["completed"], s["failed"],
                s["failed_over"] > 0, s["retried"] >= s["failed_over"],
                svc.healths[1].trips >= 1, svc._releaser.released)
    finally:
        svc.close()


def _dead_fleet(pkg, loop):
    plan = pkg.FaultPlan.parse("fail:p=1.0")
    svc = _svc(pkg, _echo, n_replicas=2, faults=plan, breaker=True,
               max_retries=1, loop=loop)
    try:
        futs = [svc.submit(_ev(i)) for i in range(8)]
        out = _outcomes(futs)
        svc.drain(timeout=TIMEOUT)
        return out, svc.stats.summary()["retried"] <= 8
    finally:
        svc.close()


def _killed(pkg, loop):
    """``kill@0``: the batcher/launcher dies at its first checkpoint; the
    collected batch fails once, the rest resolve at close."""
    plan = pkg.FaultPlan.parse("kill@0")
    svc = _svc(pkg, _echo, n_replicas=1, microbatch=4, faults=plan,
               loop=loop, window_s=0.05)
    futs = [svc.submit(_ev(i)) for i in range(4)]
    counts, _ = _ledger(futs)
    try:
        first = type(futs[0].exception(timeout=TIMEOUT)).__name__
    finally:
        svc.close()
    return first, all(f.done() for f in futs), counts, plan.counts()["kill"]


def _close_with_backlog(pkg, loop):
    def infer(feeds):
        time.sleep(5e-3)
        return {"y": feeds["x"]}

    svc = _svc(pkg, infer, n_replicas=1, microbatch=2, inflight=1,
               window_s=60.0, loop=loop)
    futs = [svc.submit({"x": np.full(2, i + 1, np.float32)})
            for i in range(20)]
    counts, _ = _ledger(futs)
    svc.close()
    ok = sum(f.exception(timeout=TIMEOUT) is None for f in futs)
    return (all(f.done() for f in futs), counts, 0 < 20 - ok,
            svc.stats.completed == ok,
            sum(r.stats.failed for r in svc.replicas) == 20 - ok)


def _buckets(pkg, loop):
    """A slow small-occupancy bucket and a fast large one, alternating:
    each event is cut to its bucket's shape and released in global
    submission order."""
    def make(delay_s):
        def infer(feeds):
            time.sleep(delay_s)
            return {"y": feeds["mask"]}
        return infer

    svc = pkg.ShardedTriggerService(
        buckets={4: make(20e-3), 8: make(1e-3)}, n_replicas=1,
        microbatch=2, window_s=0.05, devices=None, loop=loop)
    try:
        futs, order, lock = [], [], threading.Lock()
        for i in range(12):
            mask = np.zeros(8, np.float32)
            mask[:2 if i % 2 == 0 else 6] = 1.0
            f = svc.submit({"mask": mask})
            f.add_done_callback(lambda _f, i=i: (lock.acquire(),
                                                 order.append(i),
                                                 lock.release()))
            futs.append(f)
        shapes = [f.result(timeout=TIMEOUT)["y"].shape for f in futs]
        svc.drain(timeout=TIMEOUT)
        return order, shapes, [r["submitted"] for r in svc.bucket_summary()]
    finally:
        svc.close()


SCENARIOS = {"out_of_order": _out_of_order, "shed": _shed,
             "buckets": _buckets,
             "deadlines": _deadlines, "failover": _failover,
             "dead_fleet": _dead_fleet, "killed": _killed,
             "close_with_backlog": _close_with_backlog}


@pytest.mark.parametrize("loop", ["deadline", "streaming"])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_release_semantics_match_reference(name, loop):
    ref, port = _both(SCENARIOS[name], loop)
    if name == "buckets":
        assert port[0] == list(range(12)) and port[2] == [6, 6]
    if name == "out_of_order":
        out, order, completed, per = port
        assert order == list(range(24)) and completed == 24
        assert out == [("ok", float(i)) for i in range(24)]
        assert per == [6, 6, 6, 6]
    counts_at = {"failover": 1, "killed": 2, "close_with_backlog": 1}
    if name in counts_at:                        # exactly once
        counts = port[counts_at[name]]
        assert counts == [1] * len(counts)
    assert port == ref


def test_hedging_matches_reference():
    ref, port = _both(_hedged, "deadline")
    assert port == ref == ([("ok", 5.0)], True, 1, 1)
    for pkg in PKGS.values():
        with pytest.raises(ValueError, match="hedge_after_s"):
            _svc(pkg, _echo, hedge_after_s=1e-3, loop="streaming")


def test_rolling_admission_matches_reference():
    """An event submitted while a launch is in flight rides the next
    launch: no deadline tick (the window is 60 s), no batch boundary."""
    def admission(pkg):
        gate, launched, launches = threading.Event(), threading.Event(), []

        def infer(feeds):
            launches.append([int(v) for v in np.asarray(feeds["x"]).ravel()
                             if v > 0])
            if len(launches) == 1:
                launched.set()
                assert gate.wait(timeout=TIMEOUT)
            return {"y": feeds["x"]}

        svc = pkg.ShardedTriggerService(infer, n_replicas=1, microbatch=4,
                                        window_s=60.0, devices=None,
                                        inflight=1, loop="streaming")
        try:
            f1 = svc.submit({"x": np.array([1.0], np.float32)})
            assert launched.wait(timeout=TIMEOUT)
            f2 = svc.submit({"x": np.array([2.0], np.float32)})
            f3 = svc.submit({"x": np.array([3.0], np.float32)})
            gate.set()
            got = [float(f.result(timeout=TIMEOUT)["y"][0])
                   for f in (f1, f2, f3)]
            svc.drain(timeout=TIMEOUT)
            return launches, got, svc.stats.batches, \
                svc.stats.padded_events
        finally:
            gate.set()
            svc.close()
    ref, port = _both(admission)
    assert port == ref == ([[1], [2, 3]], [1.0, 2.0, 3.0], 2, 5)


def test_services_of_both_packages_report_alike():
    """The same traffic through both packages' services: the same
    summary counters, per-replica and per-route rows, loops and
    validation errors."""
    def report(pkg):
        svc = pkg.ShardedTriggerService(
            routes={"a": _echo, "b": _echo}, n_replicas=2, microbatch=2,
            devices=None, window_s=1e-3)
        try:
            futs = [svc.submit(_ev(i), route="ab"[i % 2]) for i in range(12)]
            out = _outcomes(futs)
            svc.drain(timeout=TIMEOUT)
            s = svc.stats.summary()
            keep = ("replicas", "completed", "failed", "shed", "retried",
                    "failed_over")
            rows = [{k: r[k] for k in ("route", "replicas", "submitted",
                                        "completed")}
                    for r in svc.route_summary()]
            return out, {k: s[k] for k in keep}, rows, \
                sorted(svc.fault_tolerance_summary())
        finally:
            svc.close()
    ref, port = _both(report)
    assert port == ref
    assert port_serving.LOOPS == ref_serving.LOOPS
    for pkg in PKGS.values():
        with pytest.raises(ValueError, match="unknown replica loop"):
            _svc(pkg, _echo, loop="bogus")
        with pytest.raises(ValueError, match="route= is required"):
            svc = pkg.ShardedTriggerService(
                routes={"a": _echo, "b": _echo}, microbatch=1, devices=None)
            try:
                svc.submit(_ev(0))
            finally:
                svc.close()


def test_monitor_and_bucketed_pipeline_are_not_ported():
    class Bucketed:
        def infer_fns(self):
            return {8: _echo}
    with pytest.raises(NotImplementedError, match="monitor"):
        _svc(port_serving, _echo, monitor=True)
    with pytest.raises(NotImplementedError, match="Bucketed deployment"):
        port_serving.ShardedTriggerService(buckets=Bucketed(), microbatch=1,
                                           devices=None)
    svc = _svc(port_serving, _echo)
    try:
        assert not svc.monitoring
        for call in (svc.monitor_snapshot, svc.event_displays):
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                call()
    finally:
        svc.close()
