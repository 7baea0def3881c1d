"""The monitored service of the port against the reference's, on the CPU:
``monitor=True`` with each event's truth bit submitted, 1 and 2 replicas,
both replica loops, over the mixed CaloClusterNet deployment of each
package on the same weights and events. The fleet snapshot counts the
same events and gives the same trigger rate, efficiency, fake rate and
clusters per event (CPS's integer outputs are bitwise equal), and the
mean cluster energy within the float32 row. In the streaming loop the
replicas' lanes fill their output ring as on the card (each slot's host
buffers written again by its next launch, which a CPU lane does not do)
and the snapshot is read after the ring has wrapped many times: a tap
that staged views of the ring instead of copies would fold overwritten
rows. The truth side channel drains as the reference's does."""
import numpy as np
import pytest
import torch
from test_torch_capture import _events, _req_kw, ccn_graphs

import repro.serving as ref_serving
import repro_torch.serving as port_serving
from repro.core.passes.parallelize import Requirements as JReq
from repro.core.pipeline import deploy as jdeploy
from repro_torch.core.pipeline import InFlight, Lane
from repro_torch.core.pipeline import Requirements as TReq
from repro_torch.core.pipeline import deploy as tdeploy

__all__ = ["ccn_graphs"]          # the shared module fixture

N_EVENTS = 48
MICROBATCH = 2
TIMEOUT = 120
EXACT = ("events", "window_events", "trigger_rate", "efficiency",
         "fake_rate", "clusters_per_event", "truth_events")


def _fill(src, dst):
    """``src`` copied into the host tree ``dst`` (allocated where
    absent), as a lane on the card copies into its caller's ring."""
    if isinstance(src, dict):
        dst = dst if isinstance(dst, dict) else {}
        return {k: _fill(v, dst.get(k)) for k, v in src.items()}
    if dst is None or dst.shape != src.shape or dst.dtype != src.dtype:
        dst = torch.empty_like(src)
    return dst.copy_(src)


class RingLane(Lane):
    """A CPU lane that, as one on the card does, writes its result into
    the ``out`` tree it is given (a slot of the streaming loop's output
    ring, handed back at the slot's next launch)."""

    def __init__(self, pipe):
        super().__init__(pipe)
        self.filled = 0

    def __call__(self, feeds, out=None):
        res = super().__call__(feeds).wait()
        self.filled += out is not None
        return InFlight(_fill(res, out))


@pytest.fixture(scope="module")
def deployments(ccn_graphs):
    jg, tg = ccn_graphs
    kw = dict(calibration_feeds=_events(16, 123))
    jp = jdeploy(jg, JReq(**_req_kw(3, policy="mixed")), **kw)
    tp = tdeploy(tg, TReq(**_req_kw(3, policy="mixed")), device="cpu", **kw)
    ev = _events(N_EVENTS, 7)
    truth = np.random.default_rng(3).integers(0, 2, N_EVENTS).astype(bool)
    return jp, tp, ev, truth


def _monitored(pkg, infer, n_replicas, loop, feeds, truth):
    """Every event submitted with its truth bit; (snapshot, event
    displays, the service's truth map after the drain, the service)."""
    svc = pkg.ShardedTriggerService(infer, n_replicas=n_replicas,
                                    microbatch=MICROBATCH, window_s=2e-3,
                                    devices=None, loop=loop, monitor=True)
    try:
        futs = [svc.submit({k: v[i] for k, v in feeds.items()},
                           truth=bool(truth[i])) for i in range(N_EVENTS)]
        for f in futs:
            f.result(timeout=TIMEOUT)
        svc.drain(timeout=TIMEOUT)
        return (svc.monitor_snapshot(), svc.event_displays(),
                dict(svc._truth), svc)
    finally:
        svc.close()


@pytest.mark.parametrize("n_replicas", [1, 2])
@pytest.mark.parametrize("loop", ["streaming", "deadline"])
def test_monitored_service_snapshot_equals_reference(deployments, loop,
                                                     n_replicas):
    jp, tp, feeds, truth = deployments
    want, want_disp, want_truth, _ = _monitored(
        ref_serving, jp, n_replicas, loop, feeds, truth)
    infer = ([RingLane(tp) for _ in range(n_replicas)]
             if loop == "streaming" else tp)
    got, disp, left, svc = _monitored(
        port_serving, infer, n_replicas, loop, feeds, truth)
    assert svc.monitoring and len(svc.monitors) == n_replicas
    assert {k: got[k] for k in EXACT} == {k: want[k] for k in EXACT}
    assert got["events"] == N_EVENTS and got["truth_events"] == N_EVENTS
    assert got["clusters_per_event"] > 0
    assert got["cluster_e_mean"] == pytest.approx(want["cluster_e_mean"],
                                                  rel=1e-5, abs=1e-5)
    assert got["serving"] == want["serving"]
    assert left == want_truth == {}
    # every event's display record: its id, decision, truth and clusters
    assert [d["event"] for d in disp] == [d["event"] for d in want_disp] \
        == list(range(N_EVENTS))
    for d, w in zip(disp, want_disp, strict=True):
        assert (d["trigger"], d["truth"], d["grid"], len(d["clusters"])) == \
            (w["trigger"], w["truth"], w["grid"], len(w["clusters"]))
    if loop == "streaming":
        lanes = [r.lane for r in svc.replicas]
        assert all(isinstance(lane, RingLane) for lane in lanes)
        # the output ring (inflight + 1 slots a replica) wrapped often
        assert sum(lane.filled for lane in lanes) >= 3 * (
            svc.replicas[0].inflight + 1)


def test_monitor_dict_configures_each_replica(deployments):
    """``monitor=`` as a dict goes to every replica's ``TriggerMonitor``,
    as in the reference: the detector's grid and the display ring's
    length."""
    jp, tp, feeds, truth = deployments
    from repro.data.belle2 import current_detector as jcur
    from repro_torch.data.belle2 import current_detector as tcur
    out = {}
    for name, pkg, pipe, det in (("ref", ref_serving, jp, jcur()),
                                 ("port", port_serving, tp, tcur())):
        svc = pkg.ShardedTriggerService(
            pipe, n_replicas=2, microbatch=MICROBATCH, devices=None,
            monitor={"detector": det, "display_n": 4, "window": 16})
        try:
            futs = [svc.submit({k: v[i] for k, v in feeds.items()})
                    for i in range(12)]
            for f in futs:
                f.result(timeout=TIMEOUT)
            svc.drain(timeout=TIMEOUT)
            out[name] = ([(m.grid, m.window, m._display.maxlen)
                          for m in svc.monitors], svc.monitor_snapshot(),
                         [d["event"] for d in svc.event_displays(3)])
        finally:
            svc.close()
    assert out["port"][0] == out["ref"][0] == [((24, 24), 16, 4)] * 2
    assert out["port"][1]["truth_events"] == 0
    assert out["port"][1]["efficiency"] is out["ref"][1]["efficiency"]
    assert out["port"][2] == out["ref"][2] == [9, 10, 11]


def _echo_cps(feeds):
    x = np.asarray(feeds["x"], np.float32)
    n = x.shape[0]
    return {"cps": {"trigger": x > 0.5,
                    "n_clusters": (x > 0.25).astype(np.int32),
                    "cluster_valid": np.repeat((x > 0.25)[:, None], 2, 1)
                    .astype(np.float32),
                    "cluster_xy": np.zeros((n, 2, 2), np.float32),
                    "cluster_e": np.repeat(x[:, None], 2, 1),
                    "cluster_beta": np.full((n, 2), 0.5, np.float32)}}


@pytest.mark.parametrize("loop", ["streaming", "deadline"])
def test_monitor_counts_every_event_under_thread_churn(loop):
    """Six replicas (more threads than cores), two submitting threads and
    a switch interval of 1 µs: the submit threads write the truth side
    channel while every replica's loop pops it and stages its monitor; no
    count is lost, the truth map drains, and the fleet's efficiency and
    fake rate are the submitted events' own."""
    import sys
    import threading
    n, half = 600, 300
    rng = np.random.default_rng(5)
    xs = rng.uniform(size=n).astype(np.float32)
    truth = rng.uniform(size=n) < 0.5
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    svc = port_serving.ShardedTriggerService(
        _echo_cps, n_replicas=6, microbatch=4, window_s=1e-3, devices=None,
        loop=loop, monitor=True)
    try:
        futs = [None] * n

        def feed(lo):
            for i in range(lo, lo + half):
                futs[i] = svc.submit({"x": xs[i]}, truth=bool(truth[i]))
        threads = [threading.Thread(target=feed, args=(lo,))
                   for lo in (0, half)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert not any(t.is_alive() for t in threads)
        for f in futs:
            f.result(timeout=TIMEOUT)
        svc.drain(timeout=TIMEOUT)
        snap = svc.monitor_snapshot()
        left = dict(svc._truth)
    finally:
        sys.setswitchinterval(old)
        svc.close()
    fired = xs > 0.5
    assert snap["events"] == snap["truth_events"] == n
    assert sum(m.total for m in svc.monitors) == n
    assert left == {}
    assert snap["efficiency"] == pytest.approx(
        (fired & truth).sum() / truth.sum())
    assert snap["fake_rate"] == pytest.approx(
        (fired & ~truth).sum() / (~truth).sum())
    assert snap["trigger_rate"] == pytest.approx(fired.mean())
