"""The port's occupancy-bucketed deployment (``deploy_bucketed``,
``BucketedPipeline``, ``_cut_hits``) and the design flow's report
(``resource_report``, ``model_throughput``, ``model_latency``) against the
reference's, live on the CPU: the current detector's CaloClusterNet on
the same weights, buckets (8, 16, 32), two events a launch, events of
``with_occupancy`` spread over the buckets, under fp and mixed. Heads are
held to the float32 row (mixed: the int8 flip bound), CPS's integer
outputs bitwise, each bucket's int8 weights bitwise and its calibrated
scales to the float32 row (calibration sees the bucket's own hits), the
reports equal. The bucketed service answers as the reference's does,
each bucket replica on a lane of its own bucket's executable, captured
before traffic (driven through ``test_torch_capture.py``'s
``FakeGraphs``)."""
import types

import jax
import numpy as np
import pytest
import torch
from _numerics import assert_bitwise, assert_calibration_close, assert_close
from test_torch_capture import FakeGraphs, _events, _req_kw, ccn_graphs
from test_torch_mixed import _op_rows, _quantum

import repro.serving as ref_serving
import repro_torch.serving as port_serving
from repro.core import pipeline as jpipeline
from repro.core.passes.parallelize import Requirements as JReq
from repro.data import belle2 as jbelle2
from repro_torch.core import pipeline as tpipeline
from repro_torch.core.pipeline import Lane
from repro_torch.core.pipeline import Requirements as TReq

__all__ = ["ccn_graphs"]          # the shared module fixture

BUCKETS = (8, 16, 32)
MICROBATCH = 2
N_EVENTS = 24
TIMEOUT = 120
HEADS = ("beta", "coords", "energy", "cls")
CPS_INT = ("n_clusters", "trigger", "cluster_valid")


def _occupancy_events(n, seed):
    gen = jbelle2.with_occupancy(jbelle2.current_detector(), (4, 8, 16, 32))
    ev = jbelle2.generate(gen, n, seed=seed)
    return {"hits": ev["feats"], "mask": ev["mask"]}, ev["trigger_truth"]


@pytest.fixture(scope="module", params=["fp", "mixed"])
def bucketed(request, ccn_graphs):
    """(policy, reference deployment, port deployment)."""
    jg, tg = ccn_graphs
    kw = dict(buckets=BUCKETS, microbatch=MICROBATCH,
              calibration_feeds=_events(16, 123))
    jb = jpipeline.deploy_bucketed(
        jg, JReq(**_req_kw(3, policy=request.param)), **kw)
    tb = tpipeline.deploy_bucketed(
        tg, TReq(**_req_kw(3, policy=request.param)), device="cpu", **kw)
    return request.param, jb, tb


def _quantum_of(tb):
    return max(_quantum(p.graph) for p in tb.pipes.values())


def _assert_outputs(got, want, policy, quantum, context=""):
    """Heads within the float32 row (mixed: the flip bound), CPS's
    integer outputs bitwise, its floats within the float32 row (fp)."""
    for h in HEADS:
        if policy == "mixed":
            assert_calibration_close(got[h], want[h], quantum=quantum,
                                     context=f"{context}{h}")
        else:
            assert_close(got[h], want[h], dtype="float32",
                         context=f"{context}{h}")
    for k in CPS_INT:
        assert_bitwise(got["cps"][k], want["cps"][k], context=f"{context}{k}")
    if policy == "fp":
        for k in ("cluster_xy", "cluster_e", "cluster_beta"):
            assert_close(got["cps"][k], want["cps"][k], dtype="float32",
                         context=f"{context}{k}")


def test_bucketed_call_matches_reference(bucketed):
    policy, jb, tb = bucketed
    feeds, _ = _occupancy_events(N_EVENTS, 11)
    occ = np.count_nonzero(feeds["mask"] > 0, axis=1)
    assert len({jb.classify(int(o)) for o in occ}) == len(BUCKETS)
    want = jax.tree_util.tree_map(np.asarray, jb(feeds))
    got = tb(feeds)
    assert isinstance(got["beta"], np.ndarray)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    _assert_outputs(got, want, policy, _quantum_of(tb))
    # the same without capture, and from tensor feeds
    eager = tb.run_eager({k: torch.from_numpy(v) for k, v in feeds.items()})
    for a, b in zip(jax.tree_util.tree_leaves(eager),
                    jax.tree_util.tree_leaves(got), strict=True):
        assert_bitwise(a, b)


def test_bucket_deployments_equal_reference(bucketed):
    """One executable per bucket at n_hits = b and the launch width: the
    graphs op for op, the weights (and int8 weights) bitwise, the scales
    calibrated on the bucket's own hits within the float32 row."""
    policy, jb, tb = bucketed
    assert tb.buckets == jb.buckets == BUCKETS
    assert tb.microbatch == jb.microbatch == MICROBATCH
    scales = set()
    for b in BUCKETS:
        jp, tp = jb.pipes[b], tb.pipes[b]
        assert tp.req.n_hits == jp.req.n_hits == b
        assert tp.microbatch == jp.microbatch == MICROBATCH
        assert _op_rows(tp.graph) == _op_rows(jp.graph)
        for op in jp.graph:
            top = tp.graph[op.name]
            for k, v in (op.params or {}).items():
                assert_bitwise(top.params[k].numpy(), np.asarray(v),
                               context=f"{b}/{op.name}/{k}")
            for k in (k for k in op.attrs if k.endswith("_scale")):
                assert_close(top.attrs[k], op.attrs[k], dtype="float32",
                             context=f"{b}/{op.name}/{k}")
                scales.add((op.name, k, round(op.attrs[k], 9)))
    if policy == "mixed":
        # the buckets calibrate apart: some scale differs between them
        names = {(n, k) for n, k, _ in scales}
        assert len(scales) > len(names)


def assert_report_equal(t_rows, j_rows):
    """The port's design-flow report rows (on the "cpu" model) equal the
    reference's in every key both report: the reference's keys but
    ``vmem_util``, a TPU core's VMEM share, which the port does not
    model and must not report."""
    assert len(t_rows) == len(j_rows)
    for t, j in zip(t_rows, j_rows, strict=True):
        assert "vmem_util" not in t
        assert t == {k: v for k, v in j.items() if k != "vmem_util"}


def test_reports_equal_reference(bucketed):
    _, jb, tb = bucketed
    t_rep, j_rep = tb.resource_report(), jb.resource_report()
    assert sorted(t_rep) == sorted(j_rep)
    for b in j_rep:
        assert_report_equal(t_rep[b], j_rep[b])
    for b in BUCKETS:
        assert tb.pipes[b].model_throughput() == \
            jb.pipes[b].model_throughput()
        assert tb.pipes[b].model_latency() == jb.pipes[b].model_latency()
    assert tb.warmup() == jb.warmup() == len(BUCKETS)


def test_ragged_report_equals_reference(ccn_graphs):
    jg, tg = ccn_graphs
    jr = jpipeline.deploy(jg, JReq(**_req_kw(3)), batch=4, ragged=True)
    tr = tpipeline.deploy(tg, TReq(**_req_kw(3)), batch=4, ragged=True,
                          device="cpu")
    assert_report_equal(tr.resource_report(), jr.resource_report())
    rows = tr.resource_report()
    assert rows and all(r["time_s_per_step"] > 0 for r in rows)


@pytest.mark.parametrize("dp", [1, 3])
def test_compiled_report_equals_reference(dp, ccn_graphs):
    jg, tg = ccn_graphs
    jp = jpipeline.deploy(jg, JReq(**_req_kw(dp)))
    tp = tpipeline.deploy(tg, TReq(**_req_kw(dp)), device="cpu")
    assert_report_equal(tp.resource_report(), jp.resource_report())
    assert tp.model_throughput() == jp.model_throughput()
    assert tp.model_latency() == jp.model_latency()


@pytest.mark.parametrize("occupancy", range(0, 41, 3))
def test_classify_equals_reference(occupancy):
    """The smallest bucket that fits, overflow to the largest."""
    pipes = dict.fromkeys(BUCKETS, types.SimpleNamespace(device=None,
                                                         backend="cpu"))
    tb = tpipeline.BucketedPipeline(pipes, microbatch=MICROBATCH)
    jb = jpipeline.BucketedPipeline(pipes, microbatch=MICROBATCH)
    assert tb.classify(occupancy) == jb.classify(occupancy)


@pytest.mark.parametrize("n", [5, 16, 40])
def test_cut_hits_equals_reference(n):
    """Sliced past ``n`` hits, zero-padded short of it, passed through at
    it; numpy in, numpy out; a tensor in, a tensor out."""
    feeds, _ = _occupancy_events(3, 5)
    feeds = {k: v[:, :16] for k, v in feeds.items()}
    want = {k: np.asarray(v) for k, v in jpipeline._cut_hits(feeds,
                                                              n).items()}
    got = tpipeline._cut_hits(feeds, n)
    got_t = tpipeline._cut_hits({k: torch.from_numpy(np.ascontiguousarray(
        v)) for k, v in feeds.items()}, n)
    for k in want:
        assert isinstance(got[k], np.ndarray)
        assert isinstance(got_t[k], torch.Tensor)
        assert_bitwise(got[k], want[k], context=k)
        assert_bitwise(got_t[k].numpy(), want[k], context=k)
    if n == 16:
        assert all(got[k] is feeds[k] for k in feeds)


@pytest.mark.parametrize("loop", ["streaming", "deadline"])
def test_bucketed_service_matches_reference(bucketed, loop):
    """``ShardedTriggerService(buckets=)`` of each package over its own
    deployment: every event answered in submission order as the
    reference's service answers it, the per-bucket intake and completion
    rows equal, each bucket warmed once before traffic."""
    policy, jb, tb = bucketed
    feeds, _ = _occupancy_events(N_EVENTS, 13)

    def serve(pkg, bpipe):
        svc = pkg.ShardedTriggerService(buckets=bpipe, n_replicas=2,
                                        microbatch=MICROBATCH, window_s=2e-3,
                                        devices=None, loop=loop)
        try:
            futs = [svc.submit({k: v[i] for k, v in feeds.items()})
                    for i in range(N_EVENTS)]
            res = [jax.tree_util.tree_map(np.asarray,
                                          f.result(timeout=TIMEOUT))
                   for f in futs]
            svc.drain(timeout=TIMEOUT)
            rows = [{k: r[k] for k in ("bucket", "replicas", "submitted",
                                       "completed")}
                    for r in svc.bucket_summary()]
            return res, rows, [r.warmed for r in svc.replicas], svc
        finally:
            svc.close()
    want, want_rows, want_warm, _ = serve(ref_serving, jb)
    got, rows, warm, svc = serve(port_serving, tb)
    assert rows == want_rows and warm == want_warm
    assert sum(warm) == len(BUCKETS)
    assert all(isinstance(r.lane, Lane) for r in svc.replicas)
    quantum = _quantum_of(tb)
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        _assert_outputs(g, w, policy, quantum, context=f"{i}/")


def test_each_bucket_replica_serves_on_its_own_lane(ccn_graphs):
    """Two replicas a bucket: each bucket's executable is called once in
    its group's warm-up (its one capture), then each replica's lane of
    that executable captures the shape for itself before traffic; under
    traffic the lanes replay and capture nothing, the executables are not
    called; every answer equals the eager bucketed call bitwise."""
    _, tg = ccn_graphs
    tb = tpipeline.deploy_bucketed(
        tg, TReq(**_req_kw(3, policy="mixed")), buckets=BUCKETS,
        microbatch=MICROBATCH, calibration_feeds=_events(16, 123),
        device="cpu")
    fakes = {}
    for b, pipe in tb.pipes.items():
        fakes[b] = FakeGraphs()
        pipe._graphs = tpipeline._ChunkGraphs(pipe, fakes[b])
    feeds, _ = _occupancy_events(N_EVENTS, 17)
    want = tb.run_eager(feeds)
    svc = port_serving.ShardedTriggerService(
        buckets=tb, n_replicas=2, microbatch=MICROBATCH, window_s=2e-3,
        devices=None, loop="streaming")
    try:
        parents = {b: (f.captured, f.replayed) for b, f in fakes.items()}
        assert all(c == 1 for c, _ in parents.values())
        assert all(len(f.forks) == 2 for f in fakes.values())
        lanes = [r.lane for r in svc.replicas]
        assert len({id(lane) for lane in lanes}) == len(lanes) == 6
        for gi, b in enumerate(BUCKETS):
            for r in svc.replicas[2 * gi:2 * gi + 2]:
                assert r.lane.parent is tb.pipes[b] and r.captured == 1
        start = {b: [(c.captured, c.replayed) for c in f.forks]
                 for b, f in fakes.items()}
        futs = [svc.submit({k: v[i] for k, v in feeds.items()})
                for i in range(N_EVENTS)]
        got = [f.result(timeout=TIMEOUT) for f in futs]
        svc.drain(timeout=TIMEOUT)
        assert all(c["captures"] == c["captured_at_start"] == 1
                   for c in svc.capture_summary())
        for b, f in fakes.items():
            assert (f.captured, f.replayed) == parents[b]
            assert [c.captured for c in f.forks] == [1, 1]
            assert sum(c.replayed for c in f.forks) > sum(
                r for _, r in start[b])
    finally:
        svc.close()
    occ = np.count_nonzero(feeds["mask"] > 0, axis=1)
    for i, g in enumerate(got):
        b = tb.classify(int(occ[i]))
        for h in HEADS:
            assert_bitwise(g[h], want[h][i, :b], context=f"{i}/{h}")
        for k, v in g["cps"].items():
            assert_bitwise(v, want["cps"][k][i], context=f"{i}/{k}")
