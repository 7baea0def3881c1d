"""The port's service over its deployed pipelines on the CPU: each replica
serves through a lane of its own (``core/pipeline.py:Lane``), and the
service answers as the reference's service over the reference's pipeline
does on the same weights and events (mixed CaloClusterNet, the GatedGCN
and GraphSAGE routes, the ragged path; CPS and the trigger bitwise, heads
within the float32 row, or within the int8 flip bound under mixed). The
lanes are driven through the recording stand-in capture backend of
``test_torch_capture.py``: every lane captures its own chunk shapes before
traffic and none under it, and its answers equal the eager chunk loop's
bitwise. The thread-safety repairs: concurrent callers of one pipeline
keep their own edge lists, and the launch counters lose no concurrent
addition.
"""
import sys
import threading

import jax
import numpy as np
import pytest
import torch
from _numerics import assert_bitwise, assert_calibration_close, assert_close
from test_torch_capture import (FakeGraphs, _events, _gnn_graphs, _req_kw,
                                ccn_graphs)
from test_torch_mixed import _quantum

import repro.serving as ref_serving
import repro_torch.serving as port_serving
from repro.core.passes.parallelize import Requirements as JReq
from repro.core.pipeline import deploy as jdeploy
from repro_torch.core import pipeline as tpipeline
from repro_torch.core.pipeline import Lane, RaggedLane
from repro_torch.core.pipeline import Requirements as TReq
from repro_torch.core.pipeline import deploy as tdeploy
from repro_torch.kernels import ops as kops
from repro_torch.launch import mesh

TIMEOUT = 120
N_EVENTS = 20


def _edge_events(n, seed, d_in, d_edge=None, nodes=32, edges=96):
    rng = np.random.default_rng(seed)
    f = {"nodes": rng.normal(size=(n, nodes, d_in)).astype(np.float32),
         "edge_index": rng.integers(0, nodes, size=(n, 2, edges))
         .astype(np.int32),
         "node_mask": (rng.uniform(size=(n, nodes)) < 0.8)
         .astype(np.float32),
         "edge_mask": (rng.uniform(size=(n, edges)) < 0.7)
         .astype(np.float32)}
    if d_edge is not None:
        f["edges"] = rng.normal(size=(n, edges, d_edge)).astype(np.float32)
    return f


def _deployments(path, ccn_graphs):
    """(reference service kwargs, port service kwargs, feeds by route,
    microbatch, the port's pipelines by route) of one path."""
    jg, tg = ccn_graphs
    if path == "mixed":
        kw = dict(calibration_feeds=_events(16, 123))
        jp = jdeploy(jg, JReq(**_req_kw(3, policy="mixed")), **kw)
        tp = tdeploy(tg, TReq(**_req_kw(3, policy="mixed")), device="cpu",
                     **kw)
        return ({"infer_fn": jp}, {"infer_fn": tp},
                {None: _events(N_EVENTS, 7)}, max(tp.microbatch, 16),
                {None: tp})
    if path == "ragged":
        jp = jdeploy(jg, JReq(**_req_kw(3)), batch=4, ragged=True)
        tp = tdeploy(tg, TReq(**_req_kw(3)), batch=4, ragged=True,
                     device="cpu")
        return ({"ragged": jp}, {"ragged": tp}, {None: _events(N_EVENTS, 8)},
                8, {None: tp})
    jps, tps, feeds = {}, {}, {}
    for name, d_in, d_edge in (("gatedgcn", 8, 4), ("graphsage", 12, None)):
        jgg, tgg = _gnn_graphs(name)
        jps[name] = jdeploy(jgg, JReq(**_req_kw(3)))
        tps[name] = tdeploy(tgg, TReq(**_req_kw(3)), device="cpu")
        feeds[name] = _edge_events(N_EVENTS // 2, 9, d_in, d_edge)
    return ({"routes": jps}, {"routes": tps}, feeds,
            max(8, *(p.microbatch for p in tps.values())), tps)


def _serve(pkg, svc_kw, feeds, microbatch, loop, n_replicas=2):
    """Every event through a service of ``pkg``, the routes' events one
    of each in turn; returns {route: [result per event]} and the order
    the futures resolved in."""
    svc = pkg.ShardedTriggerService(
        **svc_kw, n_replicas=n_replicas, microbatch=microbatch,
        window_s=2e-3, devices=None, loop=loop)
    order, lock = [], threading.Lock()
    try:
        futs = []
        for i in range(max(len(next(iter(f.values())))
                           for f in feeds.values())):
            for route, f in feeds.items():
                fut = svc.submit({k: v[i] for k, v in f.items()},
                                 route=route)
                fut.add_done_callback(lambda _f, n=len(futs): (
                    lock.acquire(), order.append(n), lock.release()))
                futs.append((route, fut))
        res = {r: [] for r in feeds}
        for route, fut in futs:
            res[route].append(jax.tree_util.tree_map(
                np.asarray, fut.result(timeout=TIMEOUT)))
        svc.drain(timeout=TIMEOUT)
        return res, order, svc
    finally:
        svc.close()


@pytest.mark.parametrize("loop", ["streaming", "deadline"])
@pytest.mark.parametrize("path", ["mixed", "routes", "ragged"])
def test_service_matches_reference_service(path, loop, ccn_graphs):
    """Two replicas of the port's service over its CPU pipeline (one lane
    each) against two of the reference's over its own: every event in
    submission order, CPS and the trigger bitwise, the heads within the
    float32 row (the int8 flip bound under mixed)."""
    jkw, tkw, feeds, mb, tpipes = _deployments(path, ccn_graphs)
    want, word, _ = _serve(ref_serving, jkw, feeds, mb, loop)
    got, gord, svc = _serve(port_serving, tkw, feeds, mb, loop)
    n = sum(len(v) for v in got.values())
    assert gord == word == list(range(n))
    assert all(isinstance(r.lane, (Lane, RaggedLane)) for r in svc.replicas)
    assert len({id(r.lane) for r in svc.replicas}) == len(svc.replicas)
    for route in feeds:
        quantum = _quantum(tpipes[route].pipe.graph if path == "ragged"
                           else tpipes[route].graph)
        for i, (g, w) in enumerate(zip(got[route], want[route],
                                       strict=True)):
            for k in g:
                if k == "cps":
                    for c in ("n_clusters", "trigger", "cluster_valid"):
                        assert_bitwise(g[k][c], w[k][c], context=f"{i}/{c}")
                elif path == "mixed":
                    assert_calibration_close(g[k], w[k], quantum=quantum,
                                             context=f"{i}/{k}")
                else:
                    assert_close(g[k], w[k], dtype="float32",
                                 context=f"{route} {i}/{k}")


# ------------------------------------------------------------ the lanes ----
def _lane_case(path, ccn_graphs):
    """(pipeline with the recording backend injected, feeds, micro-batch,
    eager answers per event)."""
    _, tg = ccn_graphs
    if path == "ragged":
        rp = tdeploy(tg, TReq(**_req_kw(3)), batch=4, ragged=True,
                     device="cpu")
        rp.pipe._graphs = tpipeline._ChunkGraphs(rp.pipe, FakeGraphs())
        feeds = _events(N_EVENTS, 21)
        want = rp.run_eager(feeds)
        return rp, rp.pipe._graphs.backend, feeds, 8, want
    kw = dict(calibration_feeds=_events(16, 123))
    pipe = tdeploy(tg, TReq(**_req_kw(3, policy="mixed")), device="cpu",
                   **kw)
    fake = FakeGraphs()
    pipe._graphs = tpipeline._ChunkGraphs(pipe, fake)
    mb = max(pipe.microbatch, 16)
    pipe(_events(mb, 99))            # the route's warm-up call captures
    feeds = _events(N_EVENTS, 22)
    want = {k: (v.numpy() if k != "cps" else {c: t.numpy()
                                              for c, t in v.items()})
            for k, v in pipe.run_eager(feeds).items()}
    return pipe, fake, feeds, mb, want


@pytest.mark.parametrize("loop", ["streaming", "deadline"])
@pytest.mark.parametrize("path", ["mixed", "ragged"])
def test_lanes_capture_before_traffic_and_answer_as_eager(path, loop,
                                                          ccn_graphs):
    """Two replicas with two dispatches in flight each: each lane captures
    its own chunk shapes in the service's construction (never the
    pipeline's captures, never another lane's), replays them under
    traffic and captures nothing there; every event's answer equals the
    eager chunk loop's bitwise."""
    pipe, fake, feeds, mb, want = _lane_case(path, ccn_graphs)
    parent_before = (fake.captured, fake.replayed)
    svc = port_serving.ShardedTriggerService(
        **({"ragged": pipe} if path == "ragged" else {"infer_fn": pipe}),
        n_replicas=2, inflight=2, microbatch=mb, window_s=2e-3, devices=None,
        loop=loop)
    try:
        forks = fake.forks
        assert len(forks) == 2 and all(f is not fake for f in forks)
        start = [(f.captured, f.replayed) for f in forks]
        assert all(c >= 1 for c, _ in start)
        assert [r.captured for r in svc.replicas] == [1, 1]
        futs = [svc.submit({k: v[i] for k, v in feeds.items()})
                for i in range(N_EVENTS)]
        got = [f.result(timeout=TIMEOUT) for f in futs]
        svc.drain(timeout=TIMEOUT)
        assert all(c["captures"] == c["captured_at_start"] == 1
                   for c in svc.capture_summary())
        for f, (c0, r0) in zip(forks, start, strict=True):
            assert f.captured == c0 and f.replayed > r0
        assert (fake.captured, fake.replayed) == parent_before
    finally:
        svc.close()
    for i, g in enumerate(got):
        for k, v in g.items():
            if k == "cps":
                for c in v:
                    assert_bitwise(v[c], want[k][c][i], context=f"{i}/{c}")
            else:
                assert_bitwise(v, want[k][i], context=f"{i}/{k}")


def test_a_lane_without_shapes_to_capture_raises(ccn_graphs):
    """A pipeline that captures but has captured no chunk shape gives its
    lanes nothing to capture before traffic: building the service
    raises, it does not capture later."""
    _, tg = ccn_graphs
    pipe = tdeploy(tg, TReq(**_req_kw(3)), device="cpu")
    pipe._graphs = tpipeline._ChunkGraphs(pipe, FakeGraphs())
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="captured no chunk shape"):
        # replica 0 (a plain callable) starts; replica 1's lane raises,
        # and replica 0 is stopped before the error goes on
        port_serving.ShardedTriggerService(
            [lambda feeds: feeds, pipe], n_replicas=2, microbatch=16,
            devices=None, loop="streaming")
    assert threading.active_count() == before   # nothing left running


def test_lane_shares_weights_and_owns_what_a_call_mutates(ccn_graphs):
    _, tg = ccn_graphs
    pipe = tdeploy(tg, TReq(**_req_kw(3)), device="cpu")
    a, b = pipe.lane(), pipe.lane()
    assert a._run.graph is b._run.graph is pipe.graph
    assert a._run._plans is pipe._plans
    assert len({id(pipe._ex), id(a._run._ex), id(b._run._ex)}) == 3
    assert a.stream is None and a.captures == 0 and a.device == pipe.device
    feeds = _events(4, 3)
    out = a(feeds)
    assert out.ready() and out.done is None
    assert_bitwise(out.wait()["beta"].numpy(),
                   pipe.run_eager(feeds)["beta"].numpy())


# ------------------------------------------------------ thread safety ----
def test_concurrent_callers_of_one_gnn_pipeline_keep_their_edges():
    """Two threads calling one GatedGCN deployment (its executor shared)
    on different graphs, with the interpreter switching threads as often
    as it can: each thread's answers equal one thread's bitwise (the
    cached (src, dst) of an edge list is per thread)."""
    _, tg = _gnn_graphs("gatedgcn")
    pipe = tdeploy(tg, TReq(**_req_kw(3)), device="cpu")
    feeds = [_edge_events(4, s, 8, 4) for s in (31, 32)]
    want = [pipe(f)["logits"].numpy() for f in feeds]
    got = [[], []]
    errors = []

    def work(i):
        try:
            for _ in range(6):
                got[i].append(pipe(feeds[i])["logits"].numpy())
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in threads)
    for i in range(2):
        assert len(got[i]) == 6
        for g in got[i]:
            assert_bitwise(g, want[i], context=f"thread {i}")


def test_concurrent_launch_counts_lose_no_addition():
    """Eight threads add launches while another saves and restores the
    counters under their lock, as a capture does: the totals are
    exact."""
    held = kops.launch_counts()
    kops.set_launch_counts({})
    delta = {"fused_dense_int8_cuda": 5, "gravnet_block_int8_cuda": 2,
             ("flash_attention_cuda", (128, 128)): 1}
    stop = threading.Event()

    def capture_like():
        while not stop.is_set():
            with kops.COUNTS_LOCK:
                before = kops.launch_counts()
                kops.add_launches({"fused_dense_cuda": 3})   # recorded
                kops.set_launch_counts(before)               # and undone

    def replays():
        for _ in range(500):
            kops.add_launches(delta)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        cap = threading.Thread(target=capture_like)
        cap.start()
        threads = [threading.Thread(target=replays) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        stop.set()
        cap.join(timeout=TIMEOUT)
        assert not cap.is_alive() and not any(t.is_alive() for t in threads)
        counts = kops.launch_counts()
        assert counts["fused_dense_int8_cuda"] == 8 * 500 * 5
        assert counts["gravnet_block_int8_cuda"] == 8 * 500 * 2
        assert counts[("flash_attention_cuda", (128, 128))] == 8 * 500
        assert counts["fused_dense_cuda"] == 0
    finally:
        sys.setswitchinterval(old)
        kops.set_launch_counts(held)


def test_replica_devices(monkeypatch):
    """One visible card (or none): thread-backed lanes on the pipeline's
    device. Several: replica i on card i modulo their count."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for count, want in ((0, [None] * 3), (1, [None] * 3),
                        (2, [torch.device(f"cuda:{i}") for i in (0, 1, 0)])):
        monkeypatch.setattr(torch.cuda, "device_count", lambda c=count: c)
        assert mesh.replica_devices(3) == want
