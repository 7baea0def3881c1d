"""The whole-pipeline compile of the port (kernel_opt's step 4 and the
executable's CUDA graphs) on the CPU: the ``fuse_pipeline`` flag of every
deployed graph equals the reference's; the capture class, driven through
a stand-in for ``torch.cuda``'s graphs, answers every chunk as the eager
``run_chunk`` loop does, bit for bit, keeps each chunk's outputs past the
next replay, drops its captures on ``calibrate``, captures a new feed
shape anew and counts the launches that replays run; and a deployment on
the CPU never captures and still matches the reference's jitted outputs.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _numerics import assert_bitwise, assert_close

from repro.core import caloclusternet as jccn
from repro.core.graph_ir import Graph as JGraph
from repro.core.graph_ir import Operator as JOperator
from repro.core.graph_ir import export_graph as jexport
from repro.core.passes.parallelize import Requirements as JReq
from repro.core.pipeline import deploy as jdeploy
from repro.data import belle2 as jbelle2
from repro.models.gnn import gatedgcn as jgatedgcn
from repro.models.gnn import graphsage as jgraphsage
from repro_torch.convert import from_jax_gnn_params, from_jax_params
from repro_torch.core import caloclusternet as tccn
from repro_torch.core import pipeline as tpipeline
from repro_torch.core.graph_ir import Graph, Operator, export_graph
from repro_torch.core.pipeline import QTensor
from repro_torch.core.pipeline import Requirements as TReq
from repro_torch.core.pipeline import deploy as tdeploy
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models.gnn import gatedgcn, graphsage

N_HITS = 32           # the current detector's readout


def _req_kw(dp, *, policy="fp", n=N_HITS):
    return dict(design_point=dp, platform="cpu", precision_policy=policy,
                n_hits=n, target_throughput=1e5, max_latency_s=2e-3)


@pytest.fixture(scope="module")
def ccn_graphs():
    jcfg = jccn.current_detector_config()
    tcfg = tccn.current_detector_config()
    params = jccn.init(jax.random.PRNGKey(3), jcfg)
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                              tcfg, device="cpu")
    return jccn.to_graph(params, jcfg), tccn.to_graph(tparams, tcfg)


def _events(n, seed):
    ev = jbelle2.generate(jbelle2.current_detector(), n, seed=seed)
    return {"hits": ev["feats"], "mask": ev["mask"]}


def _gnn_graphs(name):
    """The reference tests' small GatedGCN / GraphSAGE (N 32, 2 layers ×
    16) in both packages, from the JAX package's init."""
    if name == "gatedgcn":
        kw = dict(n_layers=2, d_hidden=16, d_in=8, d_edge_in=4, n_classes=4)
        jcfg, tcfg = jgatedgcn.GatedGCNConfig(**kw), \
            gatedgcn.GatedGCNConfig(**kw)
        jparams = jgatedgcn.init(jax.random.PRNGKey(1), jcfg)
    else:
        kw = dict(n_layers=2, d_hidden=16, d_in=12, n_classes=5)
        jcfg, tcfg = jgraphsage.GraphSAGEConfig(**kw), \
            graphsage.GraphSAGEConfig(**kw)
        jparams = jgraphsage.init(jax.random.PRNGKey(1), jcfg)
    tparams = from_jax_gnn_params(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    return (jexport(name, jparams, jcfg),
            export_graph(name, tparams, tcfg))


def _attention_graphs(n=16, d=8):
    """q, k, v denses of one token input and a causal ``attention`` op,
    in both packages from the same numpy weights."""
    rng = np.random.default_rng(0)
    ws = {nm: (rng.normal(size=(d, d)) * 0.3).astype(np.float32)
          for nm in ("q", "k", "v")}
    jg, tg = JGraph(), Graph()
    for g, op_cls, arr in ((jg, JOperator, jnp.asarray),
                           (tg, Operator, torch.from_numpy)):
        g.add(op_cls(name="tok", op_type="input", out_dim=d,
                     attrs={"feature": "tok"}))
        for nm in ("q", "k", "v"):
            g.add(op_cls(name=nm, op_type="linear", inputs=["tok"],
                         params={"w": arr(ws[nm]),
                                 "b": arr(np.zeros((d,), np.float32))},
                         out_dim=d))
        g.add(op_cls(name="attn", op_type="attention",
                     inputs=["q", "k", "v"], attrs={"causal": True},
                     out_dim=d))
        g.add(op_cls(name="out", op_type="output", inputs=["attn"],
                     attrs={"head_names": ["y"]}, out_dim=d))
        g.validate()
    return jg, tg


# (case id, deploy in both packages) -> the two deployments' graphs
FLAG_CASES = ["ccn-fp-dp1", "ccn-fp-dp2", "ccn-fp-dp3", "ccn-mixed-dp3",
              "ccn-mixed-dp3-no-fuse-int8", "ccn-ragged-dp3",
              "gatedgcn-dp3", "graphsage-dp3", "attention-dp3"]


@pytest.mark.parametrize("case", FLAG_CASES)
def test_fuse_pipeline_matches_reference(case, ccn_graphs):
    """kernel_opt's step 4: the port's deployed graph carries
    ``fuse_pipeline`` exactly where the reference's does (design point 3,
    every route), and the executable captures one graph per chunk there,
    one per segment elsewhere."""
    dp = int(case.split("-dp")[1][0])
    if case.startswith("ccn"):
        jg, tg = ccn_graphs
        policy = "mixed" if "mixed" in case else "fp"
        kw = dict(fuse_int8="no-fuse-int8" not in case)
        if policy == "mixed":
            kw["calibration_feeds"] = _events(16, 123)
        if "ragged" in case:
            kw.update(ragged=True, batch=2)
        jp = jdeploy(jg, JReq(**_req_kw(dp, policy=policy)), **kw)
        tp = tdeploy(tg, TReq(**_req_kw(dp, policy=policy)), device="cpu",
                     **kw)
        if "ragged" in case:
            jp, tp = jp.pipe, tp.pipe
    elif case.startswith("attention"):
        jg, tg = _attention_graphs()
        jp = jdeploy(jg, JReq(**_req_kw(dp, n=16)), batch=2)
        tp = tdeploy(tg, TReq(**_req_kw(dp, n=16)), batch=2, device="cpu")
    else:
        jg, tg = _gnn_graphs(case.split("-")[0])
        jp = jdeploy(jg, JReq(**_req_kw(dp)))
        tp = tdeploy(tg, TReq(**_req_kw(dp)), device="cpu")
    want = jp.graph.meta.get("fuse_pipeline")
    assert tp.graph.meta.get("fuse_pipeline") == want
    assert want == (True if dp == 3 else None)
    assert tp._fused == jp._fused == (dp == 3)


# ----------------------------------------------- the capture class on CPU ----
def _copy_into(dst, src):
    if isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    elif isinstance(dst, QTensor):
        dst.q.copy_(src.q)
    elif isinstance(dst, tuple):
        for d, s in zip(dst, src, strict=True):
            _copy_into(d, s)
    else:
        dst.copy_(src)


class FakeGraphs:
    """A stand-in for ``torch.cuda``'s graphs on the CPU. Capture records
    the callable and returns its first outputs as the static storage;
    replay re-runs the callable, copies its outputs into that same
    storage (so outputs that alias across replays would show), and, as
    a real replay calls no wrapper, leaves the launch counters as they
    were."""

    def __init__(self):
        self.captured = 0
        self.replayed = 0
        self.forks = []

    def fork(self):
        """A stand-in of its own for a lane (``Lane``), kept in
        ``forks``."""
        child = FakeGraphs()
        self.forks.append(child)
        return child

    @staticmethod
    def warmup(fn):
        return fn()

    def capture(self, fn, pool=None):
        self.captured += 1
        out = fn()
        return (fn, out), out

    @staticmethod
    def pool(graph):
        return id(graph)

    def replay(self, graph):
        fn, out = graph
        # the counters' lock is held across the re-run, so another lane's
        # replay in another thread adds nothing that the restore undoes
        with kops.COUNTS_LOCK:
            held = kops.launch_counts()
            _copy_into(out, fn())
            kops.set_launch_counts(held)
        self.replayed += 1


def _n_graphs(pipe):
    """Graphs one chunk replays: one under ``fuse_pipeline``, else one per
    segment that launches anything (an input-only one hands on its
    feeds)."""
    return 1 if pipe._fused else sum(not pipe._feeds_only(plan)
                                     for plan in pipe._plans)


def _inject(pipe):
    fake = FakeGraphs()
    pipe._graphs = tpipeline._ChunkGraphs(pipe, fake)
    return fake


# (case, deploy kwargs): the served default's fused graph (one capture a
# chunk) and design point 1's segments (one capture a segment), both at a
# micro-batch of 2 so that a call of 5 events pads its last chunk
CAPTURE_CASES = {"mixed-dp3": dict(policy="mixed", dp=3),
                 "fp-dp1": dict(policy="fp", dp=1)}


@pytest.fixture(params=sorted(CAPTURE_CASES))
def served(request, ccn_graphs):
    c = CAPTURE_CASES[request.param]
    _, tg = ccn_graphs
    kw = {"calibration_feeds": _events(16, 123)} \
        if c["policy"] == "mixed" else {}
    pipe = tdeploy(tg, TReq(**_req_kw(c["dp"], policy=c["policy"])),
                   batch=2, device="cpu", **kw)
    return request.param, pipe, kw


def _assert_same(got, want, context):
    if isinstance(want, dict):
        assert set(got) == set(want), context
        for k in want:
            _assert_same(got[k], want[k], f"{context}/{k}")
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, context
        assert_bitwise(got.numpy(), want.numpy(), context=context)


def test_captured_calls_equal_the_eager_chunk_loop(served):
    """B = 5 at micro-batch 2: the first call (its first chunk answered
    by the warm-up, then captured; the rest replayed) and a second call
    (every chunk replayed) equal the eager ``run_chunk`` loop bitwise on
    every output; a call's result survives the next call's replays."""
    name, pipe, _ = served
    assert pipe.microbatch == 2 and pipe._graphs is None   # eager on CPU
    feeds = _events(5, 11)
    want = pipe.run_eager(feeds)
    fake = _inject(pipe)
    first = pipe(feeds)
    n_graphs = _n_graphs(pipe)
    assert (fake.captured, fake.replayed) == (n_graphs, 2 * n_graphs)
    _assert_same(first, want, f"{name} first call")
    held = tpipeline._tree_map(torch.clone, first)
    other = _events(4, 12)
    second = pipe(other)
    assert fake.captured == n_graphs and fake.replayed == 4 * n_graphs
    _assert_same(second, pipe.run_eager(other), f"{name} replays only")
    _assert_same(first, held, f"{name} first call after the second")
    assert pipe.captures == 1


def test_chunk_outputs_survive_the_next_replay(served):
    """Two chunks of one call, both replays: the first chunk's outputs
    are copied out before the second replay overwrites the static
    storage, so the two chunks' answers differ where their events do."""
    name, pipe, _ = served
    _inject(pipe)
    pipe(_events(2, 13))                   # captured
    feeds = _events(4, 14)
    got = pipe(feeds)
    want = pipe.run_eager(feeds)
    _assert_same(got, want, name)
    assert not torch.equal(got["beta"][:2], got["beta"][2:])


def test_new_feed_shape_captures_anew(served):
    """Another feed signature (fewer hits per event) gets its own
    capture; each answers as the eager loop does."""
    name, pipe, _ = served
    fake = _inject(pipe)
    n_graphs = _n_graphs(pipe)
    full = _events(2, 15)
    cut = {k: v[:, :24] for k, v in _events(2, 16).items()}
    pipe(full)
    pipe(cut)
    assert pipe.captures == 2 and fake.captured == 2 * n_graphs
    for feeds in (full, cut, full):
        _assert_same(pipe(feeds), pipe.run_eager(feeds), name)
    assert fake.captured == 2 * n_graphs


def test_calibrate_drops_the_captures(served):
    """``calibrate`` rebakes scales and weights, so it drops every
    capture (the reference rebuilds its jitted executables); the next
    call captures again with the new constants."""
    name, pipe, kw = served
    fake = _inject(pipe)
    feeds = _events(2, 17)
    pipe(feeds)
    assert pipe.captures == 1
    pipe.calibrate(kw.get("calibration_feeds") or _events(16, 123))
    assert pipe.captures == 0
    _assert_same(pipe(feeds), pipe.run_eager(feeds), name)
    assert pipe.captures == 1
    assert fake.captured == 2 * _n_graphs(pipe)


_COUNTED = {"fused_dense_ref": "fused_dense_cuda",
            "fused_dense_int8_ref": "fused_dense_int8_cuda",
            "gravnet_aggregate_ref": "gravnet_aggregate_cuda",
            "gravnet_block_ref": "gravnet_block_cuda",
            "gravnet_block_int8_ref": "gravnet_block_int8_cuda"}


def test_replays_count_the_launches_they_run(served, monkeypatch):
    """A replay calls no wrapper, so the capture adds the launches it
    recorded on every replay: after a captured call the counters read
    what the eager loop's launches read, and a capture alone (whose
    launches do not run) adds none."""
    name, pipe, _ = served

    def counting(fn, wrapper):
        def call(*a, **kw):
            getattr(kops, wrapper).launches += 1
            return fn(*a, **kw)
        return call

    proxy = types.SimpleNamespace(**{n: getattr(kref, n) for n in dir(kref)
                                     if not n.startswith("__")})
    for n, w in _COUNTED.items():
        setattr(proxy, n, counting(getattr(kref, n), w))
    monkeypatch.setattr(kops, "_ref", proxy)
    feeds = _events(5, 18)
    kops.set_launch_counts({})
    pipe.run_eager(feeds)
    eager = kops.launch_counts()
    assert sum(eager.values()) > 0
    _inject(pipe)
    kops.set_launch_counts({})
    pipe(feeds)                 # warm-up chunk, capture, two replays
    assert kops.launch_counts() == eager
    kops.set_launch_counts({})
    pipe(feeds)                 # three replays
    assert kops.launch_counts() == eager
    kops.set_launch_counts({})


def test_ragged_launches_replay_one_capture(ccn_graphs):
    """The ragged path's inner executable launches a fixed layout of
    bins, so every launch replays one capture; the bin packing and the
    hand-off to numpy stay on the host, and the per-event results equal
    the eager launches' bitwise (CPS's leading axis is the launch's event
    capacity, not its bins)."""
    _, tg = ccn_graphs
    rp = tdeploy(tg, TReq(**_req_kw(3)), ragged=True, batch=2,
                 device="cpu")
    fake = _inject(rp.pipe)
    assert rp.warmup() == 1 and rp.captures == 1 and fake.captured == 1
    feeds = _events(7, 20)
    got, want = rp(feeds), rp.run_eager(feeds)
    assert fake.captured == 1 and fake.replayed >= 2
    for h in ("beta", "coords", "energy", "cls"):
        assert_bitwise(got[h], want[h], context=h)
    for k in want["cps"]:
        assert_bitwise(got["cps"][k], want["cps"][k], context=k)


@pytest.mark.parametrize("models", [("ccn",), ("gatedgcn", "graphsage")])
def test_serve_warm_up_captures_each_route(models, monkeypatch, capsys):
    """``serve.main``'s warm-up dispatch of each route captures every
    chunk shape its traffic takes, before the traffic; then each
    replica's lane captures those shapes for itself while the service is
    built. Under traffic each lane replays its own captures and captures
    nothing, the routes' own pipelines are not called, and the line
    printed before serving names one capture per lane."""
    from repro_torch.launch import serve
    fakes = []
    real_init = tpipeline.CompiledPipeline.__init__

    def init(self, *a, **kw):
        real_init(self, *a, **kw)
        fakes.append(_inject(self))

    calls = []
    real_submit = serve.submit_all

    def state():
        return [(f.captured, f.replayed) for f in fakes], [
            (c.captured, c.replayed) for f in fakes for c in f.forks]

    def submit_all(svc, feeds):
        before = state()
        out = real_submit(svc, feeds)
        calls.append((before, state()))
        return out

    monkeypatch.setattr(tpipeline.CompiledPipeline, "__init__", init)
    monkeypatch.setattr(serve, "submit_all", submit_all)
    assert serve.main(["--device", "cpu", "--detector", "current",
                       "--train-steps", "0", "--events", "8", "--replicas",
                       "2", "--model", *models]) == 0
    (parents0, lanes0), (parents1, lanes1) = calls[-1]   # the traffic
    assert len(fakes) == len(models) and len(lanes0) == 2 * len(models)
    assert parents0 == parents1 and all(c >= 1 for c, _ in parents0)
    for (c0, r0), (c1, r1) in zip(lanes0, lanes1, strict=True):
        assert c0 == c1 == 1 and r1 > r0
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines()
                if "lanes captured before traffic" in ln)
    assert line.endswith(", ".join(f"replica {i} 1"
                                   for i in range(2 * len(models))))
    assert "lanes captured during traffic: 0" in out


# --------------------------------------------- the CPU deploys eagerly ----
@pytest.mark.parametrize("dp", [1, 3])
def test_cpu_deployment_never_captures(dp, ccn_graphs, monkeypatch):
    """``deploy(device="cpu")`` runs eagerly: with ``torch.cuda``'s graph
    capture made to raise it still answers, captures nothing, and its
    outputs equal the reference's jitted executable (whole-graph at
    design point 3, per segment at 1): heads and CPS floats within the
    float32 row, CPS's integer outputs bitwise."""
    def refuse(*a, **kw):
        raise AssertionError("a CPU deployment tried to capture")

    monkeypatch.setattr(torch.cuda, "graph", refuse)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", refuse)
    jg, tg = ccn_graphs
    jp = jdeploy(jg, JReq(**_req_kw(dp)))
    tp = tdeploy(tg, TReq(**_req_kw(dp)), device="cpu")
    feeds = _events(8, 19)
    got = tp(feeds)
    assert tp.captures == 0 and tp._graphs is None
    want = jax.tree_util.tree_map(np.asarray, jp(feeds))
    for h in ("beta", "coords", "energy", "cls"):
        assert_close(got[h].numpy(), want[h], dtype="float32", context=h)
    for k in ("n_clusters", "trigger", "cluster_valid"):
        assert_bitwise(got["cps"][k].numpy(), want["cps"][k], context=k)
    for k in ("cluster_xy", "cluster_e", "cluster_beta"):
        assert_close(got["cps"][k].numpy(), want["cps"][k],
                     dtype="float32", context=k)
