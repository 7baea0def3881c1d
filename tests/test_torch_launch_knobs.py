"""The port's launch knobs on the CPU: every kernel's plan as a knob, from
the tuning cache down to the wrapper (``kernels/*.py``'s plan functions,
``kernels/ops.py``, ``core/pipeline.py``'s executor,
``core/op_registry.py``'s binders, ``tuning/``).

Each family's candidate list starts with the plan its wrapper picks with
no knob, at the served paths' launch shapes, and holds every plan of the
source that runs the shape once; ``ops`` refuses a knob the kernel
cannot run on either device; the executor hands a deployment's bound
knobs to the ``ops`` entry points and an untuned deployment hands none;
a tuned deployment serves bitwise with the untuned one and within the
JAX package's ``float32`` row (``int8_flip_tolerance`` under mixed); a
``"cuda"`` entry that is no candidate binds nothing; the tuner times
every candidate on the card's clock (a stand-in timer here) and the
warm-up replays every family's knobs. Knobs are compared exactly.
"""
import jax
import numpy as np
import pytest
import torch
from _numerics import (assert_bitwise, assert_calibration_close,
                       assert_close, int8_flip_tolerance)

from repro.core import caloclusternet as jccn
from repro.core.passes.parallelize import Requirements as JReq
from repro.core.pipeline import deploy as jdeploy
from repro.data import belle2 as jbelle2
from repro_torch.convert import from_jax_params
from repro_torch.core import caloclusternet as tccn
from repro_torch.core.op_registry import tuning_candidates, tuning_problem
from repro_torch.core.passes.kernel_opt import kernel_optimize
from repro_torch.core.pipeline import Requirements as TReq
from repro_torch.core.pipeline import deploy as tdeploy
from repro_torch.kernels import _build, ops
from repro_torch.kernels import edge_aggregate as edge
from repro_torch.kernels import fused_dense as fd
from repro_torch.kernels import gravnet as gn
from repro_torch.kernels import gravnet_block as gb
from repro_torch.kernels import knn_build as kb
from repro_torch.launch import serve
from repro_torch.tuning import TuningCache, autotune, warm_from_cache
from repro_torch.tuning import cache as tcache
from repro_torch.tuning import candidates as cand

# ------------------------------------------------------------ the families --
# family -> (its candidates, the plan its wrapper picks with no knob, the
# wrapper's own checks of one candidate) over the launch shape's args


def _dense_check(m, k, n, c):
    v = fd.variant_of(m, n, **c)
    assert fd.smem_bytes(v, k) <= _build.SMEM_LIMIT


def _gravnet_check(b, n, ds, df, c):
    bm, cell = gn.plan(n, b, df, **c)
    assert bm == c["bm"] and (cell == "shared" or bm <= gn.MAX_ROWS)
    assert gn.smem_bytes(n, ds, df) <= _build.SMEM_LIMIT


def _block_check(b, n, dh, ds, df, do, c):
    bm, cell = gb.plan(n, dh, ds, df, do, True, **c)
    assert bm == c["bm"] and (cell == "shared" or bm <= gb.BM)
    assert gb.smem_bytes(n, dh, ds, df, do, bm, cell) <= _build.SMEM_LIMIT


def _int8_block_check(b, n, dh, ds, df, do, c):
    assert gb.int8_plan(n, dh, ds, df, do, True, **c) == c["bm"] <= 16
    assert gb.int8_smem_bytes(n, dh, ds, df, do, c["bm"]) <= \
        _build.SMEM_LIMIT


def _knn_build_check(b, n, ds, c):
    bm, cell = kb.build_plan(n, b, **c)
    assert bm == c["bm"] and (cell == "shared" or bm <= gn.MAX_ROWS)
    assert kb.build_smem_bytes(n, ds) <= _build.SMEM_LIMIT


def _knn_agg_check(b, n, df, c):
    bm, cell = kb.aggregate_plan(n, b, df, **c)
    assert bm == c["bm"] and (cell == "shared" or bm <= gn.MAX_ROWS)
    assert kb.aggregate_smem_bytes(n, df) <= _build.SMEM_LIMIT


def _ragged_block_check(b, n, ds, df, c):
    _knn_build_check(b, n, ds, c)
    _knn_agg_check(b, n, df, c)


def _edge_check(b, n, e, d, c):
    bm, cw = edge.plan(n, d, b, **c)
    assert (bm, cw) == (c["bm"], c["bn"]) and bm <= edge.BM
    assert cw % 2 == 0 or d % 2
    ec = min(e, edge.max_edges())
    assert edge.smem_bytes(ec, cw, edge.staged(ec, cw)) <= _build.SMEM_LIMIT


FAMILIES = {
    "fused_dense": (
        lambda m, k, n: cand.fused_dense_candidates(m, k, n),
        lambda m, k, n: dict(zip(("bm", "bn"),
                                 fd.tile(fd.variant_of(m, n)))),
        _dense_check),
    "fused_dense_int8": (
        lambda m, k, n: cand.fused_dense_int8_candidates(m, k, n),
        lambda m, k, n: dict(zip(("bm", "bn"),
                                 fd.INT8_TILES[fd.int8_tile_of()])),
        lambda m, k, n, c: fd.int8_tile_of(**c)),
    "gravnet": (
        lambda b, n, ds, df: cand.gravnet_candidates(n, batch=b, d_f=df),
        lambda b, n, ds, df: {"bm": gn.plan(n, b, df)[0]},
        _gravnet_check),
    "gravnet_block": (
        lambda b, n, dh, ds, df, do: cand.gravnet_block_candidates(
            n, dh, df, do, d_s=ds, batch=b),
        lambda b, n, dh, ds, df, do: {"bm": gb.plan(n, dh, ds, df, do)[0]},
        _block_check),
    "gravnet_block_int8": (
        lambda b, n, dh, ds, df, do: cand.gravnet_block_int8_candidates(
            n, dh, df, do, d_s=ds, batch=b),
        lambda b, n, dh, ds, df, do: {"bm": gb.int8_plan(n, dh, ds, df,
                                                         do)},
        _int8_block_check),
    "gravnet_block_ragged": (
        lambda b, n, ds, df: cand.gravnet_block_ragged_candidates(
            n, batch=b, d_f=df),
        # the kNN pair at no knob: both pick the same rows here
        lambda b, n, ds, df: {"bm": kb.build_plan(n, b)[0]},
        _ragged_block_check),
    "knn_build": (
        lambda b, n, ds: cand.knn_build_candidates(n, batch=b),
        lambda b, n, ds: {"bm": kb.build_plan(n, b)[0]},
        _knn_build_check),
    "knn_aggregate": (
        lambda b, n, df: cand.knn_aggregate_candidates(n, batch=b, d_f=df),
        lambda b, n, df: {"bm": kb.aggregate_plan(n, b, df)[0]},
        _knn_agg_check),
    "edge_aggregate": (
        lambda b, n, e, d: cand.edge_aggregate_candidates(n, e, d=d,
                                                          batch=b),
        lambda b, n, e, d: dict(zip(("bm", "bn"), edge.plan(n, d, b))),
        _edge_check),
}

# the launch shapes of the served paths: the mixed and fp chunks of 2 x
# 128 hits, the current detector's 8 x 32, the ragged 8 bins of 128,
# GatedGCN (1, 256, 70), GraphSAGE (8, 256, 16 and 128), the attention
# dense (4096, 64) -> 192, and the GravNet inputs past the register cell
# (kernels/f32_cases.py's: 600 hits at the smoke widths; d_f 129).
# Denses: (rows, K, N); GravNet (events, n, ...).
PATH_SHAPES = [
    *(("fused_dense", s) for s in (
        (256, 4, 64), (256, 64, 64), (256, 64, 32), (256, 32, 7),
        (1024, 4, 64), (1024, 64, 4), (1024, 64, 22), (1024, 108, 64),
        (1024, 32, 7), (256, 70, 70), (256, 70, 140), (64, 70, 70),
        (64, 8, 70), (64, 70, 2), (512, 32, 128), (512, 256, 128),
        (512, 128, 5), (4096, 64, 192))),
    *(("fused_dense_int8", s) for s in (
        (256, 4, 64), (256, 64, 64), (256, 64, 32), (256, 32, 7))),
    *(("gravnet", s) for s in ((1, 128, 4, 22), (2, 128, 4, 22),
                               (8, 32, 4, 22), (1, 600, 3, 8),
                               (2, 64, 4, 129))),
    *(("gravnet_block", s) for s in ((2, 128, 64, 4, 22, 64),
                                     (8, 32, 64, 4, 22, 64),
                                     (1, 600, 24, 3, 8, 24),
                                     (2, 64, 32, 4, 129, 32))),
    *(("gravnet_block_int8", s) for s in ((2, 128, 64, 4, 22, 64),
                                          (8, 32, 64, 4, 22, 64))),
    ("gravnet_block_ragged", (8, 128, 4, 22)),
    ("knn_build", (8, 128, 4)), ("knn_build", (1, 600, 3)),
    ("knn_aggregate", (8, 128, 22)), ("knn_aggregate", (1, 128, 129)),
    *(("edge_aggregate", s) for s in ((1, 64, 256, 70), (8, 64, 256, 16),
                                      (8, 64, 256, 128), (1, 600, 1000, 129),
                                      (1, 5, 40, 6))),
]
_IDS = [f"{f}-{'x'.join(map(str, s))}" for f, s in PATH_SHAPES]


@pytest.mark.parametrize("family,shape", PATH_SHAPES, ids=_IDS)
def test_list_starts_with_the_wrappers_plan(family, shape):
    """Exact: candidates[0] is the plan the wrapper's own plan function
    picks with no knob at this launch shape."""
    cands, plan, _ = FAMILIES[family]
    assert cands(*shape)[0] == plan(*shape)


@pytest.mark.parametrize("family,shape", PATH_SHAPES, ids=_IDS)
def test_list_holds_every_runnable_plan_once(family, shape):
    """Exact: no duplicate; every candidate passes the wrapper's own
    checks (its rows within the cell, its shared memory within
    ``_build.SMEM_LIMIT``); the rows families list every row count of
    their cell cut to n."""
    cands, _, check = FAMILIES[family]
    got = cands(*shape)
    assert len({tuple(sorted(c.items())) for c in got}) == len(got)
    for c in got:
        check(*shape, c)
    if family in ("gravnet", "knn_build", "knn_aggregate",
                  "gravnet_block_int8"):
        n = shape[1]
        cell = {"gravnet": lambda: gn.plan(n, 1, shape[-1])[1],
                "knn_build": lambda: kb.build_plan(n)[1],
                "knn_aggregate": lambda: kb.aggregate_plan(
                    n, 1, shape[-1])[1],
                "gravnet_block_int8": lambda: "register"}[family]()
        assert {c["bm"] for c in got} == {min(r, n) for r in
                                          cand.ROWS[cell]}
    if family == "fused_dense":
        assert len(got) == len(fd.TILES)
    if family == "fused_dense_int8":
        assert [(c["bm"], c["bn"]) for c in got] == list(fd.INT8_TILES)


# ------------------------------------------------------- ops refuses ------
def _t(*shape, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.int8:
        return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
    return torch.randn(*shape, generator=g, dtype=dtype)


def _block_args(n=32, dh=16, ds=4, df=8, do=16, b=1, int8=False):
    dt = torch.int8 if int8 else torch.float32
    ws = (_t(dh, ds, dtype=dt), _t(ds), _t(dh, df, dtype=dt), _t(df),
          _t(dh + 2 * df, do, dtype=dt), _t(do))
    scales = (torch.full((ds,), 0.01), torch.full((df,), 0.01),
              torch.full((do,), 0.01)) if int8 else ()
    return (_t(b, n, dh), torch.ones(b, n), *ws, *scales)


_I8KW = dict(x_scale=0.02, agg_scale=0.01, h_scale=0.02, k=4)
BAD_KNOBS = {
    "dense not a tile": lambda: ops.fused_dense(_t(8, 4), _t(4, 6),
                                                bm=8, bn=128),
    "dense half a tile": lambda: ops.fused_dense(_t(8, 4), _t(4, 6), bm=16),
    "dense batched not a tile": lambda: ops.fused_dense_batched(
        _t(2, 8, 4), _t(4, 6), bm=64, bn=8),
    "int8 dense not a tile": lambda: ops.fused_dense_int8(
        _t(8, 4, dtype=torch.int8), _t(4, 6, dtype=torch.int8), None, 0.1,
        torch.ones(6), bm=128, bn=128),
    "gravnet rows past the register cell": lambda: ops.gravnet_aggregate(
        _t(32, 4), _t(32, 8), torch.ones(32), k=4, bm=32),
    "gravnet no rows": lambda: ops.gravnet_aggregate(
        _t(32, 4), _t(32, 8), torch.ones(32), k=4, bm=0),
    "gravnet rows not an int": lambda: ops.gravnet_aggregate(
        _t(32, 4), _t(32, 8), torch.ones(32), k=4, bm=4.5),
    "knn build rows past the register cell": lambda: ops.knn_build(
        _t(32, 4), torch.zeros(32, dtype=torch.int32), k=4, bm=17),
    "knn aggregate rows past the register path": lambda: ops.knn_aggregate(
        _t(32, 8), torch.zeros(32, 4, dtype=torch.int32), torch.ones(32, 4),
        bm=128),
    "block rows past the register cell": lambda: ops.gravnet_block(
        *[a[0] if i < 2 else a for i, a in enumerate(_block_args())], k=4,
        bm=32),
    "int8 block rows past its tile": lambda: ops.gravnet_block_int8(
        *[a[0] if i < 2 else a
          for i, a in enumerate(_block_args(int8=True))], bm=17, **_I8KW),
    "ragged block rows past the register cell":
        lambda: ops.gravnet_block_ragged(
            _t(1, 32, 16), torch.zeros(1, 32, dtype=torch.int32),
            *_block_args()[2:], k=4, bm=64),
    "edge rows past the kernel's 64": lambda: ops.edge_aggregate(
        _t(40, 6), torch.zeros(2, 40, dtype=torch.int32), 5, bm=128),
    "edge odd columns at an even d": lambda: ops.edge_aggregate(
        _t(40, 6), torch.zeros(2, 40, dtype=torch.int32), 5, bm=8, bn=3),
    "edge no columns": lambda: ops.edge_aggregate(
        _t(40, 7), torch.zeros(2, 40, dtype=torch.int32), 5, bn=0),
}


@pytest.mark.parametrize("kind", sorted(BAD_KNOBS))
def test_ops_refuses_a_knob_the_kernel_cannot_run(kind):
    """A knob the CUDA source could not run raises ``ValueError`` on CPU
    tensors too, before the plain version runs: nothing re-plans."""
    with pytest.raises(ValueError):
        BAD_KNOBS[kind]()


GOOD_CALLS = {
    "fused_dense": (lambda **kw: ops.fused_dense(_t(40, 12), _t(12, 20),
                                                 _t(20), **kw),
                    cand.fused_dense_candidates(40, 12, 20)),
    "fused_dense_int8": (lambda **kw: ops.fused_dense_int8(
        _t(40, 12, dtype=torch.int8), _t(12, 20, dtype=torch.int8), _t(20),
        0.02, torch.full((20,), 0.01), **kw),
        cand.fused_dense_int8_candidates(40, 12, 20)),
    "gravnet": (lambda **kw: ops.gravnet_aggregate_batched(
        _t(2, 32, 4), _t(2, 32, 8), torch.ones(2, 32), k=4, **kw),
        cand.gravnet_candidates(32, batch=2, d_f=8)),
    "gravnet_block": (lambda **kw: ops.gravnet_block_batched(
        *_block_args(b=2), k=4, **kw),
        cand.gravnet_block_candidates(32, 16, 8, 16, d_s=4, batch=2)),
    "gravnet_block_int8": (lambda **kw: ops.gravnet_block_int8_batched(
        *_block_args(b=2, int8=True), **_I8KW, **kw),
        cand.gravnet_block_int8_candidates(32, 16, 8, 16, d_s=4, batch=2)),
    "knn": (lambda **kw: ops.knn_aggregate_batched(
        _t(2, 32, 8), *ops.knn_build_batched(
            _t(2, 32, 4, seed=1), torch.zeros(2, 32, dtype=torch.int32),
            k=4, **kw), **kw),
        cand.gravnet_block_ragged_candidates(32, batch=2, d_f=8)),
    "edge_aggregate": (lambda **kw: ops.edge_aggregate_batched(
        _t(2, 60, 20), torch.randint(0, 40, (2, 2, 60),
                                     generator=torch.Generator().manual_seed(
                                         3), dtype=torch.int32), 40,
        reduce="mean", **kw),
        cand.edge_aggregate_candidates(40, 60, d=20, batch=2)),
}


@pytest.mark.parametrize("family", sorted(GOOD_CALLS))
def test_ops_takes_every_candidate_on_the_cpu(family):
    """Bitwise: on the CPU the plain versions take every candidate and
    ignore it (what the kernel computes does not depend on it either)."""
    call, cands = GOOD_CALLS[family]
    assert len(cands) > 1
    want = call()
    for c in cands:
        got = call(**c)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert_bitwise(g.numpy(), w.numpy(), context=str(c))


# ---------------------------------------------- the executor hands on -----
#: the ops entry points the executor calls, by the tuning family whose
#: knobs they take (an int8-keyed dense runs the int8 kernel)
ENTRY_FAMILY = {"fused_dense": "dense", "fused_dense_batched": "dense",
                "fused_dense_int8": "dense_int8",
                "gravnet_aggregate_batched": "gravnet",
                "gravnet_block_batched": "gravnet_block",
                "gravnet_block_ragged": "gravnet_block",
                "gravnet_block_int8_batched": "gravnet_block_int8",
                "knn_build_batched": "knn_build",
                "knn_aggregate_batched": "knn_aggregate",
                "edge_aggregate_batched": "edge_aggregate"}


def _key_family(key):
    if key.kernel == "fused_dense":
        return "dense_int8" if key.dtype == "int8" else "dense"
    return key.kernel


def _spy_entries(monkeypatch):
    """Record (family, knobs) of every top-level call of an ops entry
    point (the calls one makes inside another are not the executor's)."""
    seen, depth = [], [0]

    def wrap(name, real):
        def call(*a, **kw):
            if not depth[0]:
                seen.append((ENTRY_FAMILY[name], tuple(sorted(
                    (k, v) for k, v in kw.items()
                    if k in ("bm", "bn") and v is not None))))
            depth[0] += 1
            try:
                return real(*a, **kw)
            finally:
                depth[0] -= 1
        return call
    for name in ENTRY_FAMILY:
        monkeypatch.setattr(ops, name, wrap(name, getattr(ops, name)))
    return seen


DEPLOYMENTS = {
    "ccn mixed": dict(precision="mixed"),
    "ccn fp": dict(precision="fp"),
    "ccn mixed unfused": dict(precision="mixed", fuse_int8=False),
    "ccn ragged": dict(precision="fp", ragged=True, batch=4),
    "ccn ragged unfused": dict(precision="fp", ragged=True, batch=4,
                               fuse_gravnet_block=False),
    "gatedgcn": ["--model", "gatedgcn"],
    "graphsage": ["--model", "graphsage"],
}
#: 8 events of the current detector (32 hits), seed 5: the calibration
#: batch and the served events of the CaloClusterNet deployments
_EV = jbelle2.generate(jbelle2.current_detector(), 8, seed=5)
_FEEDS = {"hits": _EV["feats"], "mask": _EV["mask"]}


def _deploy(name, cache=None):
    """(callable, feeds, pipeline, batch) of a CPU deployment at design
    point 3: CaloClusterNet at the current detector's 32 hits (random
    weights of seed 0, calibrated on the served events), its ragged fp
    path of 4 bins, or the serve routes' GNNs at their default widths."""
    kw = DEPLOYMENTS[name]
    if name.startswith("ccn"):
        tcfg = tccn.CCNConfig(n_hits=32)
        g = tccn.to_graph(tccn.init(torch.Generator().manual_seed(0),
                                    tcfg), tcfg)
        req = TReq(design_point=3, platform="cpu",
                   precision_policy=kw["precision"], n_hits=32,
                   target_throughput=5e4, max_latency_s=2e-3)
        pipe = tdeploy(g, req, device="cpu", tuning_cache=cache,
                       calibration_feeds=_FEEDS, fuse_int8=kw.get(
                           "fuse_int8", True),
                       fuse_gravnet_block=kw.get("fuse_gravnet_block", True),
                       ragged=kw.get("ragged", False),
                       batch=kw.get("batch", 1))
        inner = pipe.pipe if kw.get("ragged") else pipe
        return pipe, _FEEDS, inner, kw.get("batch", 1)
    args = serve.parse_args(["--device", "cpu", *kw])
    sv = serve.MODELS[args.model[0]](args, None, tuning_cache=cache)
    return sv.pipe, sv.events(sv.pipe.microbatch, 5)[0], sv.pipe, 1


def _tuned_cache(pipe, batch):
    """A "cpu" cache holding, for every problem of ``pipe``'s graph, the
    last of its family's candidates (a plan other than the default
    wherever the family has one) — and those knobs by family."""
    g, n = pipe.graph, pipe.graph.meta["n_hits"]
    cache, want = TuningCache(), {}
    for op in g:
        key = tuning_problem(op, n_rows=n, backend="cpu", batch=batch)
        if key is None or key in cache:
            continue
        c = tuning_candidates(op, n_rows=n, batch=batch)[-1]
        cache.put(key, c)
        want.setdefault(_key_family(key), set()).add(tuple(sorted(
            (k, v) for k, v in c.items() if k in ("bm", "bn"))))
    return cache, want


@pytest.mark.parametrize("name", sorted(DEPLOYMENTS))
def test_executor_hands_on_the_bound_knobs(name, monkeypatch):
    """Exact: an untuned deployment hands no knob to any ops entry
    point, not even a dense's heuristic blocks (here the reference's
    looped (128, 128, 512), which no kernel tile would take); a tuned one
    hands each kernel family exactly the cached knobs of its
    problems."""
    run, feeds, pipe, batch = _deploy(name)
    for op in pipe.graph:
        if op.template == "fused_dense":
            op.attrs_opt.update(variant="looped", bm=128, bn=128, bk=512)
    seen = _spy_entries(monkeypatch)
    run(feeds)
    assert seen and all(k == () for _, k in seen), seen
    cache, want = _tuned_cache(pipe, batch)
    trun, _, tpipe, _ = _deploy(name, cache)
    seen.clear()
    trun(feeds)
    got = {}
    for fam, k in seen:
        got.setdefault(fam, set()).add(k)
    assert got == want


def _reference_ccn():
    """CaloClusterNet at the current detector's 32 hits, the same
    weights in both packages (the served events are the calibration
    batch)."""
    jcfg, tcfg = jccn.CCNConfig(n_hits=32), tccn.CCNConfig(n_hits=32)
    params = jccn.init(jax.random.PRNGKey(3), jcfg)
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                              tcfg, device="cpu")
    return (jccn.to_graph(params, jcfg), tccn.to_graph(tparams, tcfg),
            _FEEDS)


@pytest.mark.parametrize("policy", ["fp", "mixed"])
def test_tuned_deployment_serves_bitwise_with_the_untuned(policy):
    """Bitwise: a deployment whose every problem binds a non-default
    candidate serves the untuned deployment's heads and CPS outputs;
    both within the JAX package's float32 row (under mixed, of
    ``int8_flip_tolerance``, 4 flips) and its CPS bitwise."""
    jg, tg, feeds = _reference_ccn()
    kw = dict(design_point=3, platform="cpu", precision_policy=policy,
              n_hits=32, target_throughput=1e5, max_latency_s=2e-3)
    ckw = {"calibration_feeds": feeds} if policy == "mixed" else {}
    base = tdeploy(tg, TReq(**kw), device="cpu", **ckw)
    cache, _ = _tuned_cache(base, 1)
    tuned = tdeploy(tg, TReq(**kw), device="cpu", tuning_cache=cache, **ckw)
    assert any(op.attrs_opt.get("tuned") for op in tuned.graph)
    want = jax.tree_util.tree_map(np.asarray, jdeploy(
        jg, JReq(**kw), kernel_backend="xla", **ckw)(feeds))
    got, untuned = tuned(feeds), base(feeds)
    blocks = [op for op in tuned.graph if op.op_type == "gravnet_block"]
    for h in ("beta", "coords", "energy", "cls"):
        assert_bitwise(got[h].numpy(), untuned[h].numpy(), context=h)
        if policy == "fp":
            assert_close(got[h].numpy(), want[h], dtype="float32",
                         context=h)
        else:
            assert_calibration_close(got[h].numpy(), want[h], quantum=max(
                int8_flip_tolerance(b.attrs["h_scale"],
                                    b.params["wo_scale"].numpy(), flips=4)
                for b in blocks), context=h)
    for k in ("n_clusters", "trigger", "cluster_valid"):
        assert_bitwise(got["cps"][k].numpy(), untuned["cps"][k].numpy())
        assert_bitwise(got["cps"][k].numpy(), want["cps"][k], context=k)


# ------------------------------------------------------ the stale cache ----
def test_stale_cuda_entries_bind_nothing_and_warn():
    """Exact: on "cuda" keys the caches written before these knobs (a
    block's {"bm": 128}, the dense's reference blocks) bind
    nothing, once warned of per key; an entry among the candidates
    binds; "cpu" keys bind as the reference's do."""
    _, _, pipe, _ = _deploy("ccn fp")
    g, n = pipe.graph, pipe.graph.meta["n_hits"]

    def bound(cache, backend="cuda"):
        return [(op.name, sorted(op.attrs_opt.items())) for op in
                kernel_optimize(g, n_rows=n, tuning_cache=cache,
                                backend=backend)]
    stale, keys = TuningCache(), {}
    for op in g:
        key = tuning_problem(op, n_rows=n, backend="cuda")
        if key is not None:
            keys[key.kernel] = key
            stale.put(key, {"bm": 128} if key.kernel.startswith(
                "gravnet") else {"variant": "looped", "bm": 128,
                                 "bn": 128, "bk": 512})
    assert set(keys) == {"fused_dense", "gravnet_block"}
    with pytest.warns(RuntimeWarning, match="binds nothing") as rec:
        assert bound(stale) == bound(None)
    assert len(rec) == len(stale)
    good = TuningCache()
    good.put(keys["gravnet_block"], {"bm": 4})
    blocks = [b for _, b in bound(good) if ("bm", 4) in b]
    assert len(blocks) == 2
    cpu = TuningCache()
    for key in stale.entries():
        cpu.put(tcache.KernelKey(key.kernel, key.shape, key.dtype, "cpu"),
                stale.lookup(key))
    assert bound(cpu, "cpu") != bound(None, "cpu")


# ----------------------------------------------------- the search ---------
#: a small problem of each family: (tune_* function, args, its key's
#: candidates)
SEARCHES = {
    "fused_dense": ("tune_fused_dense", (64, 16, 24), {},
                    cand.fused_dense_candidates(64, 16, 24)),
    "fused_dense_int8": ("tune_fused_dense", (64, 16, 24),
                         {"dtype": "int8"},
                         cand.fused_dense_int8_candidates(64, 16, 24)),
    "gravnet": ("tune_gravnet", (32, 4, 8, 4), {"events": 2},
                cand.gravnet_candidates(32, batch=2, d_f=8)),
    "gravnet_block": ("tune_gravnet_block", (32, 16, 4, 8, 16, 4), {},
                      cand.gravnet_block_candidates(32, 16, 8, 16, d_s=4)),
    "gravnet_block_int8": ("tune_gravnet_block", (32, 16, 4, 8, 16, 4),
                           {"dtype": "int8"},
                           cand.gravnet_block_int8_candidates(32, 16, 8, 16,
                                                              d_s=4)),
    "gravnet_block_ragged": ("tune_gravnet_block", (32, 16, 4, 8, 16, 4),
                             {"batch": 2, "ragged": True},
                             cand.gravnet_block_ragged_candidates(
                                 32, batch=2, d_f=8)),
    "edge_aggregate": ("tune_edge_aggregate", (40, 60, 20), {"batch": 2},
                       cand.edge_aggregate_candidates(40, 60, d=20,
                                                      batch=2)),
    "knn_build": ("tune_knn_build", (32, 4, 4), {"batch": 2},
                  cand.knn_build_candidates(32, batch=2)),
    "knn_aggregate": ("tune_knn_aggregate", (32, 8, 4), {"batch": 2},
                      cand.knn_aggregate_candidates(32, batch=2, d_f=8)),
}


@pytest.mark.parametrize("wins", [False, True], ids=["near", "wins"])
@pytest.mark.parametrize("family", sorted(SEARCHES))
def test_cuda_search_times_every_candidate(family, wins, monkeypatch):
    """On "cuda" the tuner hands every candidate, in order, through the
    ops entry point and times it on the device timer (a stand-in here,
    as in test_torch_tuning.py's clock test, on CPU tensors); the
    default stays unless a candidate wins by more than ``MIN_GAIN``:
    2 % faster keeps it, 10 % faster binds the last candidate."""
    fn, args, kw, cands = SEARCHES[family]
    assert len(cands) > 1
    handed, timed = [], []
    real = ops._check_knobs

    def check(plan, *a, **knobs):
        knobs_ = {k: v for k, v in knobs.items() if v is not None}
        if knobs_:
            handed.append(knobs_)
        return real(plan, *a, **knobs)

    def device(call, *, iters):
        call()
        timed.append(call)
        n = len(timed)
        if n == 1:
            return 40e-6
        return 36e-6 if wins and n == len(cands) else 39.2e-6

    monkeypatch.setattr(ops, "_check_knobs", check)
    monkeypatch.setattr(autotune, "_device_time_call", device)
    monkeypatch.setattr(autotune, "_time_call", None)   # never the host's
    monkeypatch.setattr(autotune, "device_of", lambda be: torch.device(
        "cpu"))
    cache = TuningCache()
    best = getattr(autotune, fn)(*args, backend="cuda", cache=cache, **kw)
    # the ragged chain checks its kNN pair's knob twice a call
    per = 2 if family == "gravnet_block_ragged" else 1
    assert handed[::per] == cands and len(timed) == len(cands)
    assert best == (cands[-1] if wins else cands[0])
    (entry,) = cache.entries().values()
    assert entry.candidates == len(cands)
    assert {k: entry.config[k] for k in best} == best


def test_autotune_graph_times_at_the_launch_events(monkeypatch):
    """GraphSAGE's edge problems key one graph (the reference's key) but
    launch over the segment's P graphs: the tuner draws them at P and
    its default is the plan the wrapper picks there."""
    _, _, pipe, _ = _deploy("graphsage")
    g = pipe.graph
    p = max(op.attrs_opt.get("P", 1) for op in g
            if op.op_type == "edge_aggregate")
    assert p == pipe.microbatch > 1
    seen = []
    real = ops.edge_aggregate_batched

    def spy(msgs, *a, **kw):
        seen.append((msgs.shape[0], kw.get("bm"), kw.get("bn")))
        return real(msgs, *a, **kw)
    monkeypatch.setattr(ops, "edge_aggregate_batched", spy)
    cache = TuningCache()
    autotune.autotune_graph(g, n_rows=g.meta["n_hits"], backend="cpu",
                            cache=cache, iters=1)
    edges = [k for k in cache.entries() if k.kernel == "edge_aggregate"]
    assert edges and all(len(k.shape) == 3 for k in edges)
    n = g.meta["n_hits"]
    assert {s[0] for s in seen} == {p}
    for k in edges:
        cfg = cache.lookup(k)
        assert (cfg["bm"], cfg["bn"]) == edge.plan(n, k.shape[2], p)


def test_warm_from_cache_replays_every_familys_knobs(monkeypatch):
    """Exact: warm-up hands each cached entry's knobs to its ops entry
    point (and the replay dims only to the problem)."""
    handed = []
    real = ops._check_knobs

    def check(plan, *a, **knobs):
        knobs_ = {k: v for k, v in knobs.items() if v is not None}
        if knobs_:
            handed.append(knobs_)
        return real(plan, *a, **knobs)

    monkeypatch.setattr(ops, "_check_knobs", check)
    cache, want = TuningCache(), []
    for name, (fn, args, kw, cands) in SEARCHES.items():
        if name == "gravnet_block_ragged":
            continue
        key = {"tune_fused_dense": lambda: tcache.fused_dense_key(
                   *args, kw.get("dtype", "float32"), "cpu"),
               "tune_gravnet": lambda: tcache.gravnet_key(
                   *args, "float32", "cpu"),
               "tune_gravnet_block": lambda: (
                   tcache.gravnet_block_int8_key(
                       32, 16, 8, 4, "cpu") if kw.get("dtype") == "int8"
                   else tcache.gravnet_block_key(32, 16, 8, 4, "float32",
                                                 "cpu")),
               "tune_edge_aggregate": lambda: tcache.edge_aggregate_key(
                   *args, "float32", "cpu", batch=2),
               "tune_knn_build": lambda: tcache.knn_build_key(
                   *args, "float32", "cpu", batch=2),
               "tune_knn_aggregate": lambda: tcache.knn_aggregate_key(
                   *args, "float32", "cpu", batch=2)}[fn]()
        extras = {"d_s": 4, "d_out": 16} if "block" in name else {}
        cache.put(key, {**cands[-1], **extras})
        want.append(cands[-1])
    assert warm_from_cache(cache) == len(cache) == 8
    assert sorted(map(str, handed)) == sorted(map(str, want))
