"""The port's kernel-tuning layer (``repro_torch/tuning/``) against the
JAX package's, on the CPU: the tuning problems that every deployment
emits, with the backend ``xla`` mapped to ``cpu``; the bindings a cache
with the same winners makes; an empty cache changing no graph; the
cache file's schema, round trip and load errors; the reference's TPU
entries never binding in the port; the tuner, the warm-up and the serve
loop's ``--tune`` / ``--tuning-cache``. Graphs and bindings are compared
exactly; times are not compared.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import caloclusternet as jccn
from repro.core.graph_ir import export_graph as jexport
from repro.core.passes.parallelize import Requirements as JReq
from repro.core.pipeline import deploy as jdeploy
from repro.data import belle2 as jbelle2
from repro.models.gnn import gatedgcn as jgatedgcn
from repro.models.gnn import graphsage as jgraphsage
from repro.tuning import autotune as jautotune
from repro.tuning import cache as jcache
from repro_torch.convert import from_jax_gnn_params, from_jax_params
from repro_torch.core import caloclusternet as tccn
from repro_torch.core.graph_ir import export_graph
from repro_torch.core.pipeline import Requirements as TReq
from repro_torch.core.pipeline import deploy as tdeploy
from repro_torch.launch import serve as tserve
from repro_torch.models.gnn import gatedgcn, graphsage
from repro_torch.tuning import (TuningCache, autotune_graph,
                                flash_attention_key, graph_kernel_problems,
                                tune_flash_attention, warm_from_cache)
from repro_torch.tuning import cache as tcache
from repro_torch.tuning import candidates as cand
from repro_torch.tuning.autotune import device_of
from test_torch_attention import _attention_graphs

DEPLOYMENTS = ["attention", "ccn_fp", "ccn_mixed", "ccn_mixed_unfused",
               "gatedgcn", "graphsage", "ragged"]


def _req(mod, dp=3, policy="fp", n=32, tp=1e5):
    return mod(design_point=dp, platform="cpu", precision_policy=policy,
               n_hits=n, target_throughput=tp, max_latency_s=2e-3)


@pytest.fixture(scope="module")
def setups():
    """name -> (deploy_jax(cache), deploy_port(cache), n_rows, batch):
    each deployment built in both packages from the same weights."""
    out = {}
    ja, ta = _attention_graphs()
    out["attention"] = (
        lambda c: jdeploy(ja, _req(JReq, n=16, tp=1e3), batch=2,
                          tuning_cache=c, kernel_backend="xla"),
        lambda c: tdeploy(ta, _req(TReq, n=16, tp=1e3), batch=2,
                          tuning_cache=c, device="cpu"), 16, 2)
    jcfg, tcfg = jccn.CCNConfig(n_hits=32), tccn.CCNConfig(n_hits=32)
    params = jccn.init(jax.random.PRNGKey(3), jcfg)
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                              tcfg, device="cpu")
    jg, tg = jccn.to_graph(params, jcfg), tccn.to_graph(tparams, tcfg)
    ev = jbelle2.generate(jbelle2.current_detector(), 16, seed=123)
    calib = {"hits": ev["feats"], "mask": ev["mask"]}
    for name, policy, kw in (("ccn_fp", "fp", {}),
                             ("ccn_mixed", "mixed", {}),
                             ("ccn_mixed_unfused", "mixed",
                              {"fuse_int8": False})):
        ckw = dict(kw, calibration_feeds=calib) if policy == "mixed" else kw
        out[name] = (
            lambda c, p=policy, k=ckw: jdeploy(
                jg, _req(JReq, policy=p), tuning_cache=c,
                kernel_backend="xla", **k),
            lambda c, p=policy, k=ckw: tdeploy(
                tg, _req(TReq, policy=p), tuning_cache=c, device="cpu", **k),
            32, 1)
    out["ragged"] = (
        lambda c: jdeploy(jg, _req(JReq, tp=5e4), batch=4, ragged=True,
                          tuning_cache=c, kernel_backend="xla").pipe,
        lambda c: tdeploy(tg, _req(TReq, tp=5e4), batch=4, ragged=True,
                          tuning_cache=c, device="cpu").pipe, 32, 4)
    for name, jm, tm, cfg_kw in (
            ("gatedgcn", jgatedgcn, gatedgcn,
             dict(n_layers=2, d_hidden=16, d_in=8, d_edge_in=4,
                  n_classes=4)),
            ("graphsage", jgraphsage, graphsage,
             dict(n_layers=2, d_hidden=16, d_in=12, n_classes=5))):
        cls = "GatedGCNConfig" if name == "gatedgcn" else "GraphSAGEConfig"
        jc, tc = getattr(jm, cls)(**cfg_kw), getattr(tm, cls)(**cfg_kw)
        jp = jm.init(jax.random.PRNGKey(1), jc)
        tp = from_jax_gnn_params(jax.tree_util.tree_map(np.asarray, jp), tc,
                                 device="cpu")
        jgn, tgn = jexport(name, jp, jc), export_graph(name, tp, tc)
        out[name] = (
            lambda c, g=jgn: jdeploy(g, _req(JReq, tp=1e4), tuning_cache=c,
                                     kernel_backend="xla"),
            lambda c, g=tgn: tdeploy(g, _req(TReq, tp=1e4), tuning_cache=c,
                                     device="cpu"), 32, 1)
    return out


def _shape_keys(keys):
    return [(k.kernel, k.shape, k.dtype) for k in keys]


def _bindings(g):
    return [(op.name, sorted(op.attrs_opt.items())) for op in g]


# a non-default winner per kernel family, as one cache entry would hold it
WINNERS = {"fused_dense": {"variant": "looped", "bm": 8, "bn": 128,
                           "bk": 128},
           "gravnet": {"bm": 8}, "gravnet_block": {"bm": 8, "bn": 32},
           "gravnet_block_int8": {"bm": 8, "bk": 32},
           "edge_aggregate": {"bm": 8, "be": 64}, "knn_build": {"bm": 8},
           "knn_aggregate": {"bm": 16}, "flash_attention": {"bq": 8,
                                                            "bk": 16}}


@pytest.mark.parametrize("name", DEPLOYMENTS)
def test_tuning_problems_match_reference(setups, name):
    """graph_kernel_problems: the reference's keys, kernel, shape and
    dtype, with the port's backend in place of 'xla'."""
    dj, dt, n_rows, batch = setups[name]
    jkeys = jautotune.graph_kernel_problems(dj(None).graph, n_rows=n_rows,
                                            backend="xla", batch=batch)
    tkeys = graph_kernel_problems(dt(None).graph, n_rows=n_rows,
                                  backend="cpu", batch=batch)
    assert jkeys and _shape_keys(tkeys) == _shape_keys(jkeys)
    assert {k.backend for k in tkeys} == {"cpu"}
    assert [k.encode() for k in tkeys] == [
        k.encode().replace("|xla", "|cpu") for k in jkeys]


@pytest.mark.parametrize("name", DEPLOYMENTS)
def test_same_winners_bind_the_same_knobs(setups, name):
    """A cache holding the same winner for every problem binds the same
    attrs_opt on every op in both packages, and differs from the
    untuned binding."""
    dj, dt, n_rows, batch = setups[name]
    jkeys = jautotune.graph_kernel_problems(dj(None).graph, n_rows=n_rows,
                                            backend="xla", batch=batch)
    jc, tc = jcache.TuningCache(), TuningCache()
    for k in jkeys:
        jc.put(k, WINNERS[k.kernel])
        tc.put(tcache.KernelKey(k.kernel, k.shape, k.dtype, "cpu"),
               WINNERS[k.kernel])
    tpipe = dt(tc)
    assert _bindings(tpipe.graph) == _bindings(dj(jc).graph)
    assert _bindings(tpipe.graph) != _bindings(dt(None).graph)


@pytest.mark.parametrize("name", DEPLOYMENTS)
def test_empty_cache_changes_no_graph(setups, name):
    _, dt, _, _ = setups[name]
    base, empty = dt(None).graph, dt(TuningCache()).graph
    assert _bindings(empty) == _bindings(base)
    assert [(op.name, op.op_type, op.template, list(op.inputs))
            for op in empty] == [(op.name, op.op_type, op.template,
                                  list(op.inputs)) for op in base]


def test_reference_backends_never_bind(setups, tmp_path):
    """A cache that the reference wrote for its TPU ('pallas') and XLA
    backends loads in the port (same schema and encoding) but binds
    nothing, neither on 'cpu' nor on 'cuda' keys."""
    dj, dt, n_rows, batch = setups["attention"]
    jc = jcache.TuningCache()
    for be in ("pallas", "xla"):
        for k in jautotune.graph_kernel_problems(
                dj(None).graph, n_rows=n_rows, backend=be, batch=batch):
            jc.put(k, WINNERS[k.kernel], us=3.0)
    path = jc.save(tmp_path / "ref.json")
    tc = TuningCache.load(path)
    assert tc.load_error is None and len(tc) == len(jc) == 4
    assert _bindings(dt(tc).graph) == _bindings(dt(None).graph)
    for be in ("cpu", "cuda"):
        assert tc.lookup(flash_attention_key(2, 16, 16, 8, "float32",
                                             be)) is None
    assert tc.lookup(flash_attention_key(2, 16, 16, 8, "float32",
                                         "pallas")) == WINNERS[
                                             "flash_attention"]


def test_key_encodings_match_reference():
    for fn, args in (("fused_dense_key", (256, 64, 32, "int8")),
                     ("gravnet_key", (128, 4, 22, 8, "float32")),
                     ("gravnet_block_key", (128, 64, 22, 8, "float32")),
                     ("edge_aggregate_key", (64, 256, 70, "float32")),
                     ("knn_build_key", (128, 4, 8, "float32")),
                     ("knn_aggregate_key", (128, 22, 8, "float32")),
                     ("flash_attention_key", (8, 512, 512, 64, "float32"))):
        for batch in ((), (8,)) if fn not in ("fused_dense_key",
                                              "flash_attention_key") \
                else ((),):
            kw = {"batch": batch[0]} if batch else {}
            t = getattr(tcache, fn)(*args, "cuda", **kw)
            j = getattr(jcache, fn)(*args, "cuda", **kw)
            assert t.encode() == j.encode()
            assert tcache.KernelKey.decode(t.encode()) == t
    for batch in (1, 8):
        assert tcache.gravnet_block_int8_key(
            128, 64, 22, 8, "cpu", batch=batch).encode() == \
            jcache.gravnet_block_int8_key(128, 64, 22, 8, "cpu",
                                          batch=batch).encode()


def test_cache_file_round_trip_matches_reference_bytes(tmp_path):
    """save/load keep every entry; the port writes the reference's
    bytes for the same entries."""
    tc, jc = TuningCache(), jcache.TuningCache()
    for c, mod in ((tc, tcache), (jc, jcache)):
        c.put(mod.flash_attention_key(8, 512, 512, 64, "float32", "cuda"),
              {"bq": 64, "bk": 128}, us=301.5, default_us=624.25,
              candidates=8)
        c.put(mod.fused_dense_key(256, 64, 64, "int8", "cuda"),
              {"variant": "looped", "bm": 128, "bn": 128, "bk": 512},
              us=6.0, default_us=6.0, candidates=1)
    p = tc.save(tmp_path / "port.json")
    jc.save(tmp_path / "ref.json")
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "ref.json").read_bytes()
    back = TuningCache.load(p)
    assert back.load_error is None
    assert {k: e.to_json() for k, e in back.entries().items()} == \
        {k: e.to_json() for k, e in tc.entries().items()}
    assert not TuningCache.load(tmp_path / "missing.json").load_error


@pytest.mark.parametrize("content,why", [
    ("{not json", "unreadable"), ("[1, 2]", "not a JSON object"),
    ('{"schema": 2, "entries": {}}', "stale"),
    ('{"schema": 1, "entries": []}', "not a dict")])
def test_load_error_leaves_an_empty_cache(tmp_path, content, why):
    p = tmp_path / "cache.json"
    p.write_text(content)
    c = TuningCache.load(p)
    assert why in c.load_error and len(c) == 0
    jc_ = jcache.TuningCache.load(p)
    assert jc_.load_error == c.load_error


def test_malformed_entry_is_dropped_alone(tmp_path):
    p = tmp_path / "cache.json"
    good = flash_attention_key(1, 16, 16, 8, "float32", "cpu").encode()
    p.write_text(json.dumps({"schema": 1, "entries": {
        good: {"config": {"bq": 16}}, "no-separators": {"config": {}},
        "x|1|float32|cpu": {"nope": 1}}}))
    c = TuningCache.load(p)
    assert c.load_error is None and len(c) == 1


@pytest.mark.parametrize("name", ["attention", "ccn_mixed", "graphsage"])
def test_autotune_graph_on_cpu_records_one_inert_candidate(setups, name):
    """On 'cpu' the plain versions ignore every knob: one measurement per
    problem, the default recorded, and a redeploy hits every entry."""
    _, dt, n_rows, batch = setups[name]
    g = dt(None).graph
    keys = graph_kernel_problems(g, n_rows=n_rows, backend="cpu",
                                 batch=batch)
    cache = TuningCache()
    assert autotune_graph(g, n_rows=n_rows, backend="cpu", cache=cache,
                          batch=batch, iters=1) == len(keys)
    assert set(cache.entries()) == set(keys)
    for k, e in cache.entries().items():
        assert e.candidates == 1 and e.us > 0 and e.us == e.default_us
        if k.kernel == "flash_attention":
            assert e.config == cand.default_flash_attention()
    # entries are kept unless forced
    assert autotune_graph(g, n_rows=n_rows, backend="cpu", cache=cache,
                          batch=batch, iters=1) == 0
    tuned = dt(cache).graph
    assert graph_kernel_problems(tuned, n_rows=n_rows, backend="cpu",
                                 batch=batch) == keys


def test_flash_candidates_keep_only_plans_that_fit():
    """The default first, then the kernel's (bq, bk) tiles of 32, 64 and
    128, less every plan above 227 KB of shared memory at the head width
    (none: a plan whose two K/V stages do not fit keeps one) and every
    head width above 128."""
    grid = [(128, 128), (32, 32), (32, 64), (32, 128), (64, 32), (64, 64),
            (64, 128), (128, 32), (128, 64)]
    d64 = cand.flash_attention_candidates(512, 512, 64)
    assert d64[0] == {"bq": 128, "bk": 128}
    assert [(c["bq"], c["bk"]) for c in d64] == grid
    d128 = cand.flash_attention_candidates(4096, 4096, 128)
    assert [(c["bq"], c["bk"]) for c in d128] == grid
    assert cand.flash_attention_candidates(16, 16, 8) == [
        {"bq": 128, "bk": 128}, {"bq": 16, "bk": 16}]
    assert cand.flash_attention_candidates(64, 64, 160) == [
        {"bq": 128, "bk": 128}]
    # the other families: the wrapper's own plan first, then the rest of
    # the source's rows a CTA (tests/test_torch_launch_knobs.py)
    assert cand.knn_build_candidates(128, batch=8) == [
        {"bm": 8}, {"bm": 4}, {"bm": 16}]
    assert cand.gravnet_block_int8_candidates(128, 64, 22, 64, d_s=4) == [
        {"bm": 16}, {"bm": 4}, {"bm": 8}]


def test_tune_flash_attention_on_cpu():
    cache = TuningCache()
    cfg = tune_flash_attention(2, 16, 16, 8, backend="cpu", cache=cache,
                               iters=1)
    assert cfg == {"bq": 128, "bk": 128}
    e = cache.entry(flash_attention_key(2, 16, 16, 8, "float32", "cpu"))
    assert e.candidates == 1 and e.config == cfg


def test_tune_flash_attention_times_bf16_inputs(monkeypatch):
    """A bf16 problem is timed on bf16 q, k, v (and filed under its bf16
    key), as the reference draws them; f32 on f32."""
    from repro_torch.kernels import ops
    seen = []
    real = ops.flash_attention

    def spy(q, k, v, **kw):
        seen.append((q.dtype, k.dtype, v.dtype))
        return real(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    cache = TuningCache()
    for dtype, want in (("bf16", torch.bfloat16),
                        ("float32", torch.float32)):
        seen.clear()
        tune_flash_attention(1, 16, 16, 8, dtype=dtype, backend="cpu",
                             cache=cache, iters=1)
        assert seen and set(seen) == {(want,) * 3}
        assert flash_attention_key(1, 16, 16, 8, dtype, "cpu") in cache


def test_warm_up_replays_bf16_flash_keys_on_bf16(monkeypatch):
    from repro_torch.kernels import ops
    seen = []
    real = ops.flash_attention

    def spy(q, k, v, **kw):
        seen.append(q.dtype)
        return real(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    cache = TuningCache()
    cache.put(flash_attention_key(1, 16, 16, 8, "bf16", "cpu"),
              {"bq": 16, "bk": 16})
    cache.put(flash_attention_key(1, 32, 32, 8, "float32", "cpu"),
              {"bq": 16, "bk": 16})
    assert warm_from_cache(cache) == 2
    assert sorted(map(str, seen)) == ["torch.bfloat16", "torch.float32"]


#: a bf16 problem of each family the issue's mixed GraphSAGE and a
#: bf16-tagged dense emit: (tune_* function, its shape, key function)
BF16_PROBLEMS = {"fused_dense": ("tune_fused_dense", (16, 8, 4),
                                 "fused_dense_key"),
                 "edge_aggregate": ("tune_edge_aggregate", (9, 40, 6),
                                    "edge_aggregate_key")}


def _float_operand_spy(monkeypatch, name):
    """Record the dtypes of every float operand and of the result of
    each ``ops.<name>`` call (the edge sum's mask, data in f32, left
    out)."""
    from repro_torch.kernels import ops
    seen = []
    real = getattr(ops, name)

    def spy(*a, **kw):
        floats = a[:3] if name == "fused_dense" else a[:1]
        out = real(*a, **kw)
        seen.append(tuple(t.dtype for t in floats if t is not None)
                    + (out.dtype,))
        return out

    monkeypatch.setattr(ops, name, spy)
    return seen


@pytest.mark.parametrize("kernel", sorted(BF16_PROBLEMS))
def test_tune_times_bf16_problems_on_bf16_operands(kernel, monkeypatch):
    """A problem keyed bf16 (``kernel_opt`` keys a bf16-tagged op's
    problem so: GraphSAGE's ``l0_neigh`` under mixed) is timed on bf16
    float operands into a bf16 result, as the reference draws them, and
    filed under the reference's key; on 'cpu' the plain versions run
    it."""
    from repro_torch.tuning import autotune
    fn, shape, key_fn = BF16_PROBLEMS[kernel]
    seen = _float_operand_spy(monkeypatch, kernel)
    cache = TuningCache()
    getattr(autotune, fn)(*shape, dtype="bf16", backend="cpu", cache=cache,
                          iters=1)
    assert seen and set(seen) == {(torch.bfloat16,) * len(seen[0])}
    key = getattr(tcache, key_fn)(*shape, "bf16", "cpu")
    assert key.encode() == getattr(jcache, key_fn)(*shape, "bf16",
                                                   "cpu").encode()
    assert set(cache.entries()) == {key}


@pytest.mark.parametrize("kernel", sorted(BF16_PROBLEMS))
def test_warm_up_replays_bf16_problems_on_bf16(kernel, monkeypatch):
    _, shape, key_fn = BF16_PROBLEMS[kernel]
    # the replay runs an edge problem through the batched entry point
    seen = _float_operand_spy(monkeypatch, kernel if kernel == "fused_dense"
                              else "edge_aggregate_batched")
    cache = TuningCache()
    extras = {"reduce": "mean"} if kernel == "edge_aggregate" else {}
    cache.put(getattr(tcache, key_fn)(*shape, "bf16", "cpu"), extras)
    cache.put(getattr(tcache, key_fn)(*shape, "float32", "cpu"), extras)
    assert warm_from_cache(cache) == 2
    assert sorted(str(s[0]) for s in seen) == ["torch.bfloat16",
                                               "torch.float32"]
    assert all(len(set(s)) == 1 for s in seen)


def test_tuning_backends_are_the_ports():
    assert device_of("cpu") == torch.device("cpu")
    for be in ("xla", "pallas", "pallas_interpret"):
        with pytest.raises(ValueError, match="cuda' or 'cpu"):
            device_of(be)


def test_warm_from_cache_skips_stale_entries():
    cache = TuningCache()
    cache.put(flash_attention_key(1, 16, 16, 8, "float32", "cpu"),
              {"bq": 16, "bk": 16})
    cache.put(tcache.knn_build_key(16, 4, 4, "float32", "cpu", batch=2),
              {"bm": 16})
    # a knob the kernel does not know, a reference backend, a kernel
    # family the port lacks: skipped, not fatal
    cache.put(flash_attention_key(1, 32, 32, 8, "float32", "cpu"),
              {"bq": 16, "bm": 4})
    cache.put(flash_attention_key(1, 16, 16, 8, "float32", "pallas"),
              {"bq": 16})
    cache.put(tcache.KernelKey("conv2d", (3, 3), "float32", "cpu"), {})
    with pytest.warns(RuntimeWarning, match="skipped") as rec:
        assert warm_from_cache(cache) == 2
    assert sorted(str(w.message).split()[3] for w in rec) == sorted([
        "conv2d|3x3|float32|cpu:", "flash_attention|1x16x16x8|float32|"
        "pallas:", "flash_attention|1x32x32x8|float32|cpu:"])
    with pytest.warns(RuntimeWarning):
        assert warm_from_cache(cache, backend="cpu") == 2
    assert warm_from_cache(cache, kernels=("knn_build",)) == 1


def test_serve_tunes_then_binds_from_the_saved_cache(tmp_path, capsys):
    """``--tune --tuning-cache`` times the route's problems and saves
    them; a second run on the saved cache binds every problem without
    searching, warms them and answers every event."""
    path = str(tmp_path / "tuning.json")
    argv = ["--device", "cpu", "--detector", "current", "--events", "8",
            "--tuning-cache", path]
    assert tserve.main(argv + ["--tune"]) == 0
    first = capsys.readouterr().out
    assert "[serve] autotuned 5 kernel problem(s), cache holds 5" in first
    assert "answered=8 in-order=True" in first
    assert len(TuningCache.load(path)) == 5
    assert tserve.main(argv) == 0
    second = capsys.readouterr().out
    assert "autotuned" not in second and "[tune]" not in second
    assert "route ccn: 5 of 5 kernel problems bound" in second
    assert "warmed 5 cached kernel shape(s)" in second
    assert "answered=8 in-order=True" in second


def test_serve_warns_on_an_unusable_cache(tmp_path, capsys):
    path = tmp_path / "tuning.json"
    path.write_text('{"schema": 0}')
    assert tserve.main(["--device", "cpu", "--detector", "current",
                        "--events", "4", "--model", "graphsage",
                        "--tuning-cache", str(path)]) == 0
    out = capsys.readouterr().out
    assert "WARNING" in out and "stale" in out
    assert "0 of" in out and "answered=4 in-order=True" in out


def test_tuned_attention_deployment_matches_reference_output(setups):
    """The same winner bound in both packages: outputs within the
    float32 row (the reference's interpret-mode kernel at the bound
    blocks against the port's plain version at the same blocks)."""
    from _numerics import assert_close
    ja, ta = _attention_graphs()
    key = (2, 16, 16, 8, "float32")
    jc, tc = jcache.TuningCache(), TuningCache()
    jc.put(jcache.flash_attention_key(*key, "pallas_interpret"),
           {"bq": 8, "bk": 8})
    tc.put(flash_attention_key(*key, "cpu"), {"bq": 8, "bk": 8})
    tok = np.random.default_rng(5).normal(size=(4, 16, 8)).astype(
        np.float32)
    want = jdeploy(ja, _req(JReq, n=16, tp=1e3), batch=2, tuning_cache=jc,
                   kernel_backend="pallas_interpret")({"tok": jnp.asarray(
                       tok)})["y"]
    tpipe = tdeploy(ta, _req(TReq, n=16, tp=1e3), batch=2, tuning_cache=tc,
                    device="cpu")
    assert tpipe.graph["attn"].attrs_opt == {"P": tpipe.graph[
        "attn"].attrs_opt["P"], "bq": 8, "bk": 8}
    assert_close(tpipe({"tok": tok})["y"].numpy(), np.asarray(want),
                 dtype="float32")


def test_search_times_the_card_on_its_clock(monkeypatch):
    """On ``cuda`` every candidate is timed by the device timer (CUDA
    events behind a sleep kernel), never on the host clock; on ``cpu``
    the default alone, on the host clock. A challenger then dethrones
    the default only by more than ``MIN_GAIN``."""
    from repro_torch.tuning import autotune as tautotune
    device_times = iter([40e-6, 35e-6, 39e-6])   # default, then two
    timers = []

    def device(fn, *, iters):
        timers.append("device")
        fn()
        return next(device_times)

    def host(fn, *, iters):
        timers.append("host")
        fn()
        return 1.0

    monkeypatch.setattr(tautotune, "_device_time_call", device)
    monkeypatch.setattr(tautotune, "_time_call", host)
    cands = [{"bq": 128, "bk": 128}, {"bq": 64, "bk": 64},
             {"bq": 32, "bk": 32}]
    called = []
    timed = tautotune._search(called.append, cands, "cuda", 5)
    assert timers == ["device"] * 3 and called == cands
    assert [t for _, t in timed] == [40e-6, 35e-6, 39e-6]
    best, _, _ = tautotune._pick(timed, min_gain=tautotune.MIN_GAIN)
    assert best == {"bq": 64, "bk": 64}
    best, _, _ = tautotune._pick(timed, min_gain=0.2)
    assert best == cands[0]
    timers.clear()
    called.clear()
    assert tautotune._search(called.append, cands, "cpu", 5) == [
        (cands[0], 1.0)]
    assert timers == ["host"] and called == cands[:1]


# ------------------------------------------- every list starts untuned ----
def _untuned_plans():
    """(family, shape label, candidates, plan): ``plan(knobs)`` is what
    the wrapper launches with those knobs (no knob: its own plan), so a
    list's first candidate is the untuned launch where ``plan(first) ==
    plan({})``. The raggedized block launches the kNN pair with one bm:
    its plan is both kNN kernels' plans."""
    from repro_torch.kernels import edge_aggregate as edge
    from repro_torch.kernels import fused_dense as dense
    from repro_torch.kernels import gravnet, gravnet_block, knn_build
    from repro_torch.kernels.flash_attention import plan_block

    def ragged(n, b, df):
        return (f"ragged block n={n} bins={b} d_f={df}",
                cand.gravnet_block_ragged_candidates(n, batch=b, d_f=df),
                lambda c: (knn_build.build_plan(n, b, c.get("bm")),
                           knn_build.aggregate_plan(n, b, df, c.get("bm"))))
    rows = [(f"fused_dense {m}x{k}->{n}",
             cand.fused_dense_candidates(m, k, n),
             lambda c, m=m, n=n: dense.variant_of(m, n, c.get("bm"),
                                                  c.get("bn")))
            for m, k, n in ((256, 64, 64), (256, 32, 7), (4096, 64, 192),
                            (1024, 108, 64))]
    rows += [(f"fused_dense_int8 {m}x{k}->{n}",
              cand.fused_dense_int8_candidates(m, k, n),
              lambda c: dense.int8_tile_of(c.get("bm"), c.get("bn")))
             for m, k, n in ((256, 64, 64), (256, 32, 7))]
    rows += [(f"gravnet n={n} b={b} d_f={df}",
              cand.gravnet_candidates(n, batch=b, d_f=df),
              lambda c, n=n, b=b, df=df: gravnet.plan(n, b, df, c.get("bm")))
             for n, b, df in ((128, 1, 22), (128, 16, 22), (600, 1, 22),
                              (128, 1, 129))]
    rows += [(f"gravnet_block n={n} d_hidden={dh} d_f={df}",
              cand.gravnet_block_candidates(n, dh, df, dh, d_s=4, batch=b),
              lambda c, n=n, dh=dh, df=df: gravnet_block.plan(
                  n, dh, 4, df, dh, True, c.get("bm")))
             for n, b, dh, df in ((128, 2, 64, 22), (32, 8, 64, 22),
                                  (128, 1, 16, 129))]
    rows += [(f"gravnet_block_int8 n={n}",
              cand.gravnet_block_int8_candidates(n, 64, 22, 64, d_s=4),
              lambda c, n=n: gravnet_block.int8_plan(n, 64, 4, 22, 64,
                                                     True, c.get("bm")))
             for n in (128, 32)]
    rows += [(f"knn_build n={n} bins={b}",
              cand.knn_build_candidates(n, batch=b),
              lambda c, n=n, b=b: knn_build.build_plan(n, b, c.get("bm")))
             for n, b in ((128, 1), (128, 8), (600, 1))]
    rows += [(f"knn_aggregate n={n} bins={b} d_f={df}",
              cand.knn_aggregate_candidates(n, batch=b, d_f=df),
              lambda c, n=n, b=b, df=df: knn_build.aggregate_plan(
                  n, b, df, c.get("bm")))
             for n, b, df in ((128, 1, 22), (128, 8, 22), (128, 1, 129))]
    rows += [(f"edge_aggregate n={n} e={e} d={d} b={b}",
              cand.edge_aggregate_candidates(n, e, d=d, batch=b),
              lambda c, n=n, d=d, b=b: edge.plan(n, d, b, c.get("bm"),
                                                 c.get("bn")))
             for n, e, d, b in ((64, 256, 70, 1), (256, 2048, 16, 8),
                                (600, 1000, 129, 1))]
    rows += [(f"flash_attention s={s} d={d}",
              cand.flash_attention_candidates(s, s, d),
              lambda c: (plan_block(c.get("bq", 128)),
                         plan_block(c.get("bk", 128))))
             for s, d in ((512, 64), (16, 8))]
    rows += [ragged(128, b, df) for b in (1, 8) for df in (22, 129)]
    return rows


@pytest.mark.parametrize("case", range(len(_untuned_plans())),
                         ids=[r[0] for r in _untuned_plans()])
def test_every_candidate_list_starts_with_the_untuned_plan(case):
    """Every family's list in ``tuning/candidates.py`` starts with the
    launch its wrapper makes with no knob (``autotune._pick`` takes
    ``timed[0]`` for it), the raggedized block at d_f 22 and 129 at 1
    and 8 bins included: past d_f 128 its kNN pair's own plans differ,
    and the list starts with ``{}``."""
    _, cands, plan = _untuned_plans()[case]
    assert cands and plan(cands[0]) == plan({})


def test_ragged_block_candidates_at_the_paths_width_unchanged():
    """At d_f 22, the ragged CaloClusterNet's width, both kNN plans agree,
    so the common bm is the untuned launch and the list is what it was;
    past d_f 128 the untuned launch ``{}`` leads, then the common rows."""
    assert cand.gravnet_block_ragged_candidates(128, batch=8, d_f=22) == [
        {"bm": 8}, {"bm": 4}, {"bm": 16}]
    assert cand.gravnet_block_ragged_candidates(128, batch=1, d_f=22)[0] \
        == {"bm": 4}
    for b in (1, 8):
        got = cand.gravnet_block_ragged_candidates(128, batch=b, d_f=129)
        assert got[0] == {} and {"bm": 8} in got and {"bm": 16} in got
    # {} names only an entry without a bm; a bm names its own candidate
    ragged = cand.gravnet_block_ragged_candidates(128, batch=1, d_f=129)
    assert cand.among({"d_s": 4, "d_out": 64}, ragged)
    assert cand.among({"bm": 16}, ragged)
    assert not cand.among({"bm": 128}, ragged)
    assert not cand.among({}, cand.knn_build_candidates(128, batch=8))


def test_ragged_tuner_times_the_untuned_launch_first(monkeypatch):
    """Past d_f 128 the tuner's ``timed[0]`` on a raggedized block is the
    untuned launch: its call hands the kNN pair no bm, so each kernel
    runs its own plan (4 rows for the build at one bin, the first
    design's 32 for the aggregation on its shared-memory cell)."""
    from repro_torch.kernels import knn_build, ops
    from repro_torch.tuning import autotune as tautotune
    plans = []
    real_build, real_agg = ops.knn_build_batched, ops.knn_aggregate_batched

    def build(s, seg, **kw):
        plans.append(("build", kw.get("bm"), knn_build.build_plan(
            s.shape[1], s.shape[0], kw.get("bm"))[0]))
        return real_build(s, seg, **kw)

    def agg(f, idx, d2, **kw):
        plans.append(("agg", kw.get("bm"), knn_build.aggregate_plan(
            f.shape[1], f.shape[0], f.shape[2], kw.get("bm"))[0]))
        return real_agg(f, idx, d2, **kw)

    searched = []
    real_search = tautotune._search

    def search(call, cands, backend, iters):
        searched.append(list(cands))
        return real_search(call, cands, backend, iters)

    monkeypatch.setattr(ops, "knn_build_batched", build)
    monkeypatch.setattr(ops, "knn_aggregate_batched", agg)
    monkeypatch.setattr(tautotune, "_search", search)
    cache = TuningCache()
    best = tautotune.tune_gravnet_block(128, 16, 4, 129, 16, 8, batch=1,
                                        ragged=True, backend="cpu",
                                        cache=cache, iters=1)
    assert searched[0][0] == {} and "bm" not in best
    assert plans and all(bm is None for _, bm, _ in plans)
    assert {(k, p) for k, _, p in plans} == {("build", 4), ("agg", 32)}


def test_executor_hands_the_ragged_block_no_bm_unless_bound():
    """A raggedized block's kNN pair gets ``bm`` from the executor only
    where one is bound: unbound (or bound to ``{}``) each kNN kernel runs
    its own plan; a bound bm reaches both."""
    from repro_torch.core import pipeline as tpipeline
    from repro_torch.kernels import ops
    cfg = tccn.CCNConfig(n_hits=32)
    g = export_graph("caloclusternet", tccn.init(
        torch.Generator().manual_seed(0), cfg), cfg)
    req = TReq(design_point=3, platform="cpu", precision_policy="fp",
               n_hits=32, target_throughput=1e5, max_latency_s=2e-3)
    rp = tdeploy(g, req, batch=2, ragged=True, device="cpu")
    ev = jbelle2.generate(jbelle2.current_detector(), 4, seed=3)
    seen = []
    real = ops.gravnet_block_ragged

    def spy(*a, **kw):
        seen.append(kw.get("bm", "absent"))
        return real(*a, **kw)
    blocks = [op for op in rp.pipe.graph if op.op_type == "gravnet_block"]
    try:
        tpipeline.kops.gravnet_block_ragged = spy
        rp({"hits": ev["feats"], "mask": ev["mask"]})
        assert seen and set(seen) == {"absent"}
        seen.clear()
        for op in blocks:
            op.attrs_opt["bm"] = 8
        rp({"hits": ev["feats"], "mask": ev["mask"]})
        assert seen and set(seen) == {8}
    finally:
        tpipeline.kops.gravnet_block_ragged = real
        for op in blocks:
            op.attrs_opt.pop("bm", None)
