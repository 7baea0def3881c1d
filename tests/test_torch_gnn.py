"""The port's edge-based GNNs (``repro_torch/models/gnn/``) and their
deployment against the JAX package's, on the CPU, at the reference
tests' sizes (``tests/test_model_export.py``: N 32, E 128, B 3, 2 layers
× 16): the same weights (the JAX package's init, through
``from_jax_gnn_params``) and the same numpy graphs give eager outputs
and deployed logits within the float32 row, and the same graphs op for
op at design points 1 to 3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _numerics import assert_bitwise, assert_close

from repro.core.graph_ir import export_graph as jexport
from repro.core.passes.parallelize import Requirements as JReq
from repro.core.pipeline import deploy as jdeploy
from repro.launch import serve as jserve
from repro.models.gnn import gatedgcn as jgatedgcn
from repro.models.gnn import graphsage as jgraphsage
from repro_torch.convert import from_jax_gnn_params
from repro_torch.core.caloclusternet import CCNConfig
from repro_torch.core.graph_ir import (Graph, Operator, export_graph,
                                       exporters, register_exporter)
from repro_torch.core.op_registry import UnknownOperatorError
from repro_torch.core.pipeline import Requirements as TReq
from repro_torch.core.pipeline import deploy as tdeploy
from repro_torch.kernels.edge_aggregate import edge_aggregate_cuda
from repro_torch.launch import serve as tserve
from repro_torch.models.gnn import gatedgcn, graphsage

N, E, B = 32, 128, 3
MODELS = {
    "gatedgcn": (jgatedgcn, gatedgcn, dict(n_layers=2, d_hidden=16, d_in=8,
                                           d_edge_in=4, n_classes=4)),
    "graphsage": (jgraphsage, graphsage, dict(n_layers=2, d_hidden=16,
                                              d_in=12, n_classes=5)),
}


def _cfgs(name, **over):
    jm, tm, kw = MODELS[name]
    kw = {**kw, **over}
    if name == "gatedgcn":
        return jm.GatedGCNConfig(**kw), tm.GatedGCNConfig(**kw)
    return jm.GraphSAGEConfig(**kw), tm.GraphSAGEConfig(**kw)


def _feeds(name, *, seed):
    """A micro-batch of B padded graphs as numpy (the reference tests'
    generator)."""
    d_in = MODELS[name][2]["d_in"]
    rng = np.random.default_rng(seed)
    feeds = {
        "nodes": rng.normal(size=(B, N, d_in)).astype(np.float32),
        "edge_index": rng.integers(0, N, size=(B, 2, E)).astype(np.int32),
        "node_mask": (rng.uniform(size=(B, N)) < 0.8).astype(np.float32),
        "edge_mask": (rng.uniform(size=(B, E)) < 0.7).astype(np.float32),
    }
    if name == "gatedgcn":
        feeds["edges"] = rng.normal(size=(B, E, 4)).astype(np.float32)
    return feeds


@pytest.fixture(scope="module", params=sorted(MODELS))
def model(request):
    """(name, jax cfg, jax params, port cfg, port params)."""
    name = request.param
    jcfg, tcfg = _cfgs(name)
    jm = MODELS[name][0]
    jparams = jm.init(jax.random.PRNGKey(1), jcfg)
    tparams = from_jax_gnn_params(jax.tree_util.tree_map(np.asarray,
                                                         jparams),
                                  tcfg, device="cpu")
    return name, jcfg, jparams, tcfg, tparams


def _req_kw(dp):
    return dict(design_point=dp, platform="cpu", precision_policy="fp",
                n_hits=N, target_throughput=1e4)


def _op_rows(g):
    return [(op.name, op.op_type, op.inputs, op.target, op.segment,
             op.precision, op.template, op.out_dim, op.attrs_opt.get("P"),
             op.attrs_opt.get("variant")) for op in g]


# ------------------------------------------------------------ eager apply ----
@pytest.mark.parametrize("transform_then_gather", [False, True])
def test_gatedgcn_apply_matches_jax(transform_then_gather):
    jcfg, tcfg = _cfgs("gatedgcn",
                       transform_then_gather=transform_then_gather)
    jparams = jgatedgcn.init(jax.random.PRNGKey(1), jcfg)
    tparams = from_jax_gnn_params(jax.tree_util.tree_map(np.asarray,
                                                         jparams),
                                  tcfg, device="cpu")
    feeds = _feeds("gatedgcn", seed=2)
    for b in range(B):
        ev = {k: v[b] for k, v in feeds.items()}
        want = jgatedgcn.apply(jparams, {k: jnp.asarray(v)
                                         for k, v in ev.items()}, jcfg)
        got = gatedgcn.apply(tparams, {k: torch.from_numpy(v)
                                       for k, v in ev.items()}, tcfg)
        assert_close(got.numpy(), np.asarray(want), dtype="float32",
                     context=f"event {b}")


def test_gatedgcn_default_edges_match_jax():
    """A graph without ``edges`` gets the reference's all-ones edge
    features."""
    jcfg, tcfg = _cfgs("gatedgcn", d_edge_in=1)
    jparams = jgatedgcn.init(jax.random.PRNGKey(4), jcfg)
    tparams = from_jax_gnn_params(jax.tree_util.tree_map(np.asarray,
                                                         jparams),
                                  tcfg, device="cpu")
    ev = {k: v[0] for k, v in _feeds("gatedgcn", seed=3).items()
          if k != "edges"}
    want = jgatedgcn.apply(jparams, {k: jnp.asarray(v)
                                     for k, v in ev.items()}, jcfg)
    got = gatedgcn.apply(tparams, {k: torch.from_numpy(v)
                                   for k, v in ev.items()}, tcfg)
    assert got.shape == (N, 4)
    assert_close(got.numpy(), np.asarray(want), dtype="float32")


@pytest.mark.parametrize("normalize", [True, False])
def test_graphsage_apply_matches_jax(normalize):
    jcfg, tcfg = _cfgs("graphsage", normalize=normalize)
    jparams = jgraphsage.init(jax.random.PRNGKey(2), jcfg)
    tparams = from_jax_gnn_params(jax.tree_util.tree_map(np.asarray,
                                                         jparams),
                                  tcfg, device="cpu")
    feeds = _feeds("graphsage", seed=4)
    for b in range(B):
        ev = {k: v[b] for k, v in feeds.items()}
        want = jgraphsage.apply(jparams, {k: jnp.asarray(v)
                                          for k, v in ev.items()}, jcfg)
        got = graphsage.apply(tparams, {k: torch.from_numpy(v)
                                        for k, v in ev.items()}, tcfg)
        assert_close(got.numpy(), np.asarray(want), dtype="float32",
                     context=f"event {b}")


# ----------------------------------------------------- export and deploy ----
def test_exported_graphs_equal(model):
    name, jcfg, jparams, tcfg, tparams = model
    jg = jexport(name, jparams, jcfg)
    tg = export_graph(name, tparams, tcfg)
    assert ([(o.name, o.op_type, o.inputs, o.attrs, o.out_dim) for o in tg]
            == [(o.name, o.op_type, o.inputs, o.attrs, o.out_dim)
                for o in jg])
    for op in jg:
        for k, v in (op.params or {}).items():
            assert_bitwise(tg[op.name].params[k].numpy(), np.asarray(v),
                           context=f"{op.name}/{k}")
    assert tg.meta["config"] == tcfg


@pytest.mark.parametrize("dp", [1, 2, 3])
def test_deployed_graphs_equal(model, dp):
    """Templates, segments, P and micro-batch as the reference's design
    flow picks them, and the merged denses' weights."""
    name, jcfg, jparams, tcfg, tparams = model
    jpipe = jdeploy(jexport(name, jparams, jcfg), JReq(**_req_kw(dp)))
    tpipe = tdeploy(export_graph(name, tparams, tcfg), TReq(**_req_kw(dp)),
                    device="cpu")
    assert _op_rows(tpipe.graph) == _op_rows(jpipe.graph)
    assert tpipe.microbatch == jpipe.microbatch
    assert (tpipe.graph.meta["parallelization"]["microbatch"]
            == jpipe.graph.meta["parallelization"]["microbatch"])
    for op in jpipe.graph:
        for k, v in (op.params or {}).items():
            assert_bitwise(tpipe.graph[op.name].params[k].numpy(),
                           np.asarray(v), context=f"{op.name}/{k}")


@pytest.mark.parametrize("dp", [1, 2, 3])
def test_deployed_logits_match_jax_pallas_interpret(model, dp):
    """``deploy(..., device="cpu")`` logits within the float32 row of
    the reference's deployment with its Pallas kernels interpreted."""
    name, jcfg, jparams, tcfg, tparams = model
    feeds = _feeds(name, seed=10 + dp)
    jpipe = jdeploy(jexport(name, jparams, jcfg), JReq(**_req_kw(dp)),
                    kernel_backend="pallas_interpret")
    tpipe = tdeploy(export_graph(name, tparams, tcfg), TReq(**_req_kw(dp)),
                    device="cpu")
    before = edge_aggregate_cuda.launches
    got = tpipe(feeds)["logits"].numpy()
    assert got.shape == (B, N, tcfg.n_classes)
    assert_close(got, np.asarray(jpipe(feeds)["logits"]), dtype="float32",
                 context=f"{name} dp{dp}")
    assert edge_aggregate_cuda.launches == before


def test_batch_packed_executable_matches_jax(model):
    """``batch=3``: one whole-batch launch per segment, against the
    reference's batch-packed deployment and the port's per-chunk one."""
    name, jcfg, jparams, tcfg, tparams = model
    feeds = _feeds(name, seed=9)
    jpipe = jdeploy(jexport(name, jparams, jcfg), JReq(**_req_kw(3)),
                    kernel_backend="pallas_interpret", batch=B)
    tpipe = tdeploy(export_graph(name, tparams, tcfg), TReq(**_req_kw(3)),
                    batch=B, device="cpu")
    assert tpipe.batch_packed and tpipe.microbatch == B
    assert _op_rows(tpipe.graph) == _op_rows(jpipe.graph)
    got = tpipe(feeds)["logits"].numpy()
    assert_close(got, np.asarray(jpipe(feeds)["logits"]), dtype="float32")
    lo = tdeploy(export_graph(name, tparams, tcfg), TReq(**_req_kw(3)),
                 device="cpu")(feeds)["logits"].numpy()
    assert_close(got, lo, dtype="float32", context="batched vs chunked")


def test_deployed_matches_eager_apply(model):
    """The deployed graph computes the eager forward (the export is
    numerically the model, in the port as in the reference)."""
    name, _, _, tcfg, tparams = model
    feeds = _feeds(name, seed=21)
    got = tdeploy(export_graph(name, tparams, tcfg), TReq(**_req_kw(3)),
                  device="cpu")(feeds)["logits"].numpy()
    tm = MODELS[name][1]
    for b in range(B):
        want = tm.apply(tparams, {k: torch.from_numpy(v[b])
                                  for k, v in feeds.items()}, tcfg)
        assert_close(got[b], want.numpy(), dtype="float32",
                     context=f"event {b}")


# --------------------------------------------------------------- registry ----
def test_exporter_registry_lists_models():
    assert {"caloclusternet", "gatedgcn", "graphsage"} <= set(exporters())


def test_export_graph_unknown_model_and_unregistered_ops():
    with pytest.raises(KeyError, match="no exporter 'resnet'"):
        export_graph("resnet", {}, None)

    def bad_export(params, cfg):
        g = Graph()
        g.add(Operator(name="x", op_type="input", out_dim=4,
                       attrs={"feature": "x"}))
        g.add(Operator(name="mystery", op_type="septic_pool",
                       inputs=["x"], out_dim=4))
        g.validate()
        return g

    if "_test_bad_model" not in exporters():
        register_exporter("_test_bad_model", bad_export)
    with pytest.raises(UnknownOperatorError,
                       match=r"mystery \('septic_pool'\)"):
        export_graph("_test_bad_model", {}, None)
    with pytest.raises(ValueError, match="already registered"):
        register_exporter("gatedgcn", bad_export)


# ------------------------------------------------------------ the weights ----
def _np_params(name):
    jcfg, tcfg = _cfgs(name)
    jm = MODELS[name][0]
    return (jax.tree_util.tree_map(np.asarray,
                                   jm.init(jax.random.PRNGKey(0), jcfg)),
            tcfg)


@pytest.mark.parametrize("name,edit,match", [
    ("gatedgcn", lambda p: p.pop("embed_e"), "keys"),
    ("gatedgcn", lambda p: p["layers"][1].pop("V"), "layers/1"),
    ("gatedgcn", lambda p: p.update(extra={"w": 0, "b": 0}), "keys"),
    ("gatedgcn", lambda p: p["layers"].pop(), "list of 2"),
    ("gatedgcn", lambda p: p["layers"][0]["A"].update(
        w=np.zeros((16, 15), np.float32)), "layers/0/A/w: shape"),
    ("gatedgcn", lambda p: p["head"].pop("b"), "head: params"),
    ("graphsage", lambda p: p["layers"][0]["w"].update(
        w=np.zeros((12, 16), np.float32)), "layers/0/w/w: shape"),
    ("graphsage", lambda p: p["head"].update(
        b=np.zeros((4,), np.float32)), "head/b: shape"),
    ("graphsage", lambda p: p["layers"][1].update(u=p["head"]), "keys"),
])
def test_from_jax_gnn_params_refuses_bad_trees(name, edit, match):
    params, tcfg = _np_params(name)
    edit(params)
    with pytest.raises(ValueError, match=match):
        from_jax_gnn_params(params, tcfg, device="cpu")


def test_from_jax_gnn_params_keeps_the_layout():
    params, tcfg = _np_params("graphsage")
    got = from_jax_gnn_params(params, tcfg, device="cpu")
    assert_bitwise(got["layers"][0]["w"]["w"].numpy(),
                   params["layers"][0]["w"]["w"])
    assert tuple(got["layers"][0]["w"]["w"].shape) == (24, 16)
    with pytest.raises(TypeError, match="CCNConfig"):
        from_jax_gnn_params(params, CCNConfig(), device="cpu")


# ----------------------------------------------------------- serve routes ----
@pytest.mark.parametrize("d_in,d_edge_in", [(8, 4), (16, None)])
def test_edge_route_events_equal_the_reference(d_in, d_edge_in):
    """The serve routes' random graphs are the reference's, drawn in its
    order and stacked, byte for byte."""
    want = jserve._edge_events(d_in, d_edge_in)(5, 7)
    got, truth = tserve._edge_events(d_in, d_edge_in)(5, 7)
    assert truth is None
    assert set(got) == set(want[0])
    for k in got:
        stacked = np.stack([ev[k] for ev in want])
        assert got[k].dtype == stacked.dtype
        assert got[k].tobytes() == stacked.tobytes(), k
