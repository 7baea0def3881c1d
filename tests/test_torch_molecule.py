"""The ``molecule`` shape's batched train step in the port against the
JAX package, on the CPU: ``gnn_common.batched_train_step`` on a batch of
4 graphs stacked on a leading axis against the step of the reference's
``make_batched_train_cell`` (its loss vmapped over the graphs), for
DimeNet, NequIP, GatedGCN (graph readout) and GraphSAGE at smoke widths:
the loss, the metrics, the gradient norm, and the new parameters and
AdamW moments within the float32 row, from a fresh state (the schedule's
rate is 0 at step 0, so the moments carry the comparison: GatedGCN's
biases before a batch norm have a gradient of exactly 0, and an Adam
update of their rounding noise has no digits to compare).
GatedGCN's molecule labels are per node, as the reference's
``graph_sds`` gives them, and its graph readout then takes one loss per
node label (the reference's ``logp[labels]``): pinned here. The batch
is ``gnn_common.molecule_graphs``; its generators are held byte for
byte in ``test_torch_sph.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _numerics import assert_close
from test_torch_lm import _two_threads  # noqa: F401 (autouse)

from repro.configs import gnn_common as jG
from repro.models.gnn import dimenet as jdimenet
from repro.models.gnn import gatedgcn as jgatedgcn
from repro.models.gnn import graphsage as jgraphsage
from repro.models.gnn import nequip as jnequip
from repro.optim import adamw as jadamw
from repro_torch.checkpoint.manager import flatten
from repro_torch.configs import gnn_common as tG
from repro_torch.convert import from_jax_adamw_state, from_jax_gnn_params
from repro_torch.models.gnn import dimenet, gatedgcn, graphsage, nequip

BATCH = 4

_CASES = {
    "dimenet": (jdimenet, dimenet, "DimeNetConfig",
                dict(n_blocks=2, d_hidden=16, n_bilinear=4, n_spherical=3,
                     n_radial=3)),
    "nequip": (jnequip, nequip, "NequIPConfig",
               dict(n_layers=2, mult=8, l_max=2, n_rbf=4)),
    "gatedgcn": (jgatedgcn, gatedgcn, "GatedGCNConfig",
                 dict(n_layers=2, d_hidden=16, d_in=16, n_classes=2,
                      readout="graph")),
    "graphsage-reddit": (jgraphsage, graphsage, "GraphSAGEConfig",
                         dict(n_layers=2, d_hidden=16, d_in=16,
                              n_classes=2)),
}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("arch", list(_CASES))
def test_batched_step_matches_reference_vmapped_step(arch):
    jmod, tmod, cls, kw = _CASES[arch]
    jcfg, tcfg = getattr(jmod, cls)(**kw), getattr(tmod, cls)(**kw)
    graphs = tG.molecule_graphs(arch, seed=3, batch=BATCH, device="cpu")
    jgraphs = {k: jnp.asarray(v.numpy()) for k, v in graphs.items()}
    jp = jmod.init(jax.random.PRNGKey(5), jcfg)
    js = jadamw.adamw_init(jp, jG.OCFG)
    jstep = jax.jit(jG.make_batched_train_cell(
        arch, jmod, jcfg, None, None).make_step(None))
    jp2, js2, jm = jstep(jp, js, jgraphs)

    tp = from_jax_gnn_params(_np(jp), tcfg, device="cpu")
    ts = from_jax_adamw_state(_np(js), tcfg, device="cpu")
    tp2, ts2, tm = tG.batched_train_step(tmod, tcfg)(tp, ts, graphs)
    assert set(tm) == set(jm)
    for k in jm:
        assert_close(tm[k].numpy(), np.asarray(jm[k]), dtype="float32",
                     context=k)
    assert int(ts2["step"]) == int(js2["step"]) == 1
    for (name, got), (_, want) in zip(flatten({"p": tp2, "s": ts2}),
                                      flatten(_np({"p": jp2, "s": js2}))):
        assert_close(got.numpy(), want, dtype="float32", context=name)


def test_gatedgcn_graph_readout_takes_a_loss_per_node_label():
    """Per-node labels (B, n) on a graph readout: the port's loss is
    (B, n), each entry -log p(label of that node) of the graph's one
    prediction, as the reference's vmapped ``logp[labels]``; one label a
    graph gives one loss a graph."""
    _, _, cls, kw = _CASES["gatedgcn"]
    jcfg, tcfg = jgatedgcn.GatedGCNConfig(**kw), gatedgcn.GatedGCNConfig(**kw)
    graphs = tG.molecule_graphs("gatedgcn", seed=1, batch=BATCH,
                                device="cpu")
    assert graphs["labels"].shape == (BATCH, 30)
    jp = jgatedgcn.init(jax.random.PRNGKey(2), jcfg)
    tp = from_jax_gnn_params(_np(jp), tcfg, device="cpu")
    loss, m = gatedgcn.loss_fn(tp, graphs, tcfg)
    jloss, jm = jax.vmap(lambda g: jgatedgcn.loss_fn(jp, g, jcfg))(
        {k: jnp.asarray(v.numpy()) for k, v in graphs.items()})
    assert loss.shape == jloss.shape == (BATCH, 30)
    assert_close(loss.numpy(), np.asarray(jloss), dtype="float32")
    assert_close(m["acc"].numpy(), np.asarray(jm["acc"]), dtype="float32")
    logp = torch.log_softmax(gatedgcn.apply(tp, graphs, tcfg), -1)
    want = -torch.gather(logp, -1, graphs["labels"].long())
    assert torch.equal(loss, want)
    one = {k: v[0] for k, v in graphs.items()}
    one["labels"] = graphs["labels"][0, 0]
    l1, _ = gatedgcn.loss_fn(tp, one, tcfg)
    assert l1.shape == () and torch.equal(l1, want[0, 0])


@pytest.mark.parametrize("arch", ["gatedgcn", "graphsage-reddit"])
def test_batch_axis_keeps_each_graphs_statistics(arch):
    """GatedGCN's batch-norm statistics and graph pooling, and
    GraphSAGE's means, are each graph's own on a batch axis: the batch
    gives the graphs' logits one by one."""
    _, tmod, cls, kw = _CASES[arch]
    tcfg = getattr(tmod, cls)(**kw)
    graphs = tG.molecule_graphs(arch, seed=2, batch=3, device="cpu")
    p = tmod.init(torch.Generator().manual_seed(0), tcfg)
    out = tmod.apply(p, graphs, tcfg)
    for i in range(3):
        assert_close(out[i].numpy(), tmod.apply(
            p, {k: v[i] for k, v in graphs.items()}, tcfg).numpy(),
            dtype="float32")


def test_molecule_graphs_shapes():
    meta = tG.SHAPES["molecule"]
    d = tG.molecule_graphs("dimenet", seed=0, batch=2, device="cpu")
    assert d["triplets"].shape == (2, 2, meta["trip"])
    assert d["positions"].shape == (2, meta["n"], 3)
    n = tG.molecule_graphs("nequip", seed=0, batch=2, device="cpu")
    assert "triplets" not in n and n["edge_index"].shape == (2, 2,
                                                             meta["e"])
    s = tG.molecule_graphs("graphsage-reddit", seed=0, batch=2,
                           device="cpu")
    assert s["nodes"].shape == (2, meta["n"], meta["d_feat"])
    with pytest.raises(ValueError, match="no molecule batch"):
        tG.molecule_graphs("mind", seed=0, device="cpu")
