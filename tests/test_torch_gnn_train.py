"""Training the edge-based GNNs in the port against the JAX package, on
the CPU: the same weights (the JAX package's init, through
``from_jax_gnn_params``) and the same numpy graphs give the loss, the
accuracy and every parameter's gradient within the float32 row of
``jax.value_and_grad`` — GatedGCN with its node readout (and a
``train_mask``) and its graph readout, GraphSAGE on the full graph and
on sampled minibatches (one group, and 4 groups as one batch against
the reference's vmapped step) — and ``edge_aggregate``'s gradient on its
own (sum, mean, fractional masks, destinations outside [0, n)), and one
``gnn_common.train_step`` against the body of the reference cell's step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _numerics import assert_bitwise, assert_close

from repro.configs import gnn_common as jG
from repro.data.graphs import NeighborSampler as JSampler
from repro.data.graphs import powerlaw_graph as jpowerlaw
from repro.kernels import ref as jref
from repro.models.gnn import gatedgcn as jgatedgcn
from repro.models.gnn import graphsage as jgraphsage
from repro.optim import adamw as jadamw
from repro_torch.checkpoint.manager import flatten
from repro_torch.configs import gnn_common as tG
from repro_torch.configs import graphsage_reddit as tsage_cfg
from repro_torch.convert import from_jax_gnn_params
from repro_torch.kernels import ops as kops
from repro_torch.models.gnn import gatedgcn, graphsage
from repro_torch.optim import adamw as tadamw

N, E = 40, 160


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _graph(seed, *, d_feat, n_classes, masks=True):
    """A power-law graph with some nodes and edges masked off, and a
    training mask over the rest."""
    g = jpowerlaw(N, E, d_feat=d_feat, n_classes=n_classes, seed=seed)
    rng = np.random.default_rng(seed + 100)
    if masks:
        g["node_mask"] = (rng.uniform(size=N) < 0.9).astype(np.float32)
        g["edge_mask"] = (rng.uniform(size=E) < 0.8).astype(np.float32)
        g["train_mask"] = (rng.uniform(size=N) < 0.6).astype(np.float32)
    return g


def _t(g):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in g.items()}


def _check_grads(tgrads, jgrads):
    want = dict(flatten(_np(jgrads)))
    got = dict(flatten(tgrads))
    assert set(got) == set(want)
    for name, w in want.items():
        assert_close(got[name].numpy(), w, dtype="float32", context=name)


def _value_and_grad(model, jmodel, jcfg, tcfg, jgraph, tgraph, seed, **kw):
    jp = jmodel.init(jax.random.PRNGKey(seed), jcfg)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jgraph, jcfg, **kw), has_aux=True)(jp)
    tp = from_jax_gnn_params(_np(jp), tcfg, device="cpu")
    from repro_torch.optim.step import value_and_grad
    (tl, tm), tg = value_and_grad(
        lambda p: model.loss_fn(p, tgraph, tcfg, **kw), tp)
    return (jl, jm, jg), (tl, tm, tg)


# ----------------------------------------------------------- GatedGCN ----
@pytest.mark.parametrize("seed", [0, 1])
def test_gatedgcn_node_readout_loss_and_grads(seed):
    kw = dict(n_layers=2, d_hidden=16, d_in=8, n_classes=3)
    jcfg, tcfg = jgatedgcn.GatedGCNConfig(**kw), gatedgcn.GatedGCNConfig(**kw)
    g = _graph(seed, d_feat=8, n_classes=3)
    (jl, jm, jg), (tl, tm, tg) = _value_and_grad(
        gatedgcn, jgatedgcn, jcfg, tcfg, {k: jnp.asarray(v)
                                          for k, v in g.items()}, _t(g),
        seed)
    assert_close(tl.numpy(), np.asarray(jl), dtype="float32")
    assert_close(tm["acc"].numpy(), np.asarray(jm["acc"]), dtype="float32")
    _check_grads(tg, jg)


def test_gatedgcn_graph_readout_loss_and_grads():
    kw = dict(n_layers=2, d_hidden=16, d_in=8, n_classes=3,
              readout="graph")
    jcfg, tcfg = jgatedgcn.GatedGCNConfig(**kw), gatedgcn.GatedGCNConfig(**kw)
    g = _graph(3, d_feat=8, n_classes=3)
    g.pop("train_mask")
    g["labels"] = np.asarray(2, np.int32)        # one label per graph
    (jl, jm, jg), (tl, tm, tg) = _value_and_grad(
        gatedgcn, jgatedgcn, jcfg, tcfg, {k: jnp.asarray(v)
                                          for k, v in g.items()}, _t(g), 3)
    assert tl.shape == ()
    assert_close(tl.numpy(), np.asarray(jl), dtype="float32")
    assert_bitwise(tm["acc"].numpy(), np.asarray(jm["acc"]))
    _check_grads(tg, jg)
    logits = gatedgcn.apply(from_jax_gnn_params(
        _np(jgatedgcn.init(jax.random.PRNGKey(3), jcfg)), tcfg,
        device="cpu"), _t(g), tcfg)
    assert logits.shape == (3,)


def test_gatedgcn_graph_readout_refuses_export():
    cfg = gatedgcn.GatedGCNConfig(n_layers=1, d_hidden=8, d_in=4,
                                  n_classes=2, readout="graph")
    p = gatedgcn.init(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError, match="readout='node'"):
        gatedgcn.to_graph(p, cfg)


# ---------------------------------------------------------- GraphSAGE ----
def _sage_cfgs(**over):
    kw = dict(n_layers=2, d_hidden=16, d_in=8, n_classes=3,
              sample_sizes=(3, 2), **over)
    return jgraphsage.GraphSAGEConfig(**kw), graphsage.GraphSAGEConfig(**kw)


def test_graphsage_full_graph_loss_and_grads():
    jcfg, tcfg = _sage_cfgs()
    g = _graph(5, d_feat=8, n_classes=3)
    (jl, jm, jg), (tl, tm, tg) = _value_and_grad(
        graphsage, jgraphsage, jcfg, tcfg, {k: jnp.asarray(v)
                                            for k, v in g.items()}, _t(g), 5)
    assert_close(tl.numpy(), np.asarray(jl), dtype="float32")
    assert_close(tm["acc"].numpy(), np.asarray(jm["acc"]), dtype="float32")
    _check_grads(tg, jg)


def _sampled(seed, groups, seeds=6):
    g = jpowerlaw(N, E, d_feat=8, n_classes=3, seed=seed)
    sampler = JSampler(g["edge_index"], N, g["nodes"], g["labels"],
                       fanouts=(3, 2), seed=seed)
    return [sampler.sample(np.arange(i * seeds, (i + 1) * seeds) % N)
            for i in range(groups)]


def _tbatch(b):
    return {"feats": torch.from_numpy(b["feats"]),
            "edges": [torch.from_numpy(e) for e in b["edges"]],
            "labels": torch.from_numpy(b["labels"])}


@pytest.mark.parametrize("normalize", [True, False])
def test_graphsage_sampled_loss_and_grads(normalize):
    jcfg, tcfg = _sage_cfgs(normalize=normalize)
    (b,) = _sampled(7, 1)
    jb = jax.tree_util.tree_map(jnp.asarray, b)
    (jl, jm, jg), (tl, tm, tg) = _value_and_grad(
        graphsage, jgraphsage, jcfg, tcfg, jb, _tbatch(b), 7, sampled=True)
    assert_close(tl.numpy(), np.asarray(jl), dtype="float32")
    assert_close(tm["acc"].numpy(), np.asarray(jm["acc"]), dtype="float32")
    _check_grads(tg, jg)
    jp = jgraphsage.init(jax.random.PRNGKey(7), jcfg)
    tp = from_jax_gnn_params(_np(jp), tcfg, device="cpu")
    assert_close(graphsage.apply_sampled(tp, _tbatch(b), tcfg).numpy(),
                 np.asarray(jgraphsage.apply_sampled(jp, jb, jcfg)),
                 dtype="float32")


def test_graphsage_sampled_groups_step_matches_reference_vmap():
    """4 groups as one batch (one pass, one launch a layer and frontier)
    against the reference's ``_sampled_cell`` step body (vmap over
    groups, the mean the loss), one AdamW step."""
    jcfg, tcfg = _sage_cfgs()
    groups = _sampled(9, 4)
    jbatch = {"feats": jnp.stack([b["feats"] for b in groups]),
              "edges": [jnp.stack([b["edges"][i] for b in groups])
                        for i in range(2)],
              "labels": jnp.stack([b["labels"] for b in groups])}
    jp = jgraphsage.init(jax.random.PRNGKey(9), jcfg)
    js = jadamw.adamw_init(jp, jG.OCFG)

    def lf(p):
        losses, metrics = jax.vmap(lambda b: jgraphsage.loss_fn(
            p, b, jcfg, sampled=True))(jbatch)
        return losses.mean(), {k: v.mean() for k, v in metrics.items()}
    (jl, jm), jg = jax.value_and_grad(lf, has_aux=True)(jp)
    jp2, js2, _ = jadamw.adamw_update(jg, js, jp, lr=jG.LR(js["step"]),
                                      cfg=jG.OCFG)
    tp = from_jax_gnn_params(_np(jp), tcfg, device="cpu")
    ts = tadamw.adamw_init(tp, tG.OCFG)
    tbatch = tsage_cfg.stack_groups(groups, device="cpu")
    tp2, ts2, tm = tsage_cfg.sampled_train_step(tcfg)(tp, ts, tbatch)
    assert_close(tm["loss"].numpy(), np.asarray(jl), dtype="float32")
    assert_close(tm["acc"].numpy(), np.asarray(jm["acc"]), dtype="float32")
    for (name, got), (_, want) in zip(flatten({"p": tp2, "s": ts2}),
                                      flatten(_np({"p": jp2, "s": js2}))):
        assert_close(got.numpy(), want, dtype="float32", context=name)


def test_gnn_common_train_step_matches_reference_step():
    """One ``gnn_common.train_step`` (GatedGCN, node readout) against the
    body of the reference's ``make_train_cell`` step."""
    kw = dict(n_layers=2, d_hidden=16, d_in=8, n_classes=3)
    jcfg, tcfg = jgatedgcn.GatedGCNConfig(**kw), gatedgcn.GatedGCNConfig(**kw)
    g = _graph(11, d_feat=8, n_classes=3)
    jg_ = {k: jnp.asarray(v) for k, v in g.items()}
    jp = jgatedgcn.init(jax.random.PRNGKey(11), jcfg)
    js = jadamw.adamw_init(jp, jG.OCFG)
    (jl, jm), grads = jax.value_and_grad(
        lambda p: jgatedgcn.loss_fn(p, jg_, jcfg), has_aux=True)(jp)
    jp2, js2, jaux = jadamw.adamw_update(grads, js, jp,
                                         lr=jG.LR(js["step"]), cfg=jG.OCFG)
    tp = from_jax_gnn_params(_np(jp), tcfg, device="cpu")
    ts = tadamw.adamw_init(tp, tG.OCFG)
    tp2, ts2, tm = tG.train_step(gatedgcn, tcfg)(tp, ts, _t(g))
    assert_close(tm["loss"].numpy(), np.asarray(jl), dtype="float32")
    assert_close(tm["grad_norm"].numpy(), np.asarray(jaux["grad_norm"]),
                 dtype="float32")
    assert int(ts2["step"]) == int(js2["step"]) == 1
    for (name, got), (_, want) in zip(flatten({"p": tp2, "s": ts2}),
                                      flatten(_np({"p": jp2, "s": js2}))):
        assert_close(got.numpy(), want, dtype="float32", context=name)


# ------------------------------------------- edge_aggregate's gradient ----
def _edge_inputs(seed, *, n=12, e=50, d=5, frac=False, out_of_range=False):
    rng = np.random.default_rng(seed)
    msg = rng.normal(size=(e, d)).astype(np.float32)
    ei = rng.integers(0, n, size=(2, e)).astype(np.int32)
    if out_of_range:
        ei[1, ::7] = n + rng.integers(0, 3, size=ei[1, ::7].shape)
    mask = (rng.uniform(size=e) if frac else
            (rng.uniform(size=e) < 0.7)).astype(np.float32)
    cot = rng.normal(size=(n, d)).astype(np.float32)
    return msg, ei, mask, cot, n


@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("frac,out_of_range", [(False, False), (True, False),
                                               (False, True), (True, True)])
def test_edge_aggregate_grad_matches_jax(reduce, frac, out_of_range):
    """d/dmessages of <cot, edge_aggregate(...)> against ``jax.grad`` of
    the reference's segment-sum composition; a dst at or past n takes no
    gradient."""
    msg, ei, mask, cot, n = _edge_inputs(3, frac=frac,
                                         out_of_range=out_of_range)
    want = jax.grad(lambda m: (jref.edge_aggregate_ref(
        m, jnp.asarray(ei), n, jnp.asarray(mask), reduce=reduce)
        * cot).sum())(jnp.asarray(msg))
    t = torch.from_numpy(msg).requires_grad_(True)
    out = kops.edge_aggregate(t, torch.from_numpy(ei), n,
                              torch.from_numpy(mask), reduce=reduce)
    (got,) = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), t)
    assert_close(got.numpy(), np.asarray(want), dtype="float32")
    if out_of_range:
        assert not got[torch.from_numpy(ei[1] >= n)].any()


@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_edge_aggregate_grad_batched_negative_dst(reduce):
    """The batched op's gradient: each graph's edges take their own
    graph's cotangent; a negative dst takes none; against autograd of a
    float64 index_add formulation."""
    rng = np.random.default_rng(5)
    b, e, n, d = 3, 40, 9, 4
    msg = torch.from_numpy(rng.normal(size=(b, e, d)))
    ei = torch.from_numpy(rng.integers(-2, n + 2, size=(b, 2, e)))
    mask = torch.from_numpy(rng.uniform(size=(b, e)))
    cot = torch.from_numpy(rng.normal(size=(b, n, d)))
    t = msg.float().requires_grad_(True)
    out = kops.edge_aggregate_batched(t, ei, n, mask.float(), reduce=reduce)
    (got,) = torch.autograd.grad((out * cot.float()).sum(), t)
    m64 = msg.clone().requires_grad_(True)
    dst = ei[:, 1]
    ok = (dst >= 0) & (dst < n)
    w = torch.where(ok, mask, 0.0)
    outs = []
    for i in range(b):
        idx = torch.where(ok[i], dst[i], 0)
        s = torch.zeros(n, d, dtype=torch.float64).index_add(
            0, idx, m64[i] * w[i][:, None])
        if reduce == "mean":
            cnt = torch.zeros(n, dtype=torch.float64).index_add(0, idx, w[i])
            s = s / torch.clamp_min(cnt, 1.0)[:, None]
        outs.append(s)
    (want,) = torch.autograd.grad((torch.stack(outs) * cot).sum(), m64)
    assert_close(got.numpy(), want.float().numpy(), dtype="float32")
    assert not got[~ok].any()


def test_edge_aggregate_mask_is_data():
    msg, ei, mask, _, n = _edge_inputs(1)
    m = torch.from_numpy(mask).requires_grad_(True)
    with pytest.raises(ValueError, match="edge_mask is data"):
        kops.edge_aggregate(torch.from_numpy(msg), torch.from_numpy(ei), n,
                            m)


def test_edge_aggregate_forward_unchanged_by_grad():
    """The differentiable route's forward is the plain version's, bit for
    bit, and a call without a gradient builds no graph."""
    msg, ei, mask, _, n = _edge_inputs(2, frac=True, out_of_range=True)
    args = (torch.from_numpy(ei), n, torch.from_numpy(mask))
    for reduce in ("sum", "mean"):
        plain = kops.edge_aggregate(torch.from_numpy(msg), *args,
                                    reduce=reduce)
        assert plain.grad_fn is None
        with_grad = kops.edge_aggregate(
            torch.from_numpy(msg).requires_grad_(True), *args, reduce=reduce)
        assert with_grad.grad_fn is not None
        assert_bitwise(with_grad.detach().numpy(), plain.numpy())
