"""DimeNet and NequIP in the port against the JAX package, on the CPU, at
the smoke configs: the reference's weights (its ``init`` through
``convert.from_jax_gnn_params``) and the same numpy graphs give, within
the float32 row, DimeNet's energies, loss and every gradient, and
NequIP's energies, forces and the gradients of its force-weighted loss
(second order: through the forces' own backward, which is
``edge_aggregate``'s gather) — on the smoke graphs and on graphs with
padded edges and triplets. The converters refuse a missing, extra or
misshapen leaf. Every reference call is jitted and computed once per
module. Then, on the port alone: DimeNet's invariance and NequIP's
equivariance under rotation and translation, at the reference test's
tolerances, over several seeds; a batch of graphs on a leading axis
equal to the graphs one by one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _numerics import assert_close
from test_torch_lm import _two_threads  # noqa: F401 (autouse)

from repro.models.gnn import dimenet as jdimenet
from repro.models.gnn import nequip as jnequip
from repro.optim import adamw as jadamw
from repro_torch.checkpoint.manager import flatten
from repro_torch.configs import dimenet as tdimenet_cfg
from repro_torch.configs import nequip as tnequip_cfg
from repro_torch.convert import from_jax_adamw_state, from_jax_gnn_params
from repro_torch.data.graphs import build_triplets, geometric_graph
from repro_torch.models.gnn import dimenet, nequip
from repro_torch.models.gnn.sph import _random_rotation
from repro_torch.optim.step import value_and_grad

FORCE_WEIGHT = 0.1


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(g):
    return {k: torch.from_numpy(np.array(v)) for k, v in g.items()}


def _close_trees(got, want, context=""):
    got, want = dict(flatten(got)), dict(flatten(_np(want)))
    assert set(got) == set(want)
    for name, w in want.items():
        assert_close(got[name].detach().numpy(), w, dtype="float32",
                     context=f"{context}{name}")


# ------------------------------------------------------------- graphs ----
def _dimenet_graph(kind):
    """The smoke graph (24 atoms, 128 edges, its 512 triplets filled), or
    one with padded edges and padded triplets."""
    if kind == "smoke":
        g = geometric_graph(24, cutoff=1.8, box=3.0, n_species=4, seed=0,
                            max_edges=128)
        budget = 512
    else:
        g = geometric_graph(16, cutoff=1.8, box=4.0, n_species=4, seed=5,
                            max_edges=96)
        budget = 400
    g["triplets"], g["triplet_mask"] = build_triplets(
        g["edge_index"], g["edge_mask"], max_triplets=budget)
    return g


def _nequip_graph(kind):
    """The smoke graph (20 atoms, 96 edges, all real), or one with padded
    edges; each with force labels, so the loss has its force term."""
    if kind == "smoke":
        g = geometric_graph(20, cutoff=1.8, box=3.0, n_species=4, seed=0,
                            max_edges=96)
    else:
        g = geometric_graph(16, cutoff=1.8, box=4.0, n_species=4, seed=5,
                            max_edges=96)
    n = g["positions"].shape[0]
    g["forces"] = np.random.default_rng(n).normal(
        size=(n, 3)).astype(np.float32)
    g["node_mask"][-1] = 0.0    # one atom masked off
    return g


# ----------------------------------------------------------- DimeNet ----
@pytest.fixture(scope="module", params=["smoke", "padded"])
def dimenet_case(request):
    kind = request.param
    jcfg = jdimenet.DimeNetConfig(n_blocks=2, d_hidden=16, n_bilinear=4,
                                  n_spherical=3, n_radial=3)
    g = _dimenet_graph(kind)
    if kind == "padded":
        assert g["edge_mask"].min() == 0 and g["triplet_mask"].min() == 0
    else:
        assert g["triplet_mask"].min() == 1
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    jp = jdimenet.init(jax.random.PRNGKey(7), jcfg)
    apply = jax.jit(lambda p, gr: jdimenet.apply(p, gr, jcfg))
    vg = jax.jit(jax.value_and_grad(
        lambda p, gr: jdimenet.loss_fn(p, gr, jcfg), has_aux=True))
    (e, e_n) = apply(jp, jg)
    (loss, metrics), grads = vg(jp, jg)
    return {"g": g, "jp": jp, "e": e, "e_n": e_n, "loss": loss,
            "metrics": metrics, "grads": grads}


def test_dimenet_apply_loss_and_grads_match_reference(dimenet_case):
    c = dimenet_case
    cfg = tdimenet_cfg.smoke_config()
    tp = from_jax_gnn_params(_np(c["jp"]), cfg, device="cpu")
    g = _t(c["g"])
    e, e_n = dimenet.apply(tp, g, cfg)
    assert_close(e.numpy(), np.asarray(c["e"]), dtype="float32")
    assert_close(e_n.numpy(), np.asarray(c["e_n"]), dtype="float32")
    (loss, metrics), grads = value_and_grad(
        lambda p: dimenet.loss_fn(p, g, cfg), tp)
    assert_close(loss.numpy(), np.asarray(c["loss"]), dtype="float32")
    assert_close(metrics["energy"].numpy(),
                 np.asarray(c["metrics"]["energy"]), dtype="float32")
    _close_trees(grads, c["grads"], "grad ")
    # out_rbf is a parameter the forward never reads, as in the reference
    assert not bool(grads["out_rbf"]["w"].any())


# ------------------------------------------------------------ NequIP ----
@pytest.fixture(scope="module", params=["smoke", "padded"])
def nequip_case(request):
    kind = request.param
    jcfg = jnequip.NequIPConfig(n_layers=2, mult=8, l_max=2, n_rbf=4)
    g = _nequip_graph(kind)
    if kind == "padded":
        assert g["edge_mask"].min() == 0
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    jp = jnequip.init(jax.random.PRNGKey(3), jcfg)
    apply = jax.jit(lambda p, gr: jnequip.apply(p, gr, jcfg))
    forces = jax.jit(lambda p, gr: jnequip.forces(p, gr, jcfg))
    vg = jax.jit(jax.value_and_grad(
        lambda p, gr: jnequip.loss_fn(p, gr, jcfg,
                                      force_weight=FORCE_WEIGHT),
        has_aux=True))
    e, e_atom = apply(jp, jg)
    (loss, metrics), grads = vg(jp, jg)
    return {"g": g, "jp": jp, "e": e, "e_atom": e_atom,
            "forces": forces(jp, jg), "loss": loss, "metrics": metrics,
            "grads": grads}


def test_nequip_apply_and_forces_match_reference(nequip_case):
    c = nequip_case
    cfg = tnequip_cfg.smoke_config()
    tp = from_jax_gnn_params(_np(c["jp"]), cfg, device="cpu")
    g = _t(c["g"])
    e, e_atom = nequip.apply(tp, g, cfg)
    assert_close(e.numpy(), np.asarray(c["e"]), dtype="float32")
    assert_close(e_atom.numpy(), np.asarray(c["e_atom"]), dtype="float32")
    f = nequip.forces(tp, g, cfg)
    assert not f.requires_grad
    assert_close(f.numpy(), np.asarray(c["forces"]), dtype="float32")


def test_nequip_force_weighted_loss_grads_match_reference(nequip_case):
    """The force term's gradient is second order, through
    ``edge_aggregate``'s autograd function and its gather backward."""
    c = nequip_case
    cfg = tnequip_cfg.smoke_config()
    tp = from_jax_gnn_params(_np(c["jp"]), cfg, device="cpu")
    g = _t(c["g"])
    (loss, metrics), grads = value_and_grad(
        lambda p: nequip.loss_fn(p, g, cfg, force_weight=FORCE_WEIGHT), tp)
    assert_close(loss.numpy(), np.asarray(c["loss"]), dtype="float32")
    assert_close(metrics["energy"].numpy(),
                 np.asarray(c["metrics"]["energy"]), dtype="float32")
    _close_trees(grads, c["grads"], "grad ")
    # the force term moves the loss and the gradients: not energy alone
    (loss0, _), grads0 = value_and_grad(
        lambda p: nequip.loss_fn(p, g, cfg), tp)
    assert float(loss) > float(loss0)
    assert not torch.equal(grads["readout1"]["w"], grads0["readout1"]["w"])


def test_nequip_forces_gradcheck_in_float64():
    """The second order on its own: ``torch.autograd.gradcheck`` of the
    force-weighted loss in one parameter, in float64, through the
    kernel's autograd function (its CPU route swapped for a float64 sum)."""
    from repro_torch.kernels import ops as kops
    kw = dict(n_layers=1, mult=2, l_max=2, n_rbf=3, radial_hidden=4)
    cfg = nequip.NequIPConfig(**kw)
    g = _t(_nequip_graph("padded"))
    g = {k: v.double() if v.is_floating_point() else v for k, v in g.items()}
    p = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.asarray(a, np.float64)),
        _np(jnequip.init(jax.random.PRNGKey(1), jnequip.NequIPConfig(**kw))))
    saved = kops._ref.edge_aggregate_ref

    def f64(messages, dst, mask, *, n_nodes, reduce="sum"):
        b_, e_, d_ = messages.shape
        out = messages.new_zeros((b_, n_nodes, d_))
        return out.scatter_add(1, dst.long()[..., None].expand(b_, e_, d_),
                               messages * mask[..., None].double())
    kops._ref.edge_aggregate_ref = f64
    try:
        def loss(w):
            q = dict(p)
            q["readout1"] = {"w": w, "b": p["readout1"]["b"]}
            lay = dict(p["layers"][0])
            q["layers"] = [lay]
            return nequip.loss_fn(q, g, cfg, force_weight=1.0)[0]
        w0 = p["readout1"]["w"].clone().requires_grad_(True)
        assert torch.autograd.gradcheck(loss, (w0,), eps=1e-6, atol=1e-6)
        r0 = p["layers"][0]["radial"][1]["w"].clone().requires_grad_(True)

        def loss_r(w):
            q = dict(p)
            lay = dict(p["layers"][0])
            lay["radial"] = [lay["radial"][0], {"w": w,
                                                "b": lay["radial"][1]["b"]}]
            q["layers"] = [lay]
            return nequip.loss_fn(q, g, cfg, force_weight=1.0)[0]
        assert torch.autograd.gradcheck(loss_r, (r0,), eps=1e-6, atol=1e-6)
    finally:
        kops._ref.edge_aggregate_ref = saved


# -------------------------------------------------------- converters ----
@pytest.mark.parametrize("arch", ["dimenet", "nequip"])
def test_converters_take_the_geometric_trees_and_refuse_bad_ones(arch):
    jmod, mod = ((jdimenet, tdimenet_cfg) if arch == "dimenet"
                 else (jnequip, tnequip_cfg))
    cfg = mod.smoke_config()
    jcfg = (jdimenet.DimeNetConfig(**cfg.__dict__) if arch == "dimenet"
            else jnequip.NequIPConfig(**cfg.__dict__))
    jp = _np(jmod.init(jax.random.PRNGKey(0), jcfg))
    tp = from_jax_gnn_params(jp, cfg, device="cpu")
    _close_trees(tp, jp)
    js = _np(jadamw.adamw_init(jmod.init(jax.random.PRNGKey(0), jcfg),
                               jadamw.AdamWConfig()))
    ts = from_jax_adamw_state(js, cfg, device="cpu")
    assert int(ts["step"]) == 0
    _close_trees(ts["m"], js["m"])
    # shapes of the port's own init are the reference's
    own = mod.model.init(torch.Generator().manual_seed(0), cfg)
    assert [(n, tuple(t.shape)) for n, t in flatten(own)] == \
        [(n, tuple(np.shape(a))) for n, a in flatten(jp)]
    if arch == "dimenet":
        missing = {k: v for k, v in jp.items() if k != "out_rbf"}
        extra = dict(jp, out_rbf={**jp["out_rbf"], "b": np.zeros(16)})
        bad = dict(jp, blocks=[dict(jp["blocks"][0],
                                    w_bil=np.zeros((4, 16, 15))),
                               jp["blocks"][1]])
    else:
        missing = dict(jp, layers=[dict(jp["layers"][0], skip={
            k: v for k, v in jp["layers"][0]["skip"].items()
            if k != "l1p-1"})] + jp["layers"][1:])
        extra = dict(jp, layers=[dict(jp["layers"][0], self=dict(
            jp["layers"][0]["self"], **{"l2p1": {
                "w": jp["layers"][0]["self"]["l2p1"]["w"],
                "b": np.zeros(8)}}))] + jp["layers"][1:])
        bad = dict(jp, embed_z={"w": np.zeros((4, 8))})
    for tree, match in ((missing, "keys"), (extra, "keys"),
                        (bad, "shape")):
        with pytest.raises(ValueError, match=match):
            from_jax_gnn_params(tree, cfg, device="cpu")


# ------------------------------------------------ properties, port only ----
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_dimenet_invariance(seed):
    """Energies invariant under a global rotation and translation
    (distances and angles only), at the reference test's rtol 1e-4."""
    cfg = dimenet.DimeNetConfig(n_blocks=2, d_hidden=16, n_bilinear=4)
    gg = geometric_graph(20, cutoff=1.8, box=3.0, n_species=4, seed=seed + 3,
                         max_edges=96)
    gg["triplets"], gg["triplet_mask"] = build_triplets(
        gg["edge_index"], gg["edge_mask"], max_triplets=256)
    g = _t(gg)
    p = dimenet.init(torch.Generator().manual_seed(seed), cfg)
    e0, _ = dimenet.apply(p, g, cfg)
    rot = torch.from_numpy(_random_rotation(
        np.random.default_rng(seed + 4))).float()
    g2 = dict(g, positions=g["positions"] @ rot.T + 2.5)
    e1, _ = dimenet.apply(p, g2, cfg)
    np.testing.assert_allclose(float(e0), float(e1), rtol=1e-4)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_nequip_equivariance(seed):
    """Energies invariant and forces rotating with the positions, at the
    reference test's tolerances."""
    cfg = nequip.NequIPConfig(n_layers=2, mult=4, n_rbf=4)
    g = _t(geometric_graph(12, cutoff=1.8, box=2.5, n_species=4,
                           seed=seed, max_edges=64))
    p = nequip.init(torch.Generator().manual_seed(seed % 100), cfg)
    e0, _ = nequip.apply(p, g, cfg)
    f0 = nequip.forces(p, g, cfg)
    rot = torch.from_numpy(_random_rotation(
        np.random.default_rng(seed + 1))).float()
    g2 = dict(g, positions=g["positions"] @ rot.T + 1.0)
    e1, _ = nequip.apply(p, g2, cfg)
    f1 = nequip.forces(p, g2, cfg)
    assert abs(float(e0 - e1)) < 1e-4 * max(1.0, abs(float(e0)))
    np.testing.assert_allclose(f1.numpy(), (f0 @ rot.T).numpy(),
                               rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("arch", ["dimenet", "nequip"])
def test_batch_axis_equals_graphs_one_by_one(arch):
    """A stack of graphs on a leading axis gives each graph's own
    energies (one ``edge_aggregate`` launch a scatter for the batch)."""
    from repro_torch.configs import gnn_common as G
    mod = tdimenet_cfg if arch == "dimenet" else tnequip_cfg
    cfg = mod.smoke_config()
    gs = G.molecule_graphs(arch, seed=4, batch=3, device="cpu")
    p = mod.model.init(torch.Generator().manual_seed(1), cfg)
    e, e_n = mod.model.apply(p, gs, cfg)
    assert e.shape == (3,) and e_n.shape == (3, 30)
    for i in range(3):
        ei, ei_n = mod.model.apply(p, {k: v[i] for k, v in gs.items()}, cfg)
        assert_close(e[i].numpy(), ei.numpy(), dtype="float32")
        assert_close(e_n[i].numpy(), ei_n.numpy(), dtype="float32")
    if arch == "nequip":
        f = nequip.forces(p, gs, cfg)
        f0 = nequip.forces(p, {k: v[0] for k, v in gs.items()}, cfg)
        assert_close(f[0].numpy(), f0.numpy(), dtype="float32")
