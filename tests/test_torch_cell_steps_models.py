"""CaloClusterNet's, the four GNNs' and MIND's cell steps in the port
against the JAX package's, on the CPU, as ``test_torch_cell_steps.py``
holds the LM's: ``make_step(mesh)`` at smoke width on a world of one
(gloo) against the reference's jitted ``make_step`` on its (1, 1) host
mesh, same numpy inputs and weights, within the float32 row:
CaloClusterNet's serve (CPS) and train steps, GatedGCN's, GraphSAGE's,
DimeNet's and NequIP's train steps, MIND's train, scoring and retrieval.
"""
import jax
import numpy as np
import pytest
import torch
from _blas_threads import _blas_two_threads  # noqa: F401 (autouse)
from test_torch_cell_steps import host  # noqa: F401 (the fixture)
from test_torch_cell_steps import _check, _jit, _np, _run, _t, jhost_mesh
from test_torch_lm import _two_threads  # noqa: F401 (autouse)

from repro import configs as jconfigs
from repro.configs import gnn_common as jG
from repro.optim import adamw as jadamw
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.configs import gnn_common as tG
from repro_torch.configs.base import sds


def _ccn(kind, host):
    from repro.configs import caloclusternet as jmod
    from repro.core import caloclusternet as jccn
    from repro.data.belle2 import Belle2Config, generate
    tmod = tconfigs.get_arch("caloclusternet")
    cfg = jmod.smoke_config()
    gen = Belle2Config(n_crystals=576, grid=(24, 24), n_hits=cfg.n_hits,
                       noise_rate=4.0)
    b = generate(gen, 8, seed=2)
    params = _np(jccn.init(jax.random.PRNGKey(2), cfg))
    tparams = convert.from_jax_params(params, tmod.smoke_config(),
                                      device="cpu")
    keys = ["feats", "mask"] + (["object_id", "energy", "cls"]
                                if kind == "train" else [])
    feeds = {k: np.asarray(b[k]) for k in keys}
    jmesh = jhost_mesh()
    if kind == "serve":
        want = _jit(jmod._serve_cell(cfg, "trigger_serve", 8).make_step(
            jmesh))(params, feeds)
        tcell = tmod._serve_cell(tmod.smoke_config(), "trigger_serve", 8)
        got = _run(tcell, host, (tparams, _t(feeds)))
    else:
        opt = _np(jadamw.adamw_init(params, jmod.OCFG))
        want = _jit(jmod._train_cell(cfg, "condensation_train", 8).make_step(
            jmesh))(params, opt, feeds)
        tcell = tmod._train_cell(tmod.smoke_config(), "condensation_train",
                                 8)
        got = _run(tcell, host, (tparams, convert.from_jax_adamw_state(
            opt, tmod.smoke_config(), device="cpu"), _t(feeds)))
    _check(got, want)


def _gnn(arch, host):
    jmod, tmod = jconfigs.get_arch(arch), tconfigs.get_arch(arch)
    jcfg, tcfg = jmod.smoke_config(), tmod.smoke_config()
    geometric = arch in ("dimenet", "nequip")
    if geometric:
        from repro.data.graphs import build_triplets, geometric_graph
        g = geometric_graph(20, cutoff=1.8, box=3.0, n_species=4, seed=5,
                            max_edges=96)
        if arch == "dimenet":
            g["triplets"], g["triplet_mask"] = build_triplets(
                g["edge_index"], g["edge_mask"], max_triplets=256)
    else:
        from repro.data.graphs import powerlaw_graph
        g = powerlaw_graph(32, 96, d_feat=8, n_classes=3, seed=5)
    g = {k: np.asarray(v) for k, v in g.items()}
    params = _np(jmod.model.init(jax.random.PRNGKey(5), jcfg))
    opt = _np(jadamw.adamw_init(params, jG.OCFG))
    meta = {"n": g["node_mask"].shape[0], "e": g["edge_mask"].shape[0]}
    jcell = jG.make_train_cell(arch, "full_graph_sm", jmod.model, jcfg,
                               None, None)
    want = _jit(jcell.make_step(jhost_mesh()))(params, opt, g)
    gs = {k: sds(v.shape, torch.from_numpy(v).dtype) for k, v in g.items()}
    tcell = tG.make_train_cell(arch, "full_graph_sm", tmod.model, tcfg, gs,
                               tG.graph_specs(gs, edge_dp=True))
    got = _run(tcell, host, (convert.from_jax_gnn_params(
        params, tcfg, device="cpu"), convert.from_jax_adamw_state(
        opt, tcfg, device="cpu"), _t(g)))
    assert meta["e"] > 0
    _check(got, want)


def _mind(kind, host):
    from repro.configs import mind as jmod
    from repro.data.recsys import mind_batch
    from repro.models import recsys as jrec
    tmod = tconfigs.get_arch("mind")
    cfg, tcfg = jmod.smoke_config(), tmod.smoke_config()
    params = _np(jrec.init(jax.random.PRNGKey(6), cfg))
    tparams = convert.from_jax_mind_params(params, tcfg, device="cpu")
    batch = {k: np.asarray(v) for k, v in mind_batch(
        n_items=cfg.n_items, n_user_tags=cfg.n_user_tags,
        hist_len=cfg.hist_len, tag_bag=cfg.tag_bag, batch=16, seed=6,
        step=0).items()}
    jmesh = jhost_mesh()
    if kind == "train":
        opt = _np(jadamw.adamw_init(params, jmod.OCFG))
        want = _jit(jmod._train_cell(cfg, 16).make_step(jmesh))(
            params, opt, batch)
        tcell = tmod._train_cell(tcfg, 16)
        got = _run(tcell, host, (tparams, convert.from_jax_adamw_state(
            opt, tcfg, device="cpu"), _t(batch)))
    else:
        meta = ({"batch": 16, "cands": 40} if kind == "serve" else
                {"batch": 1, "cands": cfg.n_items, "shared_cands": True,
                 "topk": 10})
        user = {k: batch[k][:meta["batch"]]
                for k in ("behav_ids", "behav_mask", "tag_ids")}
        rng = np.random.default_rng(7)
        user["cand_ids"] = (np.arange(cfg.n_items, dtype=np.int32)
                            if kind == "retrieval" else rng.integers(
                                0, cfg.n_items, (16, 40)).astype(np.int32))
        want = _jit(jmod._serve_cell(cfg, "serve_p99", meta).make_step(
            jmesh))(params, user)
        tcell = tmod._serve_cell(tcfg, "serve_p99", meta)
        got = _run(tcell, host, (tparams, _t(user)))
    _check(got, want)


STEPS = {
    "ccn-serve": lambda h: _ccn("serve", h),
    "ccn-train": lambda h: _ccn("train", h),
    "gatedgcn": lambda h: _gnn("gatedgcn", h),
    "graphsage": lambda h: _gnn("graphsage-reddit", h),
    "dimenet": lambda h: _gnn("dimenet", h),
    "nequip": lambda h: _gnn("nequip", h),
    "mind-train": lambda h: _mind("train", h),
    "mind-serve": lambda h: _mind("serve", h),
    "mind-retrieval": lambda h: _mind("retrieval", h),
}


@pytest.mark.parametrize("case", list(STEPS))
def test_step_on_a_world_of_one_matches_reference(host, case):
    STEPS[case](host)
