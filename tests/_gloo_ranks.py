"""One rank of a CPU multi-process check over gloo, run as a script:

    python tests/_gloo_ranks.py CASE RANK WORLD PORT OUTDIR

``lm``: on a (2, 2) ("data", "model") mesh of 4 ranks, the arguments
placed by the cells' shardings: olmo-1b's smoke config, one train step
(``lm_common.train_cell``) and one decode step (``decode_cell``,
decode_32k's layout and long_500k's, whose cache is split on its
positions); granite-moe-1b-a400m's smoke train step (the MoE dispatch
under a mesh); MIND's smoke train step (its tables split over the
model axis); GatedGCN's, DimeNet's and NequIP's smoke train steps with
their edges split over dp; and ``edge_aggregate``'s mean over edges split over dp with fractional
masks. Rank 0 writes the gathered results (and the same steps on plain
tensors, ``mesh=None``) to OUTDIR/lm.npz.

``compress``: 3 rounds of ``optim.compress.compressed_psum`` of each
rank's own gradient (drawn from seed 100 + RANK) over the world; every
rank writes its results to OUTDIR/compress_RANK.npz.
"""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

CASE, RANK, WORLD, PORT, OUT = (sys.argv[1], int(sys.argv[2]),
                                int(sys.argv[3]), int(sys.argv[4]),
                                sys.argv[5])
torch.set_num_threads(1)


def _np(tree, prefix=""):
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_np(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, t in enumerate(tree):
            out.update(_np(t, f"{prefix}{i}/"))
        return out
    if isinstance(tree, DTensor):
        tree = tree.full_tensor()
    return {prefix[:-1]: tree.detach().numpy()}


def lm():
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_arch, lm_common
    from repro_torch.configs.base import distribute
    from repro_torch.models import transformer as tr
    from repro_torch.optim import adamw_init
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    cfg = get_arch("olmo-1b").smoke_config()
    gen = torch.Generator().manual_seed(0)
    params = tr.init_params(gen, cfg)
    tokens = torch.randint(0, cfg.vocab, (4, 16), generator=gen,
                           dtype=torch.int32)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    cell = lm_common.train_cell("olmo-1b", cfg, batch=4, seq=16)
    ocfg = lm_common.opt_config(cfg, quantize=False)
    args = (params, adamw_init(params, ocfg), batch)
    got = cell.make_step(mesh)(*distribute(args, cell.resolve_shardings(
        mesh)))
    want = cell.make_step(None)(*args)
    res = {f"train/got/{k}": v for k, v in _np(got).items()}
    res.update({f"train/want/{k}": v for k, v in _np(want).items()})

    cache = tr.init_cache(cfg, 4, 24, dtype=torch.float32, device="cpu")
    cache["pos"] = torch.full_like(cache["pos"], 5)
    cache["k"] = torch.randn(cache["k"].shape, generator=gen)
    cache["v"] = torch.randn(cache["v"].shape, generator=gen)
    dcell = lm_common.decode_cell("olmo-1b", cfg, "decode_32k", batch=4,
                                  seq=24)
    dargs = (params, cache, tokens[:, :1])
    got = dcell.make_step(mesh)(*distribute(dargs, dcell.resolve_shardings(
        mesh)))
    want = dcell.make_step(None)(*dargs)
    res.update({f"decode/got/{k}": v for k, v in _np(got).items()})
    res.update({f"decode/want/{k}": v for k, v in _np(want).items()})

    # long_500k's layout: one sequence, the cache split on its positions
    # over dp (each shard writes the rows it holds)
    lcell = lm_common.decode_cell("olmo-1b", cfg, "long_500k", batch=1,
                                  seq=24)
    largs = (params, {k: v[:, :1].clone() for k, v in cache.items()},
             tokens[:1, :1])
    got = lcell.make_step(mesh)(*distribute(largs, lcell.resolve_shardings(
        mesh)))
    want = lcell.make_step(None)(*largs)
    res.update({f"long/got/{k}": v for k, v in _np(got).items()})
    res.update({f"long/want/{k}": v for k, v in _np(want).items()})

    # GatedGCN's smoke train step, the edges split over dp (1D edge
    # partitioning: each node sum a Partial over the edge shards)
    from repro_torch.configs import gnn_common as G
    from repro_torch.configs.base import sds
    from repro_torch.data.graphs import powerlaw_graph
    from repro_torch.models.gnn import gatedgcn
    gcfg = get_arch("gatedgcn").smoke_config()
    graph = {k: torch.from_numpy(v) for k, v in powerlaw_graph(
        32, 96, d_feat=8, n_classes=3, seed=5).items()}
    gs = {k: sds(v.shape, v.dtype) for k, v in graph.items()}
    gcell = G.make_train_cell("gatedgcn", "full_graph_sm", gatedgcn, gcfg,
                              gs, G.graph_specs(gs, edge_dp=True))
    gp = gatedgcn.init(torch.Generator().manual_seed(5), gcfg)
    gargs = (gp, adamw_init(gp, G.OCFG), graph)
    got = gcell.make_step(mesh)(*distribute(gargs, gcell.resolve_shardings(
        mesh)))
    want = gcell.make_step(None)(*gargs)
    res.update({f"gnn/got/{k}": v for k, v in _np(got).items()})
    res.update({f"gnn/want/{k}": v for k, v in _np(want).items()})

    # DimeNet's and NequIP's smoke train steps, the edges (and DimeNet's
    # triplets) split over dp: their einsums on the local shards
    from repro_torch.data.graphs import build_triplets, geometric_graph
    for arch in ("dimenet", "nequip"):
        amod = get_arch(arch)
        acfg = amod.smoke_config()
        gg = geometric_graph(20, cutoff=1.8, box=3.0, n_species=4, seed=5,
                             max_edges=96)
        if arch == "dimenet":
            gg["triplets"], gg["triplet_mask"] = build_triplets(
                gg["edge_index"], gg["edge_mask"], max_triplets=256)
        gg = {k: torch.from_numpy(np.asarray(v)) for k, v in gg.items()}
        ggs = {k: sds(v.shape, v.dtype) for k, v in gg.items()}
        acell = G.make_train_cell(arch, "full_graph_sm", amod.model, acfg,
                                  ggs, G.graph_specs(ggs, edge_dp=True))
        ap = amod.model.init(torch.Generator().manual_seed(5), acfg)
        aargs = (ap, adamw_init(ap, G.OCFG), gg)
        got = acell.make_step(mesh)(*distribute(
            aargs, acell.resolve_shardings(mesh)))
        want = acell.make_step(None)(*aargs)
        res.update({f"{arch}/got/{k}": v for k, v in _np(got).items()})
        res.update({f"{arch}/want/{k}": v for k, v in _np(want).items()})

    # granite-moe's smoke train step: the routed experts under a mesh
    mcfg = get_arch("granite-moe-1b-a400m").smoke_config()
    mp = tr.init_params(torch.Generator().manual_seed(3), mcfg)
    mt = torch.randint(0, mcfg.vocab, (4, 16), generator=gen,
                       dtype=torch.int32)
    mcell = lm_common.train_cell("granite-moe-1b-a400m", mcfg, batch=4,
                                 seq=16)
    margs = (mp, adamw_init(mp, lm_common.opt_config(mcfg, quantize=False)),
             {"tokens": mt, "labels": torch.roll(mt, -1, 1)})
    got = mcell.make_step(mesh)(*distribute(margs, mcell.resolve_shardings(
        mesh)))
    want = mcell.make_step(None)(*margs)
    res.update({f"moe/got/{k}": v for k, v in _np(got).items()})
    res.update({f"moe/want/{k}": v for k, v in _np(want).items()})

    # MIND's smoke train step: item and tag tables split over the model
    # axis (the lookups on shards), the batch over dp
    from repro_torch.configs import mind
    from repro_torch.data.recsys import mind_batch
    from repro_torch.models import recsys
    rcfg = mind.smoke_config()
    rp = recsys.init(torch.Generator().manual_seed(6), rcfg)
    rb = {k: torch.from_numpy(v) for k, v in mind_batch(
        n_items=rcfg.n_items, n_user_tags=rcfg.n_user_tags,
        hist_len=rcfg.hist_len, tag_bag=rcfg.tag_bag, batch=16, seed=6,
        step=0).items()}
    rcell = mind._train_cell(rcfg, 16)
    rargs = (rp, adamw_init(rp, mind.OCFG), rb)
    got = rcell.make_step(mesh)(*distribute(rargs, rcell.resolve_shardings(
        mesh)))
    want = rcell.make_step(None)(*rargs)
    res.update({f"mind/got/{k}": v for k, v in _np(got).items()})
    res.update({f"mind/want/{k}": v for k, v in _np(want).items()})

    # edge_aggregate's mean over edges split over dp, fractional masks:
    # each node's sum and masked in-degree reduced over the edge shards
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels.ops import edge_aggregate_batched
    rng = np.random.default_rng(9)
    msg = torch.from_numpy(rng.normal(size=(2, 40, 6)).astype(np.float32))
    ei = torch.from_numpy(rng.integers(0, 12, (2, 2, 40)).astype(np.int32))
    em = torch.from_numpy(rng.uniform(0.1, 1.0, (2, 40)).astype(np.float32))
    em[:, ::7] = 0.0

    def split(x, dim):
        return distribute_tensor(x, mesh, [Shard(dim), Replicate()])
    got = edge_aggregate_batched(split(msg, 1), split(ei, 2), 12,
                                 split(em, 1), reduce="mean")
    want = edge_aggregate_batched(msg, ei, 12, em, reduce="mean")
    res.update({"mean/got/out": _np(got)[""], "mean/want/out": _np(want)[""]})
    if RANK == 0:
        np.savez(os.path.join(OUT, "lm.npz"), **res)


def compress():
    from repro_torch.optim.compress import (compressed_tree_psum,
                                            error_feedback_init)
    rng = np.random.default_rng(100 + RANK)
    res = {}
    grads = {"a": torch.from_numpy(rng.normal(size=(6, 5)).astype(
        np.float32)), "b": {"c": torch.from_numpy(
            (rng.normal(size=(7,)) * 1e-3).astype(np.float32))}}
    err = error_feedback_init(grads)
    for r in range(3):
        g = {"a": grads["a"] * (r + 1), "b": {"c": grads["b"]["c"] - r}}
        out, err = compressed_tree_psum(g, err, dist.group.WORLD, WORLD)
        res.update({f"{r}/out/{k}": v for k, v in _np(out).items()})
        res.update({f"{r}/err/{k}": v for k, v in _np(err).items()})
    np.savez(os.path.join(OUT, f"compress_{RANK}.npz"), **res)


if __name__ == "__main__":
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{PORT}",
                            world_size=WORLD, rank=RANK)
    try:
        {"lm": lm, "compress": compress}[CASE]()
    finally:
        dist.destroy_process_group()
