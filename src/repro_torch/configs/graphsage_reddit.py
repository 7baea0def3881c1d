"""graphsage-reddit [gnn]: n_layers=2 d_hidden=128 aggregator=mean
sample_sizes=25-10 [arXiv:1706.02216; paper].

Counterpart of ``repro/configs/graphsage_reddit.py``. minibatch_lg uses
the real layered neighbour sampler (``data/graphs.NeighborSampler``)
with the assigned fanout 15-10, grouped 32×32 seeds; :func:`sampled_train_step` is the
step of the reference's ``_sampled_cell``, the groups batched into one
pass (one ``edge_aggregate`` launch per layer and frontier for all of
them)."""
import numpy as np
import torch

from repro_torch.configs import gnn_common as G
from repro_torch.configs.base import Cell, sds
from repro_torch.dist.sharding import DP, P
from repro_torch.models.gnn import graphsage as model

ARCH_ID = "graphsage-reddit"
FAMILY = "gnn"
SHAPES = list(G.SHAPES)


def full_config(shape="full_graph_sm"):
    meta = G.SHAPES[shape]
    fanout = meta.get("fanout", (25, 10))
    return model.GraphSAGEConfig(
        n_layers=2, d_hidden=128, d_in=meta["d_feat"],
        n_classes=max(meta["classes"], 2), sample_sizes=fanout)


def smoke_config():
    return model.GraphSAGEConfig(n_layers=2, d_hidden=16, d_in=8,
                                 n_classes=3, sample_sizes=(3, 2))


def _flops(meta, cfg, n=None):
    n = n or meta["n"]
    d = cfg.d_hidden
    fl = 2.0 * n * 2 * meta["d_feat"] * d + 2.0 * n * 2 * d * d
    return 3.0 * fl


def _flops_sampled(meta, cfg, groups, seeds):
    """Layered-frontier work: layer l transforms frontiers 0..depth-l."""
    d = cfg.d_hidden
    sizes = model.cfg_frontier_sizes(cfg, seeds)
    fl = 0.0
    din = meta["d_feat"]
    for li in range(cfg.n_layers):
        # frontiers 0..depth-1 are transformed at layer li
        depth = len(sizes) - 1 - li
        active = sum(sizes[:depth])
        fl += 2.0 * active * 2 * din * d
        din = d
    return 3.0 * groups * fl


def cell(shape):
    meta = G.SHAPES[shape]
    cfg = full_config(shape)
    if shape == "minibatch_lg":
        return _sampled_cell(cfg, meta)
    if shape == "molecule":
        b = meta["batch"]
        g = G.graph_sds(meta, geometric=False, triplets=False, batch=b)
        specs = G.graph_specs(g, batch=True)
        return G.make_batched_train_cell(
            ARCH_ID, model, cfg, g, specs,
            model_flops=_flops(meta, cfg) * b)
    g = G.graph_sds(meta, geometric=False, triplets=False)
    specs = G.graph_specs(g, edge_dp=True)
    return G.make_train_cell(ARCH_ID, shape, model, cfg, g, specs,
                             model_flops=_flops(meta, cfg))


def _sampled_cell(cfg, meta):
    groups, seeds = G.GROUPS, G.SEEDS_PER_GROUP
    sizes = model.cfg_frontier_sizes(cfg, seeds)     # (32, 480, 4800)
    ntot = sum(sizes)

    def abstract_args():
        params, opt, _, _ = G.state_trees(model, cfg)
        batch = {
            "feats": sds((groups, ntot, cfg.d_in), torch.float32),
            "edges": [sds((groups, 2, sizes[i] * cfg.sample_sizes[i]),
                          torch.int32) for i in range(len(sizes) - 1)],
            "labels": sds((groups, seeds), torch.int32),
        }
        return (params, opt, batch)

    def spec_args():
        _, _, pspecs, ospecs = G.state_trees(model, cfg)
        bspecs = {"feats": P(DP, None, None),
                  "edges": [P(DP, None, None)] * (len(sizes) - 1),
                  "labels": P(DP, None)}
        return (pspecs, ospecs, bspecs)

    mf = _flops_sampled(meta, cfg, groups, seeds)
    return Cell(arch=ARCH_ID, shape="minibatch_lg", kind="train",
                make_step=lambda mesh: sampled_train_step(cfg),
                abstract_args=abstract_args, spec_args=spec_args,
                model_flops=mf)


def sampled_train_step(cfg):
    """The minibatch_lg step: the mean over groups of the sampled loss
    (and of each metric) -> gradients -> AdamW at ``G.LR(step)``. Its
    batch holds every group on a leading axis (:func:`stack_groups`)."""
    return G.train_step(model, cfg, sampled=True)


def stack_groups(batches, device=None) -> dict:
    """``NeighborSampler.sample`` batches of one shape as one batch with
    a leading group axis, tensors on ``device``."""
    from repro_torch.device import resolve_device
    dev = resolve_device(device)

    def t(x):
        return torch.from_numpy(np.stack(x)).to(dev)
    return {"feats": t([b["feats"] for b in batches]),
            "edges": [t([b["edges"][i] for b in batches])
                      for i in range(len(batches[0]["edges"]))],
            "labels": t([b["labels"] for b in batches])}


def smoke_run(seed=0, device=None):
    """The smoke config's sampled and full-graph losses on a 64-node
    power-law graph (random weights from ``torch.Generator`` seed
    ``seed``)."""
    from repro_torch.data.graphs import NeighborSampler, powerlaw_graph
    from repro_torch.device import resolve_device
    from repro_torch.optim.adamw import tree_map
    dev = resolve_device(device)
    cfg = smoke_config()
    gg = powerlaw_graph(64, 256, d_feat=8, n_classes=3, seed=seed)
    sampler = NeighborSampler(gg["edge_index"], 64, gg["nodes"],
                              gg["labels"], fanouts=cfg.sample_sizes,
                              seed=seed)
    raw = sampler.sample(np.arange(8))
    batch = {"feats": torch.from_numpy(raw["feats"]).to(dev),
             "edges": [torch.from_numpy(e).to(dev) for e in raw["edges"]],
             "labels": torch.from_numpy(raw["labels"]).to(dev)}
    p = tree_map(lambda t: t.to(dev),
                 model.init(torch.Generator().manual_seed(seed), cfg))
    loss, m = model.loss_fn(p, batch, cfg, sampled=True)
    g = {k: torch.from_numpy(v).to(dev) for k, v in gg.items()}
    loss_full, _ = model.loss_fn(p, g, cfg)
    return {"loss": loss, "loss_full": loss_full, "metrics": m}
