"""gatedgcn [gnn]: n_layers=16 d_hidden=70 aggregator=gated
[arXiv:2003.00982; paper].

Counterpart of ``repro/configs/gatedgcn.py``."""
import torch

from repro_torch.configs import gnn_common as G
from repro_torch.configs.base import sds
from repro_torch.models.gnn import gatedgcn as model

ARCH_ID = "gatedgcn"
FAMILY = "gnn"
SHAPES = list(G.SHAPES)


def full_config(shape="full_graph_sm"):
    meta = G.SHAPES[shape]
    return model.GatedGCNConfig(
        n_layers=16, d_hidden=70, d_in=meta["d_feat"],
        n_classes=max(meta["classes"], 2),
        readout="graph" if shape == "molecule" else "node")


def smoke_config():
    return model.GatedGCNConfig(n_layers=2, d_hidden=16, d_in=8,
                                n_classes=3)


def _flops(meta, cfg):
    n, e = meta["n"], meta["e"]
    d = cfg.d_hidden
    per_layer = 2.0 * d * d * (4 * e + n) + 10.0 * e * d
    emb = 2.0 * n * cfg.d_in * d
    return 3.0 * (cfg.n_layers * per_layer + emb)  # fwd+bwd


def cell(shape):
    meta = G.SHAPES[shape]
    cfg = full_config(shape)
    if shape == "molecule":
        b = meta["batch"]
        g = G.graph_sds(meta, geometric=False, triplets=False, batch=b)
        g["labels"] = sds((b,), torch.int32)  # graph-level labels
        specs = G.graph_specs(g, batch=True)
        return G.make_batched_train_cell(
            ARCH_ID, model, cfg, g, specs,
            model_flops=_flops(meta, cfg) * b)

    g = G.graph_sds(meta, geometric=False, triplets=False)
    specs = G.graph_specs(g, edge_dp=True)
    return G.make_train_cell(ARCH_ID, shape, model, cfg, g, specs,
                             model_flops=_flops(meta, cfg))


def smoke_run(seed=0, device=None):
    """One AdamW step of the smoke config on a 32-node power-law graph,
    then its logits (random weights from ``torch.Generator`` seed
    ``seed``)."""
    from repro_torch.data.graphs import powerlaw_graph
    from repro_torch.device import resolve_device
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    from repro_torch.optim.adamw import tree_map
    from repro_torch.optim.step import value_and_grad
    dev = resolve_device(device)
    cfg = smoke_config()
    gg = powerlaw_graph(32, 96, d_feat=8, n_classes=3, seed=seed)
    g = {k: torch.from_numpy(v).to(dev) for k, v in gg.items()}
    p = tree_map(lambda t: t.to(dev),
                 model.init(torch.Generator().manual_seed(seed), cfg))
    ocfg = AdamWConfig()
    s = adamw_init(p, ocfg)
    (loss, m), grads = value_and_grad(lambda q: model.loss_fn(q, g, cfg), p)
    p2, s, _ = adamw_update(grads, s, p, lr=1e-3, cfg=ocfg)
    logits = model.apply(p2, g, cfg)
    return {"loss": loss, "logits": logits, "metrics": m}
