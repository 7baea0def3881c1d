"""nequip [gnn]: n_layers=5 d_hidden=32 l_max=2 n_rbf=8 cutoff=5
equivariance=E(3)-tensor-product [arXiv:2101.03164; paper].

Counterpart of ``repro/configs/nequip.py``."""
import torch

from repro_torch.configs import gnn_common as G
from repro_torch.models.gnn import nequip as model

ARCH_ID = "nequip"
FAMILY = "gnn"
SHAPES = list(G.SHAPES)
TRIPLETS = False


def full_config(shape="full_graph_sm"):
    return model.NequIPConfig(n_layers=5, mult=32, l_max=2, n_rbf=8,
                              cutoff=5.0)


def smoke_config():
    return model.NequIPConfig(n_layers=2, mult=8, l_max=2, n_rbf=4)


def _flops(meta, cfg):
    n, e = meta["n"], meta["e"]
    m = cfg.mult
    # ~12 TP paths × CG contraction (m × ~45 mults) + radial MLP
    per_layer = (2.0 * e * 12 * m * 45
                 + 2.0 * e * (cfg.n_rbf * cfg.radial_hidden
                              + cfg.radial_hidden * 12 * m)
                 + 2.0 * n * 5 * m * m)
    return 3.0 * cfg.n_layers * per_layer


def cell(shape):
    meta = G.SHAPES[shape]
    cfg = full_config(shape)
    if shape == "molecule":
        b = meta["batch"]
        g = G.graph_sds(meta, geometric=True, triplets=TRIPLETS, batch=b)
        specs = G.graph_specs(g, batch=True)
        return G.make_batched_train_cell(
            ARCH_ID, model, cfg, g, specs,
            model_flops=_flops(meta, cfg) * b)
    g = G.graph_sds(meta, geometric=True, triplets=TRIPLETS)
    specs = G.graph_specs(g, edge_dp=True)
    return G.make_train_cell(ARCH_ID, shape, model, cfg, g, specs,
                             model_flops=_flops(meta, cfg))


def smoke_run(seed=0, device=None):
    """The smoke config's loss (``force_weight=0.1``; the graph carries
    no force labels, so the energy term alone, as in the reference) and
    forces on a 20-atom geometric graph (random weights from
    ``torch.Generator`` seed ``seed``)."""
    from repro_torch.data.graphs import geometric_graph
    from repro_torch.device import resolve_device
    from repro_torch.optim.adamw import tree_map
    dev = resolve_device(device)
    cfg = smoke_config()
    gg = geometric_graph(20, cutoff=1.8, box=3.0, n_species=4, seed=seed,
                         max_edges=96)
    g = {k: torch.as_tensor(v).to(dev) for k, v in gg.items()}
    p = tree_map(lambda t: t.to(dev),
                 model.init(torch.Generator().manual_seed(seed), cfg))
    loss, m = model.loss_fn(p, g, cfg, force_weight=0.1)
    f = model.forces(p, g, cfg)
    return {"loss": loss, "forces": f, "metrics": m}
