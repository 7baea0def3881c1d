"""dimenet [gnn]: n_blocks=6 d_hidden=128 n_bilinear=8 n_spherical=7
n_radial=6 [arXiv:2003.03123; unverified]. Geometric arch: every shape
carries synthetic positions/species; triplet budgets per gnn_common.

Counterpart of ``repro/configs/dimenet.py``."""
import torch

from repro_torch.configs import gnn_common as G
from repro_torch.models.gnn import dimenet as model

ARCH_ID = "dimenet"
FAMILY = "gnn"
SHAPES = list(G.SHAPES)
TRIPLETS = True


def full_config(shape="full_graph_sm"):
    return model.DimeNetConfig(n_blocks=6, d_hidden=128, n_bilinear=8,
                               n_spherical=7, n_radial=6, cutoff=5.0)


def smoke_config():
    return model.DimeNetConfig(n_blocks=2, d_hidden=16, n_bilinear=4,
                               n_spherical=3, n_radial=3)


def _flops(meta, cfg):
    n, e, t = meta["n"], meta["e"], meta["trip"]
    d, nb = cfg.d_hidden, cfg.n_bilinear
    per_block = (2.0 * e * d * d * 4                 # edge denses
                 + 2.0 * t * nb * d * d / d          # sbf proj ~ t*nsr*nb
                 + 2.0 * t * nb * d * d              # bilinear einsum
                 + 2.0 * n * d * d)                  # output mlp
    return 3.0 * cfg.n_blocks * per_block


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
    """The smoke config's loss and the L1 norm of its gradients on a
    24-atom geometric graph with its triplets (random weights from
    ``torch.Generator`` seed ``seed``)."""
    from repro_torch.checkpoint.manager import flatten
    from repro_torch.data.graphs import build_triplets, geometric_graph
    from repro_torch.device import resolve_device
    from repro_torch.optim.adamw import tree_map
    from repro_torch.optim.step import value_and_grad
    dev = resolve_device(device)
    cfg = smoke_config()
    gg = geometric_graph(24, cutoff=1.8, box=3.0, n_species=4, seed=seed,
                         max_edges=128)
    gg["triplets"], gg["triplet_mask"] = build_triplets(
        gg["edge_index"], gg["edge_mask"], max_triplets=512)
    g = {k: torch.as_tensor(v).to(dev) for k, v in gg.items()}
    p = tree_map(lambda t: t.to(dev),
                 model.init(torch.Generator().manual_seed(seed), cfg))
    (loss, m), grads = value_and_grad(lambda q: model.loss_fn(q, g, cfg), p)
    gn = sum(float(x.abs().sum()) for _, x in flatten(grads))
    return {"loss": loss, "grad_l1": gn, "metrics": m}
