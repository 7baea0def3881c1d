"""GraphSAGE (Hamilton et al., arXiv:1706.02216): mean aggregator,
2 layers, d_hidden=128, neighbour sampling 25-10 (the Reddit config).

Counterpart of ``repro/models/gnn/graphsage.py``: config, init, export,
and two modes sharing the same parameters:
- full graph (``apply``): message passing over a (padded) edge list;
- sampled minibatch (``apply_sampled``): the fixed-fanout layered
  subgraph of ``data/graphs.NeighborSampler`` (targets first, then the
  fanout frontiers), processed layer by layer as in the paper; a batch
  of such subgraphs (a leading group axis on every array) runs as one.
"""
from __future__ import annotations

import dataclasses
from itertools import accumulate

import torch

from repro_torch.core.graph_ir import Graph, Operator, register_exporter
from repro_torch.dist.sharding import DP, TP, P
from repro_torch.models.gnn import common as C
from repro_torch.nn.layers import dense_apply, dense_init


@dataclasses.dataclass(frozen=True)
class GraphSAGEConfig:
    name: str = "graphsage-reddit"
    n_layers: int = 2
    d_hidden: int = 128
    d_in: int = 602
    n_classes: int = 41
    sample_sizes: tuple = (25, 10)
    normalize: bool = True


def _widths(cfg: GraphSAGEConfig) -> list[tuple[int, int]]:
    """(d_in, d_out) of each layer's dense over concat(h, neigh)."""
    ds = [cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1)
    return [(2 * d, cfg.d_hidden) for d in ds]


def param_shapes(cfg: GraphSAGEConfig) -> dict:
    """The reference's parameter tree with each dense as (d_in, d_out)."""
    return {"layers": [{"w": wd} for wd in _widths(cfg)],
            "head": (cfg.d_hidden, cfg.n_classes)}


def init(gen: torch.Generator, cfg: GraphSAGEConfig) -> dict:
    layers = [{"w": dense_init(gen, *wd)} for wd in _widths(cfg)]
    return {"layers": layers,
            "head": dense_init(gen, cfg.d_hidden, cfg.n_classes)}


def _combine(lp, h, neigh, normalize):
    z = dense_apply(lp["w"], torch.cat([h, neigh], dim=-1),
                    activation=torch.relu)
    if normalize:
        z = z / torch.clamp_min(
            torch.linalg.vector_norm(z, dim=-1, keepdim=True), 1e-6)
    return z


def _sage_layer(lp, h, ei, n, nm, em, *, normalize):
    neigh = C.scatter_mean(C.gather_src(h, ei), ei, n, em)
    return _combine(lp, h, neigh, normalize) * nm[..., None]


# logical sharding specs of the parameters (``dist/sharding.py``)
PARAM_RULES = [
    (r"layers/.*/w", P(DP, TP)),
    (r"head/w", P(DP, None)),
]


def apply(params, graph, cfg: GraphSAGEConfig):
    """Full-graph mode: per-node logits of one graph (a dict of tensors,
    see ``models/gnn/common.py``), or of a batch of them on a leading
    axis."""
    h, ei = graph["nodes"], graph["edge_index"]
    nm, em = graph["node_mask"], graph["edge_mask"]
    n = h.shape[-2]
    for lp in params["layers"]:
        h = _sage_layer(lp, h, ei, n, nm, em, normalize=cfg.normalize)
    return dense_apply(params["head"], h)


def apply_sampled(params, batch, cfg: GraphSAGEConfig):
    """Sampled-minibatch mode -> the targets' logits. batch:
      feats   (..., N_total, d_in): every frontier's node features, in
              the layered layout
      edges   per layer a (..., 2, E_l): frontier l+1 -> frontier l
      labels  (..., n0): the targets' labels (n0 gives the sizes)
    Frontier l occupies [off_l, off_l + n_l); layer l aggregates
    frontier l+1 into frontier l, the neighbour mean through the
    ``edge_aggregate`` kernel (no mask: ``msum / max(cnt, 1)``)."""
    sizes = cfg_frontier_sizes(cfg, batch["labels"].shape[-1])
    h = batch["feats"]
    for lp in params["layers"]:
        offs = list(accumulate(sizes, initial=0))
        new_h = []
        for f in range(len(sizes) - 1):   # frontiers shrink by one a layer
            ei = batch["edges"][f]          # src in frontier f+1, dst in f
            seg = h[..., offs[f]:offs[f] + sizes[f], :]
            local = torch.stack([ei[..., 0, :], ei[..., 1, :] - offs[f]],
                                dim=-2)
            neigh = C.scatter_mean(C.gather_src(h, ei), local, sizes[f])
            new_h.append(_combine(lp, seg, neigh, cfg.normalize))
        h = torch.cat(new_h, dim=-2)
        sizes = sizes[:len(new_h)]
    return dense_apply(params["head"], h[..., :sizes[0], :])


def cfg_frontier_sizes(cfg: GraphSAGEConfig, batch_nodes: int):
    """(n0, n0·s0, n0·s0·s1, ...): the frontier sizes of ``batch_nodes``
    targets under ``cfg.sample_sizes``."""
    sizes = [batch_nodes]
    for f in cfg.sample_sizes:
        sizes.append(sizes[-1] * f)
    return tuple(sizes)


def loss_fn(params, graph, cfg: GraphSAGEConfig, *, sampled=False):
    """(loss, {"loss", "acc"}): the cross-entropy over the valid nodes
    (times ``train_mask`` where the graph has one), or with ``sampled``
    over the targets of a sampled batch (one per group of a batch of
    them)."""
    if sampled:
        logits = apply_sampled(params, graph, cfg)
        nm = logits.new_ones(logits.shape[:-1])
    else:
        logits = apply(params, graph, cfg)
        nm = graph["node_mask"]
        if "train_mask" in graph:
            nm = nm * graph["train_mask"]
    return C.masked_ce(logits, graph["labels"], nm)


def to_graph(params, cfg: GraphSAGEConfig) -> Graph:
    """Export the full-graph mode as a dataflow graph, op for op the
    reference's: the mean aggregator is a ``gather_edge`` (source
    endpoint) feeding an ``edge_aggregate`` with ``reduce='mean'``."""
    g = Graph()
    for feat, d in (("nodes", cfg.d_in), ("edge_index", 2),
                    ("node_mask", 1), ("edge_mask", 1)):
        g.add(Operator(name=feat, op_type="input", out_dim=d,
                       attrs={"feature": feat}))
    h, d = "nodes", cfg.d_in
    for i, lp in enumerate(params["layers"]):
        g.add(Operator(name=f"l{i}_hj", op_type="gather_edge",
                       inputs=[h, "edge_index"],
                       attrs={"endpoint": "src"}, out_dim=d))
        g.add(Operator(name=f"l{i}_neigh", op_type="edge_aggregate",
                       inputs=[f"l{i}_hj", "edge_index", "edge_mask"],
                       attrs={"reduce": "mean"}, out_dim=d))
        g.add(Operator(name=f"l{i}_cat", op_type="concat",
                       inputs=[h, f"l{i}_neigh"], out_dim=2 * d))
        g.add(Operator(name=f"l{i}_z", op_type="linear",
                       inputs=[f"l{i}_cat"], params=dict(lp["w"]),
                       out_dim=cfg.d_hidden))
        g.add(Operator(name=f"l{i}_zr", op_type="relu",
                       inputs=[f"l{i}_z"], out_dim=cfg.d_hidden))
        z = f"l{i}_zr"
        if cfg.normalize:
            g.add(Operator(name=f"l{i}_n", op_type="eltwise",
                           inputs=[z], attrs={"fn": "l2norm"},
                           out_dim=cfg.d_hidden))
            z = f"l{i}_n"
        g.add(Operator(name=f"l{i}_h", op_type="eltwise",
                       inputs=[z, "node_mask"], attrs={"fn": "mask"},
                       out_dim=cfg.d_hidden))
        h, d = f"l{i}_h", cfg.d_hidden
    g.add(Operator(name="head", op_type="linear", inputs=[h],
                   params=dict(params["head"]), out_dim=cfg.n_classes))
    g.add(Operator(name="out", op_type="output", inputs=["head"],
                   attrs={"head_names": ["logits"]},
                   out_dim=cfg.n_classes))
    g.validate()
    g.meta["config"] = cfg
    return g


register_exporter("graphsage", to_graph)
