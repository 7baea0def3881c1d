"""GatedGCN (Bresson & Laurent, arXiv:1711.07553; benchmarking-gnns
arXiv:2003.00982 config: 16 layers, d_hidden=70, gated aggregator).

Counterpart of ``repro/models/gnn/gatedgcn.py`` (config, init, apply
with its node and graph readouts, export, loss). Layer (with edge
features, residual, batch-norm as in benchmarking-gnns):
    ê_ij = A h_i + B h_j + C e_ij
    e'_ij = e_ij + ReLU(BN(ê_ij))
    η_ij = σ(ê_ij) / (Σ_{j'} σ(ê_ij') + ε)     (gated aggregation)
    h'_i = h_i + ReLU(BN(U h_i + Σ_j η_ij ⊙ V h_j))
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.graph_ir import Graph, Operator, register_exporter
from repro_torch.dist.sharding import DP, TP, P
from repro_torch.models.gnn import common as C
from repro_torch.nn.layers import dense_apply, dense_init

_MATS = ("A", "B", "Ce", "U", "V")


@dataclasses.dataclass(frozen=True)
class GatedGCNConfig:
    name: str = "gatedgcn"
    n_layers: int = 16
    d_hidden: int = 70
    d_in: int = 1433
    d_edge_in: int = 1
    n_classes: int = 7
    readout: str = "node"      # 'node' (classification) | 'graph'
    transform_then_gather: bool = False
    # A/B/V are linear, so transforming per node (3·N·d²) then gathering
    # equals gathering then transforming per edge (3·E·d²), and is cheaper
    # whenever E > N


def param_shapes(cfg: GatedGCNConfig) -> dict:
    """The reference's parameter tree with each dense as (d_in, d_out)."""
    dh = cfg.d_hidden
    return {"embed_h": (cfg.d_in, dh), "embed_e": (cfg.d_edge_in, dh),
            "head": (dh, cfg.n_classes),
            "layers": [dict.fromkeys(_MATS, (dh, dh))
                       for _ in range(cfg.n_layers)]}


def init(gen: torch.Generator, cfg: GatedGCNConfig) -> dict:
    dh = cfg.d_hidden
    return {"embed_h": dense_init(gen, cfg.d_in, dh),
            "embed_e": dense_init(gen, cfg.d_edge_in, dh),
            "head": dense_init(gen, dh, cfg.n_classes),
            "layers": [{m: dense_init(gen, dh, dh) for m in _MATS}
                       for _ in range(cfg.n_layers)]}


# logical sharding specs of the parameters (``dist/sharding.py``)
PARAM_RULES = [
    (r"embed_h/w", P(DP, TP)),
    (r"layers/.*/w", P(DP, TP)),
    (r"head/w", P(DP, None)),
]


def apply(params, graph, cfg: GatedGCNConfig):
    """Eager forward of one graph (a dict of tensors, see
    ``models/gnn/common.py``), or of a batch of them on a leading axis,
    each with its own batch-norm statistics -> per-node logits, or for
    ``readout='graph'`` the logits of the masked mean over nodes."""
    nodes, ei = graph["nodes"], graph["edge_index"]
    nm, em = graph["node_mask"], graph["edge_mask"]
    n = nodes.shape[-2]
    h = dense_apply(params["embed_h"], nodes)
    edges = graph.get("edges")
    if edges is None:
        edges = h.new_ones((*ei.shape[:-2], ei.shape[-1], cfg.d_edge_in))
    e = dense_apply(params["embed_e"], edges)
    for lp in params["layers"]:
        if cfg.transform_then_gather:
            ai = C.gather_dst(dense_apply(lp["A"], h), ei)
            bj = C.gather_src(dense_apply(lp["B"], h), ei)
            vj = C.gather_src(dense_apply(lp["V"], h), ei)
            ehat = ai + bj + dense_apply(lp["Ce"], e)
        else:  # paper-faithful gather-then-transform (per-edge denses)
            hi = C.gather_dst(h, ei)   # i = destination
            hj = C.gather_src(h, ei)   # j = source
            ehat = (dense_apply(lp["A"], hi) + dense_apply(lp["B"], hj)
                    + dense_apply(lp["Ce"], e))
            vj = dense_apply(lp["V"], hj)
        e = e + torch.relu(C.masked_batchnorm(ehat, em))
        sig = torch.sigmoid(ehat) * em[..., None]
        denom = C.scatter_sum(sig, ei, n) + 1e-6
        eta = sig / C.gather_dst(denom, ei)
        msg = C.scatter_sum(eta * vj, ei, n, em)
        h = h + torch.relu(C.masked_batchnorm(
            dense_apply(lp["U"], h) + msg, nm))
    if cfg.readout == "graph":
        pooled = (h * nm[..., None]).sum(-2) / torch.clamp_min(
            nm.sum(-1), 1.0)[..., None]
        return dense_apply(params["head"], pooled)
    return dense_apply(params["head"], h)


def to_graph(params, cfg: GatedGCNConfig) -> Graph:
    """Export as a dataflow graph for the deployment flow, op for op the
    reference's: every layer expands into ``gather_edge`` endpoint
    gathers, two ``edge_aggregate`` sums (``l{i}_denom``, ``l{i}_agg``),
    ``eltwise`` gate algebra and ``batchnorm``, in the
    gather-then-transform topology (mathematically the same as
    ``transform_then_gather``). Only ``readout='node'`` deploys: graph
    pooling has no IR op, as in the reference."""
    if cfg.readout != "node":
        raise ValueError(
            f"gatedgcn export supports readout='node' only, "
            f"got {cfg.readout!r}")
    g = Graph()
    dh = cfg.d_hidden

    def lin(name, inp, p, d_out):
        g.add(Operator(name=name, op_type="linear", inputs=[inp],
                       params=dict(p), out_dim=d_out))
        return name

    def elt(name, fn, inputs, d, **extra):
        g.add(Operator(name=name, op_type="eltwise", inputs=list(inputs),
                       attrs={"fn": fn, **extra}, out_dim=d))
        return name

    def gather(name, inp, endpoint):
        g.add(Operator(name=name, op_type="gather_edge",
                       inputs=[inp, "edge_index"],
                       attrs={"endpoint": endpoint}, out_dim=dh))
        return name

    def bn(name, inp, mask):
        g.add(Operator(name=name, op_type="batchnorm",
                       inputs=[inp, mask], out_dim=dh))
        return name

    for feat, d in (("nodes", cfg.d_in), ("edge_index", 2),
                    ("edges", cfg.d_edge_in), ("node_mask", 1),
                    ("edge_mask", 1)):
        g.add(Operator(name=feat, op_type="input", out_dim=d,
                       attrs={"feature": feat}))
    h = lin("embed_h", "nodes", params["embed_h"], dh)
    e = lin("embed_e", "edges", params["embed_e"], dh)
    for i, lp in enumerate(params["layers"]):
        hi = gather(f"l{i}_hi", h, "dst")
        hj = gather(f"l{i}_hj", h, "src")
        ehat = elt(f"l{i}_ehat", "add",
                   [lin(f"l{i}_A", hi, lp["A"], dh),
                    lin(f"l{i}_B", hj, lp["B"], dh),
                    lin(f"l{i}_Ce", e, lp["Ce"], dh)], dh)
        ebn = bn(f"l{i}_ebn", ehat, "edge_mask")
        g.add(Operator(name=f"l{i}_ebn_relu", op_type="relu",
                       inputs=[ebn], out_dim=dh))
        e = elt(f"l{i}_e", "add", [e, f"l{i}_ebn_relu"], dh)
        sig = elt(f"l{i}_sigm", "mask",
                  [elt(f"l{i}_sig", "sigmoid", [ehat], dh),
                   "edge_mask"], dh)
        g.add(Operator(name=f"l{i}_denom", op_type="edge_aggregate",
                       inputs=[sig, "edge_index"],
                       attrs={"reduce": "sum"}, out_dim=dh))
        deps = elt(f"l{i}_denom_eps", "add_const", [f"l{i}_denom"], dh,
                   const=1e-6)
        eta = elt(f"l{i}_eta", "div",
                  [sig, gather(f"l{i}_deng", deps, "dst")], dh)
        msg = elt(f"l{i}_msg", "mul",
                  [eta, lin(f"l{i}_V", hj, lp["V"], dh)], dh)
        g.add(Operator(name=f"l{i}_agg", op_type="edge_aggregate",
                       inputs=[msg, "edge_index", "edge_mask"],
                       attrs={"reduce": "sum"}, out_dim=dh))
        pre = elt(f"l{i}_pre", "add",
                  [lin(f"l{i}_U", h, lp["U"], dh), f"l{i}_agg"], dh)
        hbn = bn(f"l{i}_hbn", pre, "node_mask")
        g.add(Operator(name=f"l{i}_hbn_relu", op_type="relu",
                       inputs=[hbn], out_dim=dh))
        h = elt(f"l{i}_h", "add", [h, f"l{i}_hbn_relu"], dh)
    head = lin("head", h, params["head"], cfg.n_classes)
    g.add(Operator(name="out", op_type="output", inputs=[head],
                   attrs={"head_names": ["logits"]},
                   out_dim=cfg.n_classes))
    g.validate()
    g.meta["config"] = cfg
    return g


def loss_fn(params, graph, cfg: GatedGCNConfig):
    """(loss, {"loss", "acc"}): the cross-entropy of ``graph["labels"]``
    over the valid nodes (times ``train_mask`` where the graph has one),
    or for ``readout='graph'`` of its label. A graph readout indexes the
    graph's log-probabilities by whatever labels the graph carries, as
    the reference's ``logp[labels]`` does: one per graph gives one loss,
    one per node (the ``molecule`` shape's labels) one loss per node."""
    logits = apply(params, graph, cfg)
    labels = graph["labels"].long()
    if cfg.readout == "graph":     # graph-level classification
        logp = torch.log_softmax(logits.float(), dim=-1)
        pred = logits.argmax(-1)
        if labels.ndim < logp.ndim:      # one label a graph
            loss = -torch.gather(logp, -1, labels[..., None])[..., 0]
        else:                            # labels per node: logp[labels]
            loss = -torch.gather(logp, -1, labels)
            pred = pred[..., None]
        acc = (pred == labels).float()
        return loss, {"loss": loss, "acc": acc}
    nm = graph["node_mask"]
    if "train_mask" in graph:
        nm = nm * graph["train_mask"]
    return C.masked_ce(logits, labels, nm)


register_exporter("gatedgcn", to_graph)
