"""Synthetic graph data: the power-law generator and the CSR neighbour
sampler of GraphSAGE's minibatch training.

Counterpart of the part of ``repro/data/graphs.py`` that GatedGCN and
GraphSAGE train on, numpy only: the same ``rng`` calls in the same
order, so the same seed gives the same bytes. The geometric and
molecule generators and DimeNet's triplet builder wait for DimeNet and
NequIP (``ROADMAP.md`` queue 1 item 6).
"""
from __future__ import annotations

import numpy as np

from repro_torch.data.ragged import group_by_segment


def powerlaw_graph(n_nodes: int, n_edges: int, *, d_feat: int,
                   n_classes: int, seed: int):
    """Preferential-attachment-flavoured random graph with features whose
    class signal propagates over edges (so GNNs beat MLPs on it)."""
    rng = np.random.default_rng(seed)
    # power-law-ish degree: sample endpoints with prob ∝ (rank)^-0.7
    p = (np.arange(1, n_nodes + 1) ** -0.7)
    p /= p.sum()
    src = rng.choice(n_nodes, size=n_edges, p=p).astype(np.int32)
    dst = rng.integers(0, n_nodes, size=n_edges).astype(np.int32)
    labels = rng.integers(0, n_classes, size=n_nodes).astype(np.int32)
    centers = rng.normal(size=(n_classes, d_feat)).astype(np.float32)
    feats = centers[labels] + 0.8 * rng.normal(
        size=(n_nodes, d_feat)).astype(np.float32)
    return {"nodes": feats, "edge_index": np.stack([src, dst]),
            "labels": labels,
            "node_mask": np.ones(n_nodes, np.float32),
            "edge_mask": np.ones(n_edges, np.float32)}


class NeighborSampler:
    """CSR fixed-fanout layered neighbour sampler (GraphSAGE §3.1).

    Builds the in-neighbour CSR once; ``sample(seeds)`` returns the
    layered frontier batch ``graphsage.apply_sampled`` consumes: features
    laid out frontier by frontier, per-layer (2, E) edge lists pointing
    frontier l+1 → frontier l. Sampling is with replacement (constant
    fanout: static shapes, so a captured step never meets a new one); an
    isolated node loops to itself."""

    def __init__(self, edge_index, n_nodes: int, feats, labels,
                 *, fanouts, seed: int = 0):
        src, dst = np.asarray(edge_index)
        # in-neighbour CSR: the grouping of the ragged event packer
        # (data/ragged.py), segments = destination nodes
        self.nbr, self.offs = group_by_segment(src, dst, n_nodes)
        self.feats = feats
        self.labels = labels
        self.fanouts = tuple(fanouts)
        self.rng = np.random.default_rng(seed)
        self.n_nodes = n_nodes

    def _sample_neighbors(self, nodes, fanout):
        lo = self.offs[nodes]
        hi = self.offs[nodes + 1]
        deg = np.maximum(hi - lo, 1)
        r = self.rng.integers(0, 1 << 62, size=(nodes.size, fanout))
        idx = lo[:, None] + (r % deg[:, None])
        has = (hi > lo)[:, None]
        nb = np.where(has, self.nbr[np.minimum(idx, self.offs[-1] - 1)],
                      nodes[:, None])  # isolated nodes loop to themselves
        return nb.astype(np.int32)

    def sample(self, seeds):
        seeds = np.asarray(seeds, np.int32)
        frontiers = [seeds]
        edges = []
        offs = [0, seeds.size]
        for f in self.fanouts:
            nb = self._sample_neighbors(frontiers[-1], f)   # (n_cur, f)
            frontiers.append(nb.reshape(-1))
            offs.append(offs[-1] + frontiers[-1].size)
        # layered edge lists in frontier-local coordinates
        off = 0
        for li, f in enumerate(self.fanouts):
            n_cur = frontiers[li].size
            dst_local = off + np.repeat(np.arange(n_cur, dtype=np.int32), f)
            src_local = offs[li + 1] + np.arange(n_cur * f, dtype=np.int32)
            edges.append(np.stack([src_local, dst_local]))
            off = offs[li + 1]
        all_nodes = np.concatenate(frontiers)
        return {"feats": self.feats[all_nodes],
                "edges": edges,
                "labels": self.labels[seeds]}
