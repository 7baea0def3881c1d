"""Synthetic graph data: the power-law, geometric and molecule
generators, DimeNet's triplet builder and the CSR neighbour sampler of
GraphSAGE's minibatch training. All outputs are padded to static budgets
with masks.

Counterpart of ``repro/data/graphs.py``, numpy only: the same ``rng``
calls in the same order, so the same seed gives the same bytes.
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


def geometric_graph(n_nodes: int, *, cutoff: float, box: float,
                    n_species: int, seed: int, max_edges: int):
    """Random atoms in a box, their radius graph (the ``max_edges``
    shortest pairs where more lie within ``cutoff``), and a synthetic
    smooth energy."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, box, size=(n_nodes, 3)).astype(np.float32)
    d2 = ((pos[:, None] - pos[None, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    src, dst = np.nonzero(d2 < cutoff ** 2)
    if src.size > max_edges:
        keep = np.argsort(d2[src, dst])[:max_edges]
        src, dst = src[keep], dst[keep]
    e = src.size
    ei = np.zeros((2, max_edges), np.int32)
    ei[0, :e], ei[1, :e] = src, dst
    em = np.zeros(max_edges, np.float32)
    em[:e] = 1.0
    species = rng.integers(0, n_species, size=n_nodes).astype(np.int32)
    # smooth synthetic energy: pairwise morse-ish + species offsets
    d = np.sqrt(d2[src, dst])
    energy = float(np.exp(-d).sum() * 0.5 + 0.1 * species.sum())
    return {"positions": pos, "species": species, "edge_index": ei,
            "node_mask": np.ones(n_nodes, np.float32), "edge_mask": em,
            "energy": np.float32(energy)}


def build_triplets(edge_index, edge_mask, *, max_triplets: int):
    """(kj_edge, ji_edge) pairs of edges k->j, j->i with k != i, edge
    j->i in order and its k->j edges in order, cut at ``max_triplets``;
    padded with edge 0 and mask 0."""
    src, dst = edge_index
    e = int(edge_mask.sum())
    by_dst: dict[int, list[int]] = {}
    for eid in range(e):
        by_dst.setdefault(int(dst[eid]), []).append(eid)
    kj, ji = [], []
    for eid in range(e):
        j = int(src[eid])           # edge j->i
        for kj_e in by_dst.get(j, ()):
            if int(src[kj_e]) != int(dst[eid]):
                kj.append(kj_e)
                ji.append(eid)
                if len(kj) >= max_triplets:
                    break
        if len(kj) >= max_triplets:
            break
    t = len(kj)
    trips = np.zeros((2, max_triplets), np.int32)
    trips[0, :t] = kj
    trips[1, :t] = ji
    tm = np.zeros(max_triplets, np.float32)
    tm[:t] = 1.0
    return trips, tm


def molecule_batch(batch: int, *, n_nodes: int, max_edges: int,
                   max_triplets: int, n_species: int, seed: int,
                   with_triplets: bool):
    """``batch`` geometric graphs (cutoff 1.6 in a box of 3, graph i of
    seed ``seed * 10007 + i``), with DimeNet's triplets where asked,
    stacked on a leading axis."""
    gs = []
    for i in range(batch):
        g = geometric_graph(n_nodes, cutoff=1.6, box=3.0,
                            n_species=n_species, seed=seed * 10007 + i,
                            max_edges=max_edges)
        if with_triplets:
            g["triplets"], g["triplet_mask"] = build_triplets(
                g["edge_index"], g["edge_mask"],
                max_triplets=max_triplets)
        gs.append(g)
    return {k: np.stack([g[k] for g in gs]) for k in gs[0]}


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
