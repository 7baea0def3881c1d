"""Message passing over padded edge lists.

Counterpart of the part of ``repro/models/gnn/common.py`` that GatedGCN
and GraphSAGE use. One graph is ``nodes`` (N, d), ``edge_index`` (2, E)
int (src, dst; padded edges point at node 0 and carry mask 0),
``node_mask`` (N,) and ``edge_mask`` (E,). The scatters are the
``edge_aggregate`` kernel's entry point (``kernels/ops.py``), so their
sums run in one fixed order on either device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops


def gather_src(nodes, edge_index):
    return nodes[edge_index[0].long()]


def gather_dst(nodes, edge_index):
    return nodes[edge_index[1].long()]


def scatter_sum(messages, edge_index, n_nodes, edge_mask=None):
    return kops.edge_aggregate(messages, edge_index, n_nodes, edge_mask,
                               reduce="sum")


def scatter_mean(messages, edge_index, n_nodes, edge_mask=None):
    return kops.edge_aggregate(messages, edge_index, n_nodes, edge_mask,
                               reduce="mean")


def masked_batchnorm(x, mask, *, eps=1e-5):
    """BatchNorm over the valid nodes or edges (batch statistics; the
    benchmarking-gnns training-mode normalization)."""
    m = mask[:, None]
    n = torch.clamp_min(m.sum(), 1.0)
    mu = (x * m).sum(0) / n
    var = (((x - mu) ** 2) * m).sum(0) / n
    return (x - mu) * torch.rsqrt(var + eps) * m
