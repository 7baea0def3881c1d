"""Message passing over padded edge lists.

Counterpart of the part of ``repro/models/gnn/common.py`` that GatedGCN
and GraphSAGE use. One graph is ``nodes`` (N, d), ``edge_index`` (2, E)
int (src, dst; padded edges point at node 0 and carry mask 0),
``node_mask`` (N,) and ``edge_mask`` (E,); a batch of graphs of one
shape carries a leading axis on each. The scatters are the
``edge_aggregate`` kernel's entry point (``kernels/ops.py``), so their
sums run in one fixed order on either device, and they carry a gradient
in the messages (the training step's backward).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops


def _gather(nodes, idx):
    """``nodes[idx]`` along the node axis; with leading (batch) axes,
    each graph's rows from its own nodes."""
    idx = idx.long()
    if idx.ndim == 1:
        return nodes[idx]
    return torch.gather(nodes, -2, idx[..., None].expand(
        *idx.shape, nodes.shape[-1]))


def gather_src(nodes, edge_index):
    return _gather(nodes, edge_index[..., 0, :])


def gather_dst(nodes, edge_index):
    return _gather(nodes, edge_index[..., 1, :])


def scatter_sum(messages, edge_index, n_nodes, edge_mask=None):
    return _scatter(messages, edge_index, n_nodes, edge_mask, "sum")


def scatter_mean(messages, edge_index, n_nodes, edge_mask=None):
    return _scatter(messages, edge_index, n_nodes, edge_mask, "mean")


def _scatter(messages, edge_index, n_nodes, edge_mask, reduce):
    if messages.ndim == 3:      # a batch of graphs: one launch
        return kops.edge_aggregate_batched(messages, edge_index, n_nodes,
                                           edge_mask, reduce=reduce)
    return kops.edge_aggregate(messages, edge_index, n_nodes, edge_mask,
                               reduce=reduce)


def masked_batchnorm(x, mask, *, eps=1e-5):
    """BatchNorm over the valid nodes or edges (batch statistics; the
    benchmarking-gnns training-mode normalization)."""
    m = mask[:, None]
    n = torch.clamp_min(m.sum(), 1.0)
    mu = (x * m).sum(0) / n
    var = (((x - mu) ** 2) * m).sum(0) / n
    return (x - mu) * torch.rsqrt(var + eps) * m


def masked_ce(logits, labels, weight):
    """(loss, {"loss", "acc"}): the mean cross-entropy and accuracy of
    ``labels`` over the last node axis, weighted by ``weight`` (0/1),
    divided by ``max(Σ weight, 1)``; leading (batch) axes stay."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ce = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    n = torch.clamp_min(weight.sum(-1), 1.0)
    loss = (ce * weight).sum(-1) / n
    acc = ((logits.argmax(-1) == labels).float() * weight).sum(-1) / n
    return loss, {"loss": loss, "acc": acc}
