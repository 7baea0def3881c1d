"""Message passing over padded edge lists.

Counterpart of ``repro/models/gnn/common.py``. One graph is ``nodes``
(N, d), ``edge_index`` (2, E) int (src, dst; padded edges point at node
0 and carry mask 0), ``node_mask`` (N,) and ``edge_mask`` (E,), and for
the geometric archs ``positions`` (N, 3); a batch of graphs of one shape
carries a leading axis on each. The sums and means are the
``edge_aggregate`` kernel's entry point (``kernels/ops.py``), so their
sums run in one fixed order on either device, and they carry a gradient
in the messages (the training step's backward, and the gradient of
that for NequIP's forces). ``scatter_max`` and ``scatter_softmax`` are
plain PyTorch, as they are plain ``segment_max`` in the reference.

``jnp.maximum`` and ``jnp.clip`` split the gradient half and half where
the two sides tie; ``torch.maximum`` and ``torch.minimum`` against a
tensor do the same (``torch.clamp`` passes all of it), hence
:func:`_maximum` and :func:`_clip` (their constants made by a fill on the
tensor's device, which a CUDA graph may capture; a copy from the host it
may not).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops as kops


def _gather(nodes, idx):
    """``nodes[idx]`` along the node axis, of (..., N, d) rows or
    (..., N) values; with leading (batch) axes, each graph's rows from
    its own nodes. One graph's is ``index_select``, whose backward is an
    ``index_add``: indexing's backward walks each run of equal indices
    in order, and every padded edge (or triplet) points at row 0 (at
    full_graph_sm's 23,410 padded DimeNet triplets that took 82 % of a
    train step's device time on an H100)."""
    if nodes.ndim == idx.ndim:
        return _gather(nodes[..., None], idx)[..., 0]
    idx = idx.long()
    if idx.ndim == 1:
        return nodes.index_select(-2, idx)
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


def scatter_max(messages, edge_index, n_nodes, edge_mask=None):
    """Per destination node the largest of its (unmasked) messages, 0
    where it has none. messages:(E, d) -> (n_nodes, d)."""
    if edge_mask is not None:
        messages = torch.where(edge_mask[:, None] > 0, messages, -1e30)
    m = _segment_max(messages, edge_index[1], n_nodes)
    return torch.where(m <= -1e29, 0.0, m)


def scatter_softmax(scores, edge_index, n_nodes, edge_mask=None):
    """Edge softmax per destination node. scores:(E,) -> (E,); a masked
    edge gets 0."""
    if edge_mask is not None:
        scores = torch.where(edge_mask > 0, scores, -1e30)
    dst = edge_index[1].long()
    mx = _segment_max(scores[:, None], dst, n_nodes)[:, 0]
    ex = torch.exp(scores - mx[dst])
    if edge_mask is not None:
        ex = ex * edge_mask
    z = ex.new_zeros(n_nodes).index_add(0, dst, ex)
    return ex / _maximum(z[dst], 1e-16)


def _segment_max(x, dst, n_nodes):
    """``jax.ops.segment_max``: the row-wise max of x:(E, d) per
    destination, -inf where a node has no row."""
    idx = dst.long()[:, None].expand_as(x)
    return x.new_full((n_nodes, x.shape[1]), -math.inf).scatter_reduce(
        0, idx, x, "amax", include_self=True)


def masked_batchnorm(x, mask, *, eps=1e-5):
    """BatchNorm over the valid nodes or edges (batch statistics; the
    benchmarking-gnns training-mode normalization). x:(..., R, d),
    mask:(..., R): the statistics of each graph of a batch its own."""
    m = mask[..., None]
    n = torch.clamp_min(m.sum(-2, keepdim=True), 1.0)
    mu = (x * m).sum(-2, keepdim=True) / n
    var = (((x - mu) ** 2) * m).sum(-2, keepdim=True) / n
    return (x - mu) * torch.rsqrt(var + eps) * m


def one_hot(idx, n: int, dtype):
    """``jax.nn.one_hot(idx, n)`` in ``dtype`` (a comparison, which a
    CUDA graph may capture: ``F.one_hot`` may check its input on the
    host)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _maximum(x, c: float):
    """``jnp.maximum(x, c)``, with its half gradient at a tie."""
    return torch.maximum(x, x.new_full((), c))


def _clip(x, lo: float, hi: float):
    """``jnp.clip(x, lo, hi)``: the max, then the min, each with its
    half gradient at a tie."""
    return torch.minimum(_maximum(x, lo), x.new_full((), hi))


def edge_vectors(positions, edge_index, *, eps=1e-9):
    """(..., E, 3) displacement vectors src->dst, their lengths (at least
    sqrt(eps): a padded edge has r = 0) and unit directions."""
    r = gather_dst(positions, edge_index) - gather_src(positions, edge_index)
    d = torch.sqrt(_maximum((r * r).sum(-1), eps))
    return r, d, r / d[..., None]


def bessel_rbf(d, *, n_rbf: int, cutoff: float):
    """DimeNet's and NequIP's radial Bessel basis with the cosine cutoff
    envelope. d:(...) -> (..., n_rbf)."""
    n = torch.arange(1, n_rbf + 1, dtype=d.dtype, device=d.device)
    dd = _maximum(d, 1e-6)[..., None]
    x = dd / cutoff
    basis = math.sqrt(2.0 / cutoff) * torch.sin(math.pi * n * x) / dd
    env = 0.5 * (torch.cos(math.pi * _clip(x, 0.0, 1.0)) + 1.0)
    return basis * env


def cosine_cutoff(d, cutoff: float):
    x = _clip(d / cutoff, 0.0, 1.0)
    return 0.5 * (torch.cos(math.pi * x) + 1.0)


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
