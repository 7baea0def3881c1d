"""Public kernel entry points of the port.

Counterpart of ``repro/kernels/ops.py`` for the kernels this port has.
The device of the tensors decides the route, and nothing else does: a
CPU tensor goes to the plain PyTorch version (``kernels/ref.py``), a
CUDA tensor to the hand-written kernel, which raises on what it does
not take. There is no backend switch and no fallback. The kernels mask
ragged shapes themselves, so no wrapper pads, except
:func:`flash_attention`, which pads S and T to its blocks as the
reference's wrapper does.
"""
from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.edge_aggregate import edge_aggregate_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.fused_dense import (fused_dense_cuda,
                                             fused_dense_int8_cuda)
from repro_torch.kernels.gravnet import gravnet_aggregate_cuda
from repro_torch.kernels.gravnet_block import (gravnet_block_cuda,
                                               gravnet_block_int8_cuda)
from repro_torch.kernels.knn_build import knn_aggregate_cuda, knn_build_cuda

#: every kernel wrapper; each counts its launches in ``.launches``
WRAPPERS = (fused_dense_cuda, fused_dense_int8_cuda, gravnet_aggregate_cuda,
            gravnet_block_cuda, gravnet_block_int8_cuda, knn_build_cuda,
            knn_aggregate_cuda, edge_aggregate_cuda, flash_attention_cuda)
_BY_NAME = {w.__name__: w for w in WRAPPERS}
#: guards the counters against the serving lanes' threads: a replay's
#: :func:`add_launches` on one lane and a capture's save and restore
#: (``core/pipeline.py``, which holds it across the capture) on another
COUNTS_LOCK = threading.RLock()


def launch_counts() -> dict:
    """Every wrapper's launch counter by its name, and
    ``flash_attention_cuda.launches_by_blocks`` by ``(name, (bq, bk))``:
    what a captured chunk adds again on every replay, since a replay runs
    the launches without calling the wrappers."""
    with COUNTS_LOCK:
        counts = {w.__name__: w.launches for w in WRAPPERS}
        counts.update({(flash_attention_cuda.__name__, blocks): n
                       for blocks, n
                       in flash_attention_cuda.launches_by_blocks.items()})
    return counts


def add_launches(delta: dict) -> None:
    """Add ``delta`` (keys as :func:`launch_counts`') to the counters: a
    replay's launches, as its capture recorded them."""
    by = flash_attention_cuda.launches_by_blocks
    with COUNTS_LOCK:
        for k, n in delta.items():
            if isinstance(k, tuple):
                by[k[1]] = by.get(k[1], 0) + n
            else:
                _BY_NAME[k].launches += n


def set_launch_counts(counts: dict) -> None:
    """Set every counter of :func:`launch_counts` to ``counts`` (a
    counter it does not name to 0)."""
    by = flash_attention_cuda.launches_by_blocks
    with COUNTS_LOCK:
        for w in WRAPPERS:
            w.launches = counts.get(w.__name__, 0)
        by.clear()
        by.update({k[1]: n for k, n in counts.items()
                   if isinstance(k, tuple) and n})


def fused_dense(x, w, b=None, *, activation="relu"):
    """act(x @ w + b). x:(M,K) w:(K,N) b:(N,)|None -> (M,N)."""
    if x.device.type == "cpu":
        return _ref.fused_dense_ref(x, w, b, activation=activation)
    return fused_dense_cuda(x, w, b, activation=activation)


def fused_dense_batched(x, w, b=None, *, activation="relu"):
    """act(x @ w + b) over a micro-batch x:(B,M,K) in one launch: the
    events are row-packed into one (B·M, K) product (a dense couples no
    rows, so packing is exact), a view where x's rows lie at one stride,
    as in a column slice of a contiguous tensor."""
    bsz, m, kdim = x.shape
    y = fused_dense(x.reshape(bsz * m, kdim), w, b, activation=activation)
    return y.reshape(bsz, m, -1)


def fused_dense_int8(x_q, w_q, b, x_scale, w_scale, *, activation="relu",
                     out_int8=False, out_scale=1.0):
    """The quantized dense: act(x_q @ w_q · (x_scale·w_scale) + b), f32,
    or requantized to int8 with ``out_scale`` when ``out_int8``.
    x_q:(M,K) int8, w_q:(K,N) int8, b:(N,)|None, w_scale:(N,) ->
    (M,N)."""
    if x_q.device.type == "cpu":
        return _ref.fused_dense_int8_ref(x_q, w_q, b, x_scale, w_scale,
                                         activation=activation,
                                         out_int8=out_int8,
                                         out_scale=out_scale)
    return fused_dense_int8_cuda(x_q, w_q, b, x_scale, w_scale,
                                 activation=activation, out_int8=out_int8,
                                 out_scale=out_scale)


def gravnet_aggregate_batched(s, f, mask, *, k=8, scale=10.0):
    """GravNet aggregation over a micro-batch, one launch.
    s:(B,N,ds), f:(B,N,df), mask:(B,N) -> (B,N,2·df) = concat(mean, max)
    over each row's k nearest valid rows of its own event."""
    if s.device.type == "cpu":
        return _ref.gravnet_aggregate_ref(s, f, mask, k=k, scale=scale)
    return gravnet_aggregate_cuda(s, f, mask, k=k, scale=scale)


def gravnet_aggregate(s, f, mask, *, k=8, scale=10.0):
    """GravNet aggregation for one event: the batched kernel at B = 1.
    s:(N,ds), f:(N,df), mask:(N,) -> (N, 2·df)."""
    return gravnet_aggregate_batched(s[None], f[None], mask[None], k=k,
                                     scale=scale)[0]


def knn_build_batched(s, segids, *, k=8):
    """Ragged kNN selection over a micro-batch of packed bins, one
    launch. s:(B,N,ds) f32, segids:(B,N) int event ids (−1 padding) ->
    (idx:(B,N,k) int32, d2:(B,N,k) f32): per row, the k nearest rows of
    its own event (ties to the lowest column, self excluded); a slot
    with no candidate left has d2 = 1e30 (consumers gate on d2)."""
    if s.device.type == "cpu":
        return _ref.knn_build_ref(s, segids, k=k)
    return knn_build_cuda(s, segids, k=k)


def knn_build(s, segids, *, k=8):
    """Ragged kNN selection for one packed bin: the batched kernel at
    B = 1. s:(N,ds), segids:(N,) -> (idx:(N,k), d2:(N,k))."""
    idx, d2 = knn_build_batched(s[None], segids[None], k=k)
    return idx[0], d2[0]


def knn_aggregate_batched(f, idx, d2, *, scale=10.0):
    """Gaussian-potential mean/max over built neighbours, one launch.
    f:(B,N,df), idx/d2:(B,N,k) from ``knn_build_batched`` ->
    (B,N,2·df) — the GravNet cell's accumulation."""
    if f.device.type == "cpu":
        return _ref.knn_aggregate_ref(f, idx, d2, scale=scale)
    return knn_aggregate_cuda(f, idx, d2, scale=scale)


def knn_aggregate(f, idx, d2, *, scale=10.0):
    """Aggregation for one packed bin: the batched kernel at B = 1.
    f:(N,df), idx/d2:(N,k) -> (N, 2·df)."""
    return knn_aggregate_batched(f[None], idx[None], d2[None],
                                 scale=scale)[0]


def gravnet_block_ragged(x, segids, ws, bs, wf, bf, wo, bo, *, k=8,
                         scale=10.0, activation="relu"):
    """One GravNet block over bin-packed events: S/F projections
    (``fused_dense``), the segment-masked kNN graph (``knn_build``),
    the aggregation over it (``knn_aggregate``), then the output dense
    of concat(x, agg). x:(B,N,dh) packed hidden activations,
    segids:(B,N) int event ids (−1 padding) -> (B,N,d_out), the
    padding rows zeroed."""
    s = fused_dense_batched(x, ws, bs, activation="none")
    f = fused_dense_batched(x, wf, bf, activation="none")
    idx, d2 = knn_build_batched(s, segids, k=k)
    agg = knn_aggregate_batched(f, idx, d2, scale=scale)
    h = torch.cat([x, agg], dim=-1)
    y = fused_dense_batched(h.contiguous(), wo, bo, activation=activation)
    return y * (segids >= 0).to(y.dtype)[..., None]


def gravnet_block_batched(x, mask, ws, bs, wf, bf, wo, bo, *, k=8,
                          scale=10.0, activation="relu"):
    """One fused GravNet block over a micro-batch, one launch.
    x:(B,N,dh), mask:(B,N) -> (B,N,d_out) = act(concat(x, agg) @ wo + bo);
    neighbours are chosen within each event only."""
    if x.device.type == "cpu":
        return _ref.gravnet_block_ref(x, mask, ws, bs, wf, bf, wo, bo, k=k,
                                      scale=scale, activation=activation)
    return gravnet_block_cuda(x, mask, ws, bs, wf, bf, wo, bo, k=k,
                              scale=scale, activation=activation)


def gravnet_block(x, mask, ws, bs, wf, bf, wo, bo, *, k=8, scale=10.0,
                  activation="relu"):
    """One fused GravNet block for one event: the batched kernel at
    B = 1. x:(N,dh), mask:(N,) -> (N,d_out)."""
    return gravnet_block_batched(x[None], mask[None], ws, bs, wf, bf, wo,
                                 bo, k=k, scale=scale,
                                 activation=activation)[0]


def gravnet_block_int8_batched(x, mask, ws_q, bs, wf_q, bf, wo_q, bo,
                               ws_scale, wf_scale, wo_scale, *, x_scale,
                               agg_scale, h_scale, k=8, scale=10.0,
                               activation="relu"):
    """One quantized GravNet block over a micro-batch, one launch.
    x:(B,N,dh) f32, mask:(B,N) -> (B,N,d_out) f32; int8 weights with
    per-channel scales, the three calibrated activation scales as
    Python floats."""
    args = (x, mask, ws_q, bs, wf_q, bf, wo_q, bo, ws_scale, wf_scale,
            wo_scale)
    kw = dict(x_scale=x_scale, agg_scale=agg_scale, h_scale=h_scale, k=k,
              scale=scale, activation=activation)
    if x.device.type == "cpu":
        return _ref.gravnet_block_int8_ref(*args, **kw)
    return gravnet_block_int8_cuda(*args, **kw)


def gravnet_block_int8(x, mask, *weights, **kw):
    """One quantized GravNet block for one event: the batched kernel at
    B = 1. x:(N,dh), mask:(N,) -> (N,d_out); the other arguments as
    :func:`gravnet_block_int8_batched`'s."""
    return gravnet_block_int8_batched(x[None], mask[None], *weights,
                                      **kw)[0]


def edge_aggregate_batched(messages, edge_index, n_nodes, edge_mask=None, *,
                           reduce="sum"):
    """Masked segment sum / mean of per-edge messages into their
    destination nodes over a micro-batch of graphs, one launch.
    messages:(B,E,d) f32, edge_index:(B,2,E) int (src, dst),
    edge_mask:(B,E)|None -> (B, n_nodes, d); each graph's edges reach
    only its own nodes, and a dst outside [0, n_nodes) contributes
    nothing."""
    bsz, e, _ = messages.shape
    dst = edge_index[:, 1].to(torch.int32).contiguous()
    mask = (torch.ones((bsz, e), dtype=torch.float32,
                       device=messages.device) if edge_mask is None
            else edge_mask.to(torch.float32).contiguous())
    if messages.device.type == "cpu":
        return _ref.edge_aggregate_ref(messages, dst, mask, n_nodes=n_nodes,
                                       reduce=reduce)
    return edge_aggregate_cuda(messages, dst, mask, n_nodes=n_nodes,
                               reduce=reduce)


def edge_aggregate(messages, edge_index, n_nodes, edge_mask=None, *,
                   reduce="sum"):
    """Edge aggregation for one graph: the batched kernel at B = 1.
    messages:(E,d), edge_index:(2,E), edge_mask:(E,)|None ->
    (n_nodes, d)."""
    mask = None if edge_mask is None else edge_mask[None]
    return edge_aggregate_batched(messages[None], edge_index[None], n_nodes,
                                  mask, reduce=reduce)[0]


def _pad_rows(x, block):
    """Zero-pad axis 1 of x:(BH, L, D) up to a multiple of ``block``."""
    return F.pad(x, (0, 0, 0, (-x.shape[1]) % block))


def flash_attention(q, k, v, *, causal=True, bq=128, bk=128):
    """Blockwise (flash) attention. q:(BH,S,D), k/v:(BH,T,D), all f32 or
    all bf16 (computed in f32) -> (BH,S,D) of their dtype. The reference
    wrapper's contract: the blocks shrink to
    ``min(bq, S)`` and ``min(bk, T)``, q, k and v are zero-padded to them
    and the output is cut back to S; a non-causal call whose T is not a
    multiple of bk raises ``ValueError``. Under causal the padded keys
    are not masked beyond the causal rule, as in the reference: where
    S > T, a padded key whose index is at most the row's joins that
    row's softmax with score 0 and value 0."""
    s, t = q.shape[1], k.shape[1]
    bq, bk = min(bq, s), min(bk, t)
    if t % bk and not causal:
        raise ValueError("non-causal flash requires T % bk == 0")
    qp = _pad_rows(q, bq).contiguous()
    kp = _pad_rows(k, bk).contiguous()
    vp = _pad_rows(v, bk).contiguous()
    if q.device.type == "cpu":
        y = _ref.flash_attention_blocked_ref(qp, kp, vp, causal=causal,
                                             bq=bq, bk=bk)
    else:
        y = flash_attention_cuda(qp, kp, vp, causal=causal, bq=bq, bk=bk)
    return y[:, :s]
