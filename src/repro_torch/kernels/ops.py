"""Public kernel entry points of the port.

Counterpart of ``repro/kernels/ops.py`` for the kernels this port has.
The device of the tensors decides the route, and nothing else does: a
CPU tensor goes to the plain PyTorch version (``kernels/ref.py``), a
CUDA tensor to the hand-written kernel, which raises on what it does
not take. There is no backend switch and no fallback. The kernels mask
ragged shapes themselves, so no wrapper pads, except
:func:`flash_attention`, which pads S and T to its blocks as the
reference's wrapper does. The launch knobs keep the reference's
keyword names: ``bm`` (a CTA's query or destination rows; a dense's tile
rows), ``bn`` (a dense's tile columns, the edge kernel's message
columns), flash's ``bq`` and ``bk``. None is the kernel's own plan. A
knob the kernel cannot run raises ``ValueError`` on either device (the
plain versions ignore the knobs but check them, so a bad cached knob
fails on the CPU as it would on the card). Float operands are float32
or bfloat16; the
kernels compute in f32 and, as the reference's ops, return the input's
dtype (the quantized block: f32 or int8). :func:`edge_aggregate_batched` (and
:func:`edge_aggregate`) carry a gradient in their messages, the
training path's: the forward is the kernel, the backward a gather in
plain PyTorch (:func:`edge_aggregate_grad`), as the reference's gradient
is XLA's transpose of its segment sum.
"""
from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

from repro_torch.kernels import edge_aggregate as _edge
from repro_torch.kernels import fused_dense as _dense
from repro_torch.kernels import gravnet as _gravnet
from repro_torch.kernels import gravnet_block as _block
from repro_torch.kernels import knn_build as _knn
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


def _given(**knobs) -> dict:
    """The launch knobs a caller gave (None is the kernel's own plan), as
    the keywords of its wrapper: a call without knobs reaches the
    wrapper, or whatever takes its place, as it did before the knobs."""
    return {k: v for k, v in knobs.items() if v is not None}


def _check_knobs(plan, *args, **knobs) -> None:
    """Where a call runs a plain version, which ignores the launch knobs:
    raise as the kernel's wrapper would on a knob it cannot run (its own
    ``plan``), so that a bad knob fails on either device."""
    if _given(**knobs):
        plan(*args, **knobs)


def fused_dense(x, w, b=None, *, activation="relu", bm=None, bn=None):
    """act(x @ w + b). x:(M,K) w:(K,N) b:(N,)|None -> (M,N); (bm, bn)
    one of the kernel's tiles (``fused_dense.variant_of``)."""
    if x.device.type == "cpu":
        _check_knobs(_dense.variant_of, x.shape[0], w.shape[1], bm=bm, bn=bn)
        return _ref.fused_dense_ref(x, w, b, activation=activation)
    return fused_dense_cuda(x, w, b, activation=activation,
                            **_given(bm=bm, bn=bn))


def fused_dense_batched(x, w, b=None, *, activation="relu", bm=None,
                        bn=None):
    """act(x @ w + b) over a micro-batch x:(B,M,K) in one launch: the
    events are row-packed into one (B·M, K) product (a dense couples no
    rows, so packing is exact), a view where x's rows lie at one stride,
    as in a column slice of a contiguous tensor."""
    bsz, m, kdim = x.shape
    y = fused_dense(x.reshape(bsz * m, kdim), w, b, activation=activation,
                    bm=bm, bn=bn)
    return y.reshape(bsz, m, -1)


def fused_dense_int8(x_q, w_q, b, x_scale, w_scale, *, activation="relu",
                     out_int8=False, out_scale=1.0, bm=None, bn=None):
    """The quantized dense: act(x_q @ w_q · (x_scale·w_scale) + b), f32,
    or requantized to int8 with ``out_scale`` when ``out_int8``.
    x_q:(M,K) int8, w_q:(K,N) int8, b:(N,)|None, w_scale:(N,) ->
    (M,N); (bm, bn) one of ``fused_dense.INT8_TILES``."""
    if x_q.device.type == "cpu":
        _check_knobs(_dense.int8_tile_of, bm=bm, bn=bn)
        return _ref.fused_dense_int8_ref(x_q, w_q, b, x_scale, w_scale,
                                         activation=activation,
                                         out_int8=out_int8,
                                         out_scale=out_scale)
    return fused_dense_int8_cuda(x_q, w_q, b, x_scale, w_scale,
                                 activation=activation, out_int8=out_int8,
                                 out_scale=out_scale,
                                 **_given(bm=bm, bn=bn))


def gravnet_aggregate_batched(s, f, mask, *, k=8, scale=10.0, bm=None):
    """GravNet aggregation over a micro-batch, one launch.
    s:(B,N,ds), f:(B,N,df), mask:(B,N) -> (B,N,2·df) = concat(mean, max)
    over each row's k nearest valid rows of its own event; ``bm`` rows a
    CTA (``gravnet.plan``)."""
    if s.device.type == "cpu":
        _check_knobs(_gravnet.plan, s.shape[1], s.shape[0], f.shape[2],
                     bm=bm)
        return _ref.gravnet_aggregate_ref(s, f, mask, k=k, scale=scale)
    return gravnet_aggregate_cuda(s, f, mask, k=k, scale=scale,
                                  **_given(bm=bm))


def gravnet_aggregate(s, f, mask, *, k=8, scale=10.0, bm=None):
    """GravNet aggregation for one event: the batched kernel at B = 1.
    s:(N,ds), f:(N,df), mask:(N,) -> (N, 2·df)."""
    return gravnet_aggregate_batched(s[None], f[None], mask[None], k=k,
                                     scale=scale, bm=bm)[0]


def knn_build_batched(s, segids, *, k=8, bm=None):
    """Ragged kNN selection over a micro-batch of packed bins, one
    launch. s:(B,N,ds), segids:(B,N) int event ids (−1 padding) ->
    (idx:(B,N,k) int32, d2:(B,N,k) f32): per row, the k nearest rows of
    its own event (ties to the lowest column, self excluded); a slot
    with no candidate left has d2 = 1e30 (consumers gate on d2). ``bm``
    rows a CTA (``knn_build.build_plan``)."""
    if s.device.type == "cpu":
        _check_knobs(_knn.build_plan, s.shape[1], s.shape[0], bm=bm)
        return _ref.knn_build_ref(s, segids, k=k)
    return knn_build_cuda(s, segids, k=k, **_given(bm=bm))


def knn_build(s, segids, *, k=8, bm=None):
    """Ragged kNN selection for one packed bin: the batched kernel at
    B = 1. s:(N,ds), segids:(N,) -> (idx:(N,k), d2:(N,k))."""
    idx, d2 = knn_build_batched(s[None], segids[None], k=k, bm=bm)
    return idx[0], d2[0]


def knn_aggregate_batched(f, idx, d2, *, scale=10.0, bm=None):
    """Gaussian-potential mean/max over built neighbours, one launch.
    f:(B,N,df), idx/d2:(B,N,k) from ``knn_build_batched`` ->
    (B,N,2·df) — the GravNet cell's accumulation; ``bm`` rows a CTA
    (``knn_build.aggregate_plan``)."""
    if f.device.type == "cpu":
        _check_knobs(_knn.aggregate_plan, f.shape[1], f.shape[0],
                     f.shape[2], bm=bm)
        return _ref.knn_aggregate_ref(f, idx, d2, scale=scale)
    return knn_aggregate_cuda(f, idx, d2, scale=scale, **_given(bm=bm))


def knn_aggregate(f, idx, d2, *, scale=10.0, bm=None):
    """Aggregation for one packed bin: the batched kernel at B = 1.
    f:(N,df), idx/d2:(N,k) -> (N, 2·df)."""
    return knn_aggregate_batched(f[None], idx[None], d2[None],
                                 scale=scale, bm=bm)[0]


def gravnet_block_ragged(x, segids, ws, bs, wf, bf, wo, bo, *, k=8,
                         scale=10.0, activation="relu", concat_x=True,
                         bm=None):
    """One GravNet block over bin-packed events: S/F projections
    (``fused_dense``), the segment-masked kNN graph (``knn_build``),
    the aggregation over it (``knn_aggregate``), then the output dense
    of concat(x, agg), or of agg alone without ``concat_x``.
    x:(B,N,dh) packed hidden activations, segids:(B,N) int event ids
    (−1 padding) -> (B,N,d_out), the padding rows zeroed. ``bm`` is the
    kNN pair's rows a CTA, as in the reference."""
    s = fused_dense_batched(x, ws, bs, activation="none")
    f = fused_dense_batched(x, wf, bf, activation="none")
    idx, d2 = knn_build_batched(s, segids, k=k, bm=bm)
    agg = knn_aggregate_batched(f, idx, d2, scale=scale, bm=bm)
    h = torch.cat([x, agg], dim=-1) if concat_x else agg
    y = fused_dense_batched(h.contiguous(), wo, bo, activation=activation)
    return y * (segids >= 0).to(y.dtype)[..., None]


def gravnet_block_batched(x, mask, ws, bs, wf, bf, wo, bo, *, k=8,
                          scale=10.0, activation="relu", concat_x=True,
                          bm=None):
    """One fused GravNet block over a micro-batch, one launch.
    x:(B,N,dh), mask:(B,N) -> (B,N,d_out) = act(concat(x, agg) @ wo + bo),
    or act(agg @ wo + bo) without ``concat_x``; neighbours are chosen
    within each event only. ``bm`` rows a CTA (``gravnet_block.plan``)."""
    kw = dict(k=k, scale=scale, activation=activation, concat_x=concat_x)
    if x.device.type == "cpu":
        _check_knobs(_block.plan, x.shape[1], x.shape[2], ws.shape[1],
                     wf.shape[1], wo.shape[1], concat_x, bm=bm)
        return _ref.gravnet_block_ref(x, mask, ws, bs, wf, bf, wo, bo, **kw)
    return gravnet_block_cuda(x, mask, ws, bs, wf, bf, wo, bo, **kw,
                              **_given(bm=bm))


def gravnet_block(x, mask, ws, bs, wf, bf, wo, bo, **kw):
    """One fused GravNet block for one event: the batched kernel at
    B = 1. x:(N,dh), mask:(N,) -> (N,d_out); the keywords as
    :func:`gravnet_block_batched`'s."""
    return gravnet_block_batched(x[None], mask[None], ws, bs, wf, bf, wo,
                                 bo, **kw)[0]


def gravnet_block_int8_batched(x, mask, ws_q, bs, wf_q, bf, wo_q, bo,
                               ws_scale, wf_scale, wo_scale, *, x_scale,
                               agg_scale, h_scale, k=8, scale=10.0,
                               activation="relu", concat_x=True,
                               out_int8=False, out_scale=1.0, bm=None):
    """One quantized GravNet block over a micro-batch, one launch.
    x:(B,N,dh) f32, mask:(B,N) -> (B,N,d_out) f32, or int8 requantized
    with ``out_scale`` when ``out_int8``; int8 weights with per-channel
    scales, the calibrated activation scales as Python floats; the
    output dense over concat(x, agg), or agg alone without
    ``concat_x``; ``bm`` rows a CTA (``gravnet_block.int8_plan``)."""
    args = (x, mask, ws_q, bs, wf_q, bf, wo_q, bo, ws_scale, wf_scale,
            wo_scale)
    kw = dict(x_scale=x_scale, agg_scale=agg_scale, h_scale=h_scale, k=k,
              scale=scale, activation=activation, concat_x=concat_x,
              out_int8=out_int8, out_scale=out_scale)
    if x.device.type == "cpu":
        _check_knobs(_block.int8_plan, x.shape[1], x.shape[2],
                     ws_q.shape[1], wf_q.shape[1], wo_q.shape[1], concat_x,
                     bm=bm)
        return _ref.gravnet_block_int8_ref(*args, **kw)
    return gravnet_block_int8_cuda(*args, **kw, **_given(bm=bm))


def gravnet_block_int8(x, mask, *weights, **kw):
    """One quantized GravNet block for one event: the batched kernel at
    B = 1. x:(N,dh), mask:(N,) -> (N,d_out); the other arguments as
    :func:`gravnet_block_int8_batched`'s."""
    return gravnet_block_int8_batched(x[None], mask[None], *weights,
                                      **kw)[0]


def edge_aggregate_batched(messages, edge_index, n_nodes, edge_mask=None, *,
                           reduce="sum", bm=None, bn=None):
    """Masked segment sum / mean of per-edge messages into their
    destination nodes over a micro-batch of graphs, one launch.
    messages:(B,E,d), edge_index:(B,2,E) int (src, dst),
    edge_mask:(B,E)|None -> (B, n_nodes, d) of the messages' dtype
    (summed in f32); each graph's edges reach
    only its own nodes, and a dst outside [0, n_nodes) contributes
    nothing. Differentiable in ``messages`` (:class:`_EdgeAggregate`);
    ``edge_mask`` is data and may not require a gradient. ``bm`` rows and
    ``bn`` message columns a CTA (``edge_aggregate.plan``)."""
    bsz, e, _ = messages.shape
    if edge_mask is not None and edge_mask.requires_grad:
        raise ValueError("edge_aggregate: edge_mask is data; it has no "
                         "gradient (detach it)")
    from repro_torch.dist.sharding import is_distributed
    if is_distributed(messages, edge_index, edge_mask):
        return _edge_aggregate_sharded(messages, edge_index, n_nodes,
                                       edge_mask, reduce, bm, bn)
    dst = edge_index[:, 1].to(torch.int32).contiguous()
    mask = (torch.ones((bsz, e), dtype=torch.float32,
                       device=messages.device) if edge_mask is None
            else edge_mask.to(torch.float32).contiguous())
    if messages.requires_grad and torch.is_grad_enabled():
        return _EdgeAggregate.apply(messages, dst, mask, n_nodes, reduce, bm,
                                    bn)
    return _edge_aggregate_route(messages, dst, mask, n_nodes, reduce, bm,
                                 bn)


def _edge_aggregate_sharded(messages, edge_index, n_nodes, edge_mask,
                            reduce, bm=None, bn=None):
    """:func:`edge_aggregate_batched` of DTensors, run on each device's
    shards (the kernel takes raw pointers). The graphs (dim 0) and the
    message features (dim 2) keep their sharding. Edges sharded over
    some mesh dims (1D edge partitioning) leave each device a partial
    node sum over its edges: the output is ``Partial`` there, reduced
    by DTensor where it is next read (the all-reduce XLA's partitioner
    adds to a scatter-add of sharded updates); ``mean`` divides the
    reduced sums by the reduced in-degrees."""
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard)
    from torch.distributed.tensor.experimental import local_map
    mesh = next(x.device_mesh for x in (messages, edge_index, edge_mask)
                if isinstance(x, DTensor))

    def dt(x):
        return x if isinstance(x, DTensor) else DTensor.from_local(
            x, mesh, [Replicate()] * mesh.ndim, run_check=False)
    messages = dt(messages)
    edge_mask = dt(torch.ones(messages.shape[:2], dtype=torch.float32,
                              device=messages.device)
                   if edge_mask is None else edge_mask)
    dst = dt(edge_index)[:, 1]
    mpl, dpl, opl = [], [], []
    for m, pl in enumerate(messages.placements):
        if isinstance(pl, Shard) and pl.dim in (0, 1, 2) and (
                messages.shape[pl.dim] % mesh.size(m) == 0):
            mpl.append(pl)
            dpl.append(pl if pl.dim < 2 else Replicate())
            opl.append(Partial() if pl.dim == 1 else pl)
        else:
            mpl.append(Replicate())
            dpl.append(Replicate())
            opl.append(Replicate())
    edge_sharded = any(p == Shard(1) for p in mpl)
    local_reduce = "sum" if edge_sharded else reduce

    def local(msg, dst_l, mask_l):
        ei = torch.stack([dst_l, dst_l], dim=1)
        return edge_aggregate_batched(msg, ei, n_nodes, mask_l,
                                      reduce=local_reduce, bm=bm, bn=bn)

    def run(msg, plc):
        return local_map(local, out_placements=(tuple(opl),),
                         in_placements=(plc, tuple(dpl), tuple(dpl)),
                         device_mesh=mesh, redistribute_inputs=True)(
            msg, dst, edge_mask)
    out = run(messages, tuple(mpl))
    if reduce == "mean" and edge_sharded:
        # the masked in-degree: the sum of each edge's mask (times 1)
        ones = torch.ones_like(edge_mask)[..., None]
        deg = run(ones, tuple(p if p != Shard(2) else Replicate()
                              for p in dpl))
        out = out / torch.clamp_min(deg, 1.0)
    return out


def _edge_aggregate_traced(messages, dst, mask, n_nodes, reduce):
    """The segment sum as one scatter-add, the reference's ``xla`` path,
    for fake tensors (a dry-run's: the plain version's loop runs to the
    largest in-degree, a value fake tensors do not hold)."""
    bsz, e, d = messages.shape
    key = dst.long()
    valid = (key >= 0) & (key < n_nodes)
    idx = torch.where(valid, key, 0)
    w = torch.where(valid, mask.float(), 0.0)
    acc = torch.zeros((bsz, n_nodes, d), dtype=torch.float32,
                      device=messages.device).scatter_add_(
        1, idx[..., None].expand(bsz, e, d), w[..., None] * messages.float())
    if reduce == "mean":
        cnt = torch.zeros((bsz, n_nodes), dtype=torch.float32,
                          device=messages.device).scatter_add_(1, idx, w)
        acc = acc / torch.clamp_min(cnt, 1.0)[..., None]
    return acc.to(messages.dtype)


def _edge_aggregate_route(messages, dst, mask, n_nodes, reduce, bm=None,
                          bn=None):
    from torch._subclasses.fake_tensor import is_fake
    if is_fake(messages):
        return _edge_aggregate_traced(messages, dst, mask, n_nodes, reduce)
    if messages.device.type == "cpu":
        _check_knobs(_edge.plan, n_nodes, messages.shape[2],
                     messages.shape[0], bm=bm, bn=bn)
        return _ref.edge_aggregate_ref(messages, dst, mask, n_nodes=n_nodes,
                                       reduce=reduce)
    return edge_aggregate_cuda(messages, dst, mask, n_nodes=n_nodes,
                               reduce=reduce, **_given(bm=bm, bn=bn))


def edge_aggregate_grad(g, dst, mask, n_nodes, reduce="sum"):
    """The gradient of :func:`edge_aggregate_batched` in its messages, in
    plain PyTorch: for edge e, ``mask[e]·g[dst[e]]`` (``sum``), with g
    divided first by the destination's masked in-degree, at least 1
    (``mean``); 0 where dst lies outside [0, n_nodes). g:(B,n,d),
    dst:(B,E) int, mask:(B,E) f32 -> (B,E,d). A gather, as the
    reference's gradient is (XLA's transpose of ``segment_sum``); the
    in-degree of ``mean`` is a scatter of the masks, exact in any order
    for 0/1 masks."""
    bsz, e = dst.shape
    key = dst.long()
    valid = (key >= 0) & (key < n_nodes)
    idx = torch.where(valid, key, 0)
    w = torch.where(valid, mask.float(), 0.0)
    if reduce == "mean":
        cnt = torch.zeros((bsz, n_nodes), dtype=torch.float32,
                          device=g.device).scatter_add_(1, idx, w)
        g = g / torch.clamp_min(cnt, 1.0)[..., None]
    ge = torch.gather(g, 1, idx[..., None].expand(bsz, e, g.shape[-1]))
    return ge * w[..., None]


class _EdgeAggregate(torch.autograd.Function):
    """:func:`edge_aggregate_batched` with a gradient in its messages:
    the forward is the kernel on ``cuda`` (its plain version on the
    CPU), the backward :func:`edge_aggregate_grad`; no gradient to dst
    or the mask."""

    @staticmethod
    def forward(ctx, messages, dst, mask, n_nodes, reduce, bm, bn):
        ctx.save_for_backward(dst, mask)
        ctx.n_nodes, ctx.reduce = n_nodes, reduce
        return _edge_aggregate_route(messages, dst, mask, n_nodes, reduce,
                                     bm, bn)

    @staticmethod
    def backward(ctx, g):
        dst, mask = ctx.saved_tensors
        return (edge_aggregate_grad(g, dst, mask, ctx.n_nodes, ctx.reduce),
                None, None, None, None, None, None)


def edge_aggregate(messages, edge_index, n_nodes, edge_mask=None, *,
                   reduce="sum", bm=None, bn=None):
    """Edge aggregation for one graph: the batched kernel at B = 1.
    messages:(E,d), edge_index:(2,E), edge_mask:(E,)|None ->
    (n_nodes, d)."""
    mask = None if edge_mask is None else edge_mask[None]
    return edge_aggregate_batched(messages[None], edge_index[None], n_nodes,
                                  mask, reduce=reduce, bm=bm, bn=bn)[0]


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
