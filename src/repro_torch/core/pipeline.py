"""Deployment pipeline: run the design flow's passes and emit an
executable.

Counterpart of ``repro/core/pipeline.py``: ``deploy(graph, Requirements,
device=...)`` runs verify → fuse → partition → precision → mapping →
parallelize → kernel_opt and returns a :class:`CompiledPipeline`, which
runs micro-batch chunks of ``graph.meta["parallelization"]["microbatch"]``
events through the graph's segments. The three design points are
supported:

  ① no fusion, P = 1, micro-batch 1: the GravNet chain stays unfused
    and runs the ``gravnet_aggregate`` kernel;
  ② + operator fusion (the GravNet block included) + the P search;
  ③ + kernel-level optimizations (kernel binding, retile cancellation,
    int8 chain fusion).

Both precision policies are supported. 'fp' runs everything in f32.
'mixed' (the reference's serve default) runs the interior segments in
int8: ``calibrate`` runs the calibration batch once in f32, takes each
op's activation scale from its max-abs, quantizes the weights per
output channel and bakes the fused blocks' three scales; thereafter
every dense launches ``fused_dense_int8`` and every fused block
``gravnet_block_int8``, and an int8 activation travels between ops as a
:class:`QTensor`. The boundary segments are tagged bf16 but hold only
``input``, ``cps`` and ``output``, which compute in f32 as in the
reference; a bf16 dense has no kernel in the port and raises.

``deploy(..., ragged=True)`` (fp only) emits the padding-free path: a
:class:`RaggedPipeline` that first-fit packs whole events into
``n_hits``-row bins and runs a batch-packed executable whose GravNet
aggregations are the ``knn_build``/``knn_aggregate`` kernel pair with
segment masking, and whose CPS scatters the packed rows back per event.

The edge-based GNNs (``models/gnn/``: GatedGCN, GraphSAGE) deploy
through the same flow, fp: their graphs' ``gather_edge``, ``eltwise``
and ``batchnorm`` ops run in plain PyTorch (the reference's XLA
templates), every ``edge_aggregate`` launches the ``edge_aggregate``
kernel over the micro-batch, with ``req.n_hits`` nodes per graph.

An ``attention`` op (q, k, v) launches the ``flash_attention`` kernel
once per micro-batch, over the graph's (events, rows, d) tensors, with
the (bq, bk) blocks that kernel_opt bound (a tuning cache's winner) or
the kernel's defaults. ``deploy(..., tuning_cache=...)`` binds every
cached winner whose key matches (``repro_torch.tuning``); the
executable's ``backend`` ("cuda" or "cpu") is the backend of its keys.

What the reference compiles with ``jax.jit``, the port captures as CUDA
graphs on ``cuda``. A graph that kernel_opt marked ``fuse_pipeline``
(design point 3) runs each micro-batch chunk as one graph replay: every
segment in order, the P-chunking loop (the reference's ``lax.map``),
CPS and the output. A graph without the mark (design points 1–2) runs
one replay per segment, the reference's per-segment ``jax.jit``, the
segments handing each other static tensors. A chunk shape is captured
at its first call (a warm-up call or the first request): it is run once
eagerly on a side stream (which builds the kernels and answers that
chunk), then captured; later chunks copy their feeds into the static
buffers, replay, and are copied out into the call's result before the
next replay. ``calibrate`` drops every capture, since the int8 scales
and weights are baked into it. A capture that fails raises. What stays
eager: the CPU (the kernels' plain versions, nothing to capture),
``run_chunk`` and ``run_eager`` (calibration, the tests, a deployment
with the plain versions substituted on the card, whose
``edge_aggregate`` reads its loop length back to the host), and the
ragged path's bin packing on the host. Fused blocks, padded or ragged,
whose output dense reads the aggregate alone (``concat_x=False``; no
graph of CaloClusterNet has one) are refused with
``NotImplementedError``.

The serving layer (``repro_torch/serving/``) runs a deployment from
several threads at once, which a capture's static buffers do not allow:
each of its replicas serves through a :class:`Lane` (``pipe.lane()``;
``RaggedLane`` for the ragged path), which shares the weights and owns
its executor, captures and CUDA stream, and returns an
:class:`InFlight` result whose copies to the host do not block.
"""
from __future__ import annotations

import contextlib
import copy
import threading
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import caloclusternet as ccn
from repro_torch.core.graph_ir import Graph
from repro_torch.core.op_registry import LANE
from repro_torch.core.passes.fusion import fuse
from repro_torch.core.passes.kernel_opt import kernel_optimize
from repro_torch.core.passes.mapping import map_templates
from repro_torch.core.passes.parallelize import Requirements, parallelize
from repro_torch.core.passes.partition import partition, segments
from repro_torch.core.passes.ragged import raggedize
from repro_torch.core.passes.verify import verify
from repro_torch.core.quantization import (QMAX, activation_scale,
                                           apply_precision_policy, f32,
                                           quantize_act, quantize_weight)
from repro_torch.data.ragged import (RaggedBatch, bin_pack, pack_events,
                                     unpack_binned)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops

__all__ = ["CompiledPipeline", "InFlight", "Lane", "QTensor", "RaggedLane",
           "RaggedPipeline", "Requirements", "deploy"]


class QTensor(NamedTuple):
    """An int8 activation and its dequantization scale (a Python float)."""
    q: torch.Tensor
    scale: float


def _as_fp(v):
    """The f32 value of an activation: a QTensor is dequantized."""
    if isinstance(v, QTensor):
        return v.q.float() * f32(v.scale)
    return v.float()


def _tree_map(fn, v):
    if isinstance(v, dict):
        return {k: _tree_map(fn, x) for k, x in v.items()}
    return fn(v)


def _tree_cat(parts):
    """Concatenate a list of equally-structured tensors / dicts of
    tensors along axis 0."""
    if isinstance(parts[0], dict):
        return {k: _tree_cat([p[k] for p in parts]) for k in parts[0]}
    return torch.cat(parts, dim=0)


def _tree_copy(dst, src, i):
    """Copy ``src`` into the ``i``-th block of ``len(src)`` rows of
    ``dst``, leaf by leaf (the ``i``-th chunk of a concatenation)."""
    if isinstance(src, dict):
        for k, v in src.items():
            _tree_copy(dst[k], v, i)
    else:
        n = src.shape[0]
        dst[i * n:(i + 1) * n].copy_(src)


def _pad_lane(v):
    return F.pad(v, (0, (-v.shape[-1]) % LANE))


# --------------------------------------------------------------- executor ----
class _Executor:
    """Runs single operators of a deployed graph on the pipeline's
    device; kernels are reached through ``kernels/ops.py``."""

    def __init__(self, cfg, max_events=None, n_hits=None):
        self.cfg = cfg
        self.max_events = max_events    # a ragged graph's CPS capacity
        self.n_hits = n_hits            # nodes per graph (req.n_hits)
        # (edge_index, src, dst) as int64, per thread: concurrent callers
        # of one executor never see each other's edge lists
        self._local = threading.local()

    def run_op(self, op, vals, feeds, *, force_fp=False, record=None):
        """One op. ``force_fp`` runs an int8 op in f32 (calibration);
        ``record`` collects each activation's max-abs by op name."""
        t = op.op_type
        prec = "fp" if force_fp else op.precision
        if t == "input":
            out = feeds[op.attrs["feature"]]
        elif t in ("dense", "linear"):
            out = self._dense(op, vals[0], prec)
        elif t == "relu":
            v = vals[0]
            out = (QTensor(torch.clamp_min(v.q, 0), v.scale)
                   if isinstance(v, QTensor) else torch.relu(v))
        elif t == "concat":
            if (all(isinstance(v, QTensor) for v in vals)
                    and len({v.scale for v in vals}) == 1):
                out = QTensor(torch.cat([v.q for v in vals], dim=-1),
                              vals[0].scale)
            else:
                out = torch.cat([_as_fp(v) for v in vals], dim=-1)
        elif t == "slice":
            st, sz = op.attrs["start"], op.attrs["size"]
            v = vals[0]
            out = (QTensor(v.q[..., st:st + sz], v.scale)
                   if isinstance(v, QTensor) else v[..., st:st + sz])
        elif t == "retile":
            v = vals[0]
            if op.attrs["to"] == "lane128":
                out = (QTensor(_pad_lane(v.q), v.scale)
                       if isinstance(v, QTensor) else _pad_lane(v))
            else:
                d = op.out_dim
                out = (QTensor(v.q[..., :d], v.scale)
                       if isinstance(v, QTensor) else v[..., :d])
        elif t == "gravnet_aggregate":
            out = self._gravnet(op, vals, prec)
        elif t == "knn_build":
            out = self._knn_build(op, vals)
        elif t == "knn_aggregate":
            out = self._knn_aggregate(op, vals)
        elif t == "gravnet_block":
            out = self._gravnet_block(op, vals, prec)
        elif t == "attention":
            out = self._attention(op, vals)
        elif t == "gather_edge":
            out = self._gather_edge(op, vals)
        elif t == "edge_aggregate":
            out = self._edge_aggregate(op, vals)
        elif t == "eltwise":
            out = self._eltwise(op, vals)
        elif t == "batchnorm":
            out = self._batchnorm(op, vals)
        elif t == "cps":
            out = self._cps(op, vals)
        elif t == "output":
            names = op.attrs["head_names"]
            out = {n: _as_fp(vals[i]) for i, n in enumerate(names)}
            if len(vals) > len(names):  # cps result dict
                out["cps"] = vals[len(names)]
        else:
            raise NotImplementedError(
                f"no executor for op {op.name!r} ({t!r}) in the port")
        if record is not None and t not in ("cps", "output", "input"):
            record[op.name] = _as_fp(out).abs().max().item()
        return out

    def _dense(self, op, x, prec):
        w = op.params["w"]
        b = op.params.get("b")
        act = op.attrs.get("activation", "none")
        if prec == "int8" and "w_q" in op.params:
            if isinstance(x, QTensor):
                xq, in_scale = x.q, x.scale
            else:
                in_scale = op.attrs["in_scale"]
                xq = quantize_act(x, in_scale)
            wq = op.params["w_q"]
            if xq.shape[-1] > wq.shape[0]:   # lane128-padded input
                wq = F.pad(wq, (0, 0, 0, xq.shape[-1] - wq.shape[0]))
            emit8 = op.attrs_opt.get("emit_int8", False)
            out_scale = op.attrs.get("act_scale", 1.0)
            # one launch for the micro-batch, its events row-packed
            y = kops.fused_dense_int8(
                xq.reshape(-1, xq.shape[-1]).contiguous(), wq, b, in_scale,
                op.params["w_scale"], activation=act, out_int8=emit8,
                out_scale=out_scale).reshape(*xq.shape[:-1], -1)
            return QTensor(y, out_scale) if emit8 else y
        # float path (fp, or an int8 op not calibrated yet)
        if prec == "bf16":
            raise NotImplementedError(
                f"{op.name}: a bf16 dense has no kernel in the port")
        # a lane128-padded input: the dense reads its own K through the
        # row stride (a view, no copy) with the unpadded w
        x = _as_fp(x).contiguous()
        if x.shape[-1] > w.shape[0]:
            x = x[..., :w.shape[0]]
        if x.ndim == 3:   # row-packs the micro-batch into one launch
            return kops.fused_dense_batched(x, w, b, activation=act)
        return kops.fused_dense(x, w, b, activation=act)

    def _gravnet(self, op, vals, prec):
        """The unfused aggregation, one launch for the micro-batch; an
        int8 op snaps its output to the int8 grid of its scale."""
        s, f, mask = vals
        sf = _as_fp(s)[..., :op.attrs["d_s"]].contiguous()
        ff = _as_fp(f)[..., :op.attrs["d_f"]].contiguous()
        agg = kops.gravnet_aggregate_batched(sf, ff, mask, k=op.attrs["k"],
                                             scale=op.attrs["scale"])
        if prec == "int8" and "act_scale" in op.attrs:
            sc = f32(op.attrs["act_scale"])
            agg = torch.clamp(torch.round(agg / sc), -QMAX, QMAX) * sc
        return agg

    def _knn_build(self, op, vals):
        """Ragged neighbour selection over a micro-batch of packed bins,
        one launch; returns the (idx, d2) tuple its knn_aggregate
        consumes."""
        s, segids = vals
        sf = _as_fp(s)[..., :op.attrs["d_s"]].contiguous()  # lane128
        return kops.knn_build_batched(sf, segids, k=op.attrs["k"])

    def _knn_aggregate(self, op, vals):
        """The aggregation over a knn_build's (idx, d2). The ragged path
        is fp only, so there is no int8 snap here (deploy refuses
        ragged=True under mixed)."""
        f, (idx, d2) = vals
        ff = _as_fp(f)[..., :op.attrs["d_f"]].contiguous()
        return kops.knn_aggregate_batched(ff, idx, d2,
                                          scale=op.attrs["scale"])

    def _gravnet_block(self, op, vals, prec):
        """One fused GravNet block, one launch for the micro-batch: the
        quantized kernel with its baked scales for a calibrated int8
        block, the f32 kernel otherwise. A raggedized block (its mask
        input carries segment ids) runs the ragged chain instead: the
        S/F denses, knn_build, knn_aggregate and the output dense."""
        if not op.attrs.get("concat_x", True):
            raise NotImplementedError(
                f"{op.name}: a gravnet_block whose output dense reads the "
                "aggregate alone (concat_x=False) is not ported; the port's "
                "kernels compute act(concat(x, agg) @ wo + bo)")
        p, a = op.params, op.attrs
        if a.get("ragged"):
            x, segids = vals
            return kops.gravnet_block_ragged(
                _as_fp(x)[..., :p["ws"].shape[0]].contiguous(), segids,
                p["ws"], p["bs"], p["wf"], p["bf"], p["wo"], p["bo"],
                k=a["k"], scale=a["scale"],
                activation=a.get("activation", "none"))
        x, mask = vals
        xf = _as_fp(x)[..., :p["ws"].shape[0]].contiguous()  # lane128
        kw = dict(k=a["k"], scale=a["scale"],
                  activation=a.get("activation", "none"))
        if prec == "int8" and "ws_q" in p:
            return kops.gravnet_block_int8_batched(
                xf, mask, p["ws_q"], p["bs"], p["wf_q"], p["bf"], p["wo_q"],
                p["bo"], p["ws_scale"], p["wf_scale"], p["wo_scale"],
                x_scale=a["in_scale"], agg_scale=a["agg_scale"],
                h_scale=a["h_scale"], **kw)
        return kops.gravnet_block_batched(
            xf, mask, p["ws"], p["bs"], p["wf"], p["bf"], p["wo"], p["bo"],
            **kw)

    def _attention(self, op, vals):
        """Blockwise attention over the micro-batch, one launch: q, k, v
        are (B, N, d) in f32, the op's bound (bq, bk) if any."""
        d = op.out_dim
        q, k, v = (_as_fp(t)[..., :d].contiguous() for t in vals)
        kw = {kn: op.attrs_opt[kn] for kn in ("bq", "bk")
              if kn in op.attrs_opt}
        return kops.flash_attention(q, k, v,
                                    causal=op.attrs.get("causal", True),
                                    **kw)

    def forget_endpoints(self):
        """Drop the calling thread's cached (src, dst)."""
        self._local.ei = None

    def _endpoints(self, ei):
        """(src, dst) of an edge list (B,2,E) as int64 gather indices,
        made once per edge list and thread (every gather of a call
        shares it); an edge list written since (a static feed buffer
        refilled in place) is read anew."""
        cached = getattr(self._local, "ei", None)
        if cached is None or cached[0] is not ei or cached[1] != ei._version:
            cached = self._local.ei = (ei, ei._version, ei[:, 0].long(),
                                       ei[:, 1].long())
        return cached[2:]

    def _gather_edge(self, op, vals):
        """Endpoint gather by the edge list: x:(B,N,d), ei:(B,2,E) ->
        (B,E,d). Data-dependent, a plain PyTorch gather (the reference's
        ``xla_gather``)."""
        x, ei = vals
        xf = _as_fp(x)[..., :op.out_dim]        # lane128-padded producer
        src, dst = self._endpoints(ei)
        idx = src if op.attrs["endpoint"] == "src" else dst
        return torch.gather(xf, 1, idx[..., None].expand(-1, -1,
                                                         xf.shape[-1]))

    def _edge_aggregate(self, op, vals):
        """Masked segment sum/mean of per-edge messages into nodes, one
        ``edge_aggregate`` launch for the micro-batch."""
        msgs, ei = vals[0], vals[1]
        mask = _as_fp(vals[2]) if len(vals) > 2 else None
        mf = _as_fp(msgs)[..., :op.out_dim].contiguous()
        n_nodes = int(op.attrs.get("n_nodes") or self.n_hits)
        return kops.edge_aggregate_batched(
            mf, ei, n_nodes, mask, reduce=op.attrs.get("reduce", "sum"))

    def _eltwise(self, op, vals):
        """N-ary elementwise algebra; ``fn`` picks the operation."""
        fn = op.attrs["fn"]
        d = op.out_dim
        if fn == "mask":                # x:(B,R,d) * mask:(B,R)
            x, m = _as_fp(vals[0])[..., :d], _as_fp(vals[1])
            return x * m[..., None]
        xs = [_as_fp(v)[..., :d] for v in vals]
        if fn in ("add", "mul"):
            y = xs[0]
            for v in xs[1:]:
                y = y + v if fn == "add" else y * v
            return y
        if fn == "div":
            return xs[0] / xs[1]
        if fn == "sigmoid":
            return torch.sigmoid(xs[0])
        if fn == "relu":
            return torch.relu(xs[0])
        if fn == "add_const":
            return xs[0] + op.attrs["const"]
        if fn == "l2norm":
            return xs[0] / torch.clamp_min(torch.linalg.vector_norm(
                xs[0], dim=-1, keepdim=True), 1e-6)
        raise ValueError(f"{op.name}: unknown eltwise fn {fn!r}")

    def _batchnorm(self, op, vals):
        """Masked per-graph batch normalization (the benchmarking-gnns
        training-mode statistics, over each graph of the micro-batch):
        x:(B,R,d), mask:(B,R)."""
        x, mask = vals
        xf = _as_fp(x)[..., :op.out_dim]
        m = _as_fp(mask)[..., None]
        n = torch.clamp_min(m.sum(dim=1, keepdim=True), 1.0)
        mu = (xf * m).sum(dim=1, keepdim=True) / n
        var = (((xf - mu) ** 2) * m).sum(dim=1, keepdim=True) / n
        eps = op.attrs.get("eps", 1e-5)
        return (xf - mu) * torch.rsqrt(var + eps) * m

    def _cps(self, op, vals):
        names = op.attrs["head_names"]
        hv = {n: _as_fp(vals[i]) for i, n in enumerate(names)}
        if op.attrs.get("ragged"):
            return self._cps_ragged(hv, vals[-2], vals[-1])
        outputs = {"beta_logit": hv["beta"][..., 0],
                   "coords": hv["coords"],
                   "energy": hv["energy"][..., 0]}
        return ccn.cps(outputs, vals[-1], self.cfg)

    def _cps_ragged(self, hv, segids, slots):
        """Scatter the packed rows back to the per-event layout
        (max_events, n_hits) — a bin is n_hits rows wide, so every slot
        fits — then run the unchanged per-event condensation. Padding
        rows (segid −1) would wrap around as negative indices, so they
        are sent to an extra event row max_events, which is dropped."""
        e_max = int(self.max_events)
        n = segids.shape[1]
        seg = segids.reshape(-1).long()
        seg = torch.where(seg < 0, e_max, seg)
        slot = slots.reshape(-1).long()

        def scatter(h):
            h2 = h.reshape(-1, *h.shape[2:])
            out = h2.new_zeros((e_max + 1, n, *h2.shape[1:]))
            out[seg, slot] = h2
            return out[:e_max]

        mask = scatter(torch.ones(segids.shape, dtype=torch.float32,
                                  device=segids.device))
        outputs = {"beta_logit": scatter(hv["beta"])[..., 0],
                   "coords": scatter(hv["coords"]),
                   "energy": scatter(hv["energy"])[..., 0]}
        return ccn.cps(outputs, mask, self.cfg)

    def run(self, graph, feeds, *, force_fp=False, record=None):
        """Every op of ``graph`` in order over the whole batch of
        ``feeds``, with no chunking; returns (output, env)."""
        env: dict[str, Any] = {}
        result = None
        for op in graph:
            vals = [env[i] for i in op.inputs]
            env[op.name] = self.run_op(op, vals, feeds, force_fp=force_fp,
                                       record=record)
            if op.op_type == "output":
                result = env[op.name]
        return result, env


# --------------------------------------------------------------- capture ----
class _CudaGraphs:
    """The capture backend on the card: ``torch.cuda`` graphs on the
    pipeline's device, warmed up on a side stream of its own."""

    def __init__(self, device: torch.device):
        self.device = device
        self._side = None

    def fork(self):
        """A backend of its own for a lane (``Lane``) on the same card."""
        return _CudaGraphs(self.device)

    def warmup(self, fn):
        """``fn()`` eagerly on the side stream, ordered after and before
        the current stream's work."""
        cur = torch.cuda.current_stream(self.device)
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        self._side.wait_stream(cur)
        with torch.cuda.stream(self._side):
            out = fn()
        cur.wait_stream(self._side)
        return out

    def capture(self, fn, pool=None):
        """(graph, static outputs) of ``fn`` captured into one CUDA graph;
        graphs given the same ``pool`` share memory and replay in the
        order they were captured."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool):
            out = fn()
        return graph, out

    @staticmethod
    def pool(graph):
        return graph.pool()

    @staticmethod
    def replay(graph):
        graph.replay()


class _Captured(NamedTuple):
    feeds: dict       # static feed buffers, (microbatch, ...) each
    graphs: list      # replayed in order: one (fused) or one per segment
    out: Any          # static outputs, overwritten by the next replay
    launches: dict    # the wrappers' launch counts one replay adds


class _ChunkGraphs:
    """A CompiledPipeline's chunk captured per feed signature (names,
    shapes and dtypes): one graph for a ``fuse_pipeline`` graph, else
    one per segment. ``backend`` is :class:`_CudaGraphs` on the card;
    the tests inject a recording stand-in on the CPU."""

    def __init__(self, pipe, backend):
        self.pipe = pipe
        self.backend = backend
        self._by_sig: dict[tuple, _Captured] = {}

    def __len__(self):
        return len(self._by_sig)

    def clear(self):
        self._by_sig.clear()

    def run(self, feeds):
        """The outputs of one chunk: a replay of its captured graphs
        (static tensors, valid until the next replay), or, the first
        time its signature is seen, the eager warm-up run's."""
        sig = tuple((k, tuple(v.shape), v.dtype)
                    for k, v in sorted(feeds.items()))
        cap = self._by_sig.get(sig)
        if cap is None:
            out, self._by_sig[sig] = self._capture(feeds)
            return out
        for k, v in feeds.items():
            cap.feeds[k].copy_(v)
        for graph in cap.graphs:
            self.backend.replay(graph)
        # a replay calls no wrapper: its launches are counted here
        kops.add_launches(cap.launches)
        return cap.out

    def _capture(self, feeds):
        pipe = self.pipe
        static = {k: v.clone() for k, v in feeds.items()}
        # builds the kernels and answers this chunk; its launches ran
        out = self.backend.warmup(lambda: pipe.run_chunk(static))
        # the counters' lock is held from the save to the restore, so no
        # other lane's replay adds into the window that is restored
        with kops.COUNTS_LOCK:
            return out, self._record(static)

    def _record(self, static):
        pipe = self.pipe
        before = kops.launch_counts()
        # no cached (src, dst) crosses into or out of a graph's pool
        pipe._ex.forget_endpoints()
        try:
            if pipe._fused:
                graph, static_out = self.backend.capture(
                    lambda: pipe.run_chunk(static))
                graphs = [graph]
            else:
                graphs, env, pool = [], {}, None
                for plan in pipe._plans:
                    env_in = {i: env[i] for i in plan[1] if i in env}
                    if pipe._feeds_only(plan):
                        # launches nothing: its outputs are the feeds
                        env.update(pipe._run_segment(plan, env_in, static))
                        continue
                    graph, seg_out = self.backend.capture(
                        lambda plan=plan, env_in=env_in: pipe._run_segment(
                            plan, env_in, static), pool)
                    pool = pool or self.backend.pool(graph)
                    graphs.append(graph)
                    env.update(seg_out)
                static_out = env[pipe._out]
            after = kops.launch_counts()
        finally:
            pipe._ex.forget_endpoints()
            # a capture records its launches without running them
            kops.set_launch_counts(before)
        launches = {k: n - before.get(k, 0) for k, n in after.items()
                    if n != before.get(k, 0)}
        return _Captured(static, graphs, static_out, launches)


# -------------------------------------------------------- compiled object ----
class CompiledPipeline:
    """A deployed graph bound to a device. ``pipe(feeds)`` takes one
    array per ``input`` op's feature, each with the events on its
    leading axis, as numpy arrays or tensors (CaloClusterNet:
    ``{"hits": (B,N,d_in), "mask": (B,N)}``; the edge-based GNNs:
    ``nodes``, ``edge_index`` (B,2,E), ``node_mask``, ``edge_mask`` and
    GatedGCN's ``edges``), and returns the graph's output heads (and
    CaloClusterNet's CPS dict) as tensors on the pipeline's device.

    ``batch > 1`` pins a batch-packed executable: ``batch`` events per
    chunk, each segment running the whole chunk at once (no P-chunking).
    ``backend`` names the kernels' route for the tuning layer: "cuda"
    (the hand-written kernels) or "cpu" (their plain versions).

    On ``cuda`` a call replays each chunk's captured CUDA graphs (one
    per chunk under ``fuse_pipeline``, else one per segment), capturing
    a chunk shape the first time it is seen; ``captures`` counts the
    shapes captured. ``run_eager`` runs the same chunks without capture.
    """

    def __init__(self, graph: Graph, device: torch.device, *,
                 batch: int = 1):
        self.device = device
        self.backend = backend_of(device)
        self.graph = graph.clone()
        for op in self.graph:   # weights move to the device once
            if op.params:
                op.params = {k: v.to(device, torch.float32 if
                                     v.is_floating_point() else v.dtype)
                             .contiguous() for k, v in op.params.items()}
        self.segments = segments(self.graph)
        self.batch_packed = batch > 1
        self.microbatch = (batch if self.batch_packed else int(
            self.graph.meta["parallelization"]["microbatch"]))
        self._ex = _Executor(self.graph.meta.get("config"),
                             self.graph.meta.get("ragged_max_events"),
                             self.graph.meta.get("n_hits"))
        self._plans = [self._plan(seg) for seg in self.segments]
        self._out = self.graph.outputs()[0].name
        self._fused = bool(self.graph.meta.get("fuse_pipeline"))
        self._graphs = (_ChunkGraphs(self, _CudaGraphs(device))
                        if device.type == "cuda" else None)

    def _plan(self, seg):
        g = self.graph
        names = set(seg["ops"])
        ins, outs = [], []
        for op in g:
            if op.name in names:
                ins += [i for i in op.inputs if i not in names
                        and i not in ins]
            else:
                outs += [i for i in op.inputs
                         if i in names and i not in outs]
        for op in g.outputs():
            if op.name in names and op.name not in outs:
                outs.append(op.name)
        return [g[n] for n in seg["ops"]], ins, outs

    def _feeds_only(self, plan) -> bool:
        """Whether a segment only hands on its feeds, as views (input
        ops, no P-chunking loop that would concatenate them)."""
        ops_ = plan[0]
        return all(op.op_type == "input" for op in ops_) and (
            self.batch_packed
            or ops_[0].attrs_opt.get("P", 1) >= self.microbatch)

    def _run_segment(self, plan, env_in, feeds):
        ops_, _, outs = plan
        p_seg = ops_[0].attrs_opt.get("P", 1)
        mb = self.microbatch

        def body(env_in, feeds):
            env = dict(env_in)
            for op in ops_:
                vals = [env.get(i) for i in op.inputs]
                env[op.name] = self._ex.run_op(op, vals, feeds)
            return {o: env[o] for o in outs}

        if self.batch_packed or p_seg >= mb:
            return body(env_in, feeds)
        # a segment with P < microbatch drains the micro-batch in
        # mb / P sequential chunks (the reference's lax.map)
        parts = [body(_tree_map(lambda a: a[c:c + p_seg], env_in),
                      _tree_map(lambda a: a[c:c + p_seg], feeds))
                 for c in range(0, mb, p_seg)]
        return _tree_cat(parts)

    @property
    def captures(self) -> int:
        """Chunk shapes captured as CUDA graphs so far (0 on the CPU)."""
        return 0 if self._graphs is None else len(self._graphs)

    def run_chunk(self, feeds):
        """One micro-batch chunk (exactly ``microbatch`` events, tensors
        on the device) through every segment, eagerly."""
        env: dict[str, Any] = {}
        for plan in self._plans:
            env.update(self._run_segment(
                plan, {i: env[i] for i in plan[1] if i in env}, feeds))
        return env[self._out]

    def _on_device(self, feeds):
        # from pinned host tensors (a lane's input ring) the copies do not
        # block; from pageable memory they do, as before the lanes
        out = {}
        for k, v in feeds.items():
            t = torch.as_tensor(v)
            out[k] = t.to(self.device, non_blocking=t.is_pinned())
        return out

    # calibration + weight quantization ------------------------------------
    def calibrate(self, feeds):
        """Run the whole calibration batch once in f32 through every op
        (no chunking), set each op's activation scale from its max-abs,
        quantize the int8 denses' weights per output channel and bake
        the int8 blocks' scales."""
        if self._graphs is not None:   # the captures bake the scales in
            self._graphs.clear()
        record: dict[str, float] = {}
        _, env = self._ex.run(self.graph, self._on_device(feeds),
                              force_fp=True, record=record)
        for op in self.graph:
            if op.name in record:
                op.attrs["act_scale"] = activation_scale(record[op.name])
        for op in self.graph:
            if op.op_type in ("dense", "linear") and op.precision == "int8":
                op.attrs["in_scale"] = self.graph[op.inputs[0]].attrs.get(
                    "act_scale", 1.0)
                op.params["w_q"], op.params["w_scale"] = quantize_weight(
                    op.params["w"])
            elif op.op_type == "gravnet_block" and op.precision == "int8":
                self._calibrate_block(op, env)

    def _calibrate_block(self, op, env):
        """The fused int8 block's three baked scales from the f32
        calibration run. The block hides the chain's interior tensors
        from the recording, so S, F and the aggregate are recomputed
        here from the block's f32 input through the kernels' entry
        points: ``in_scale`` is the producer's activation scale,
        ``agg_scale`` the aggregate's and ``h_scale`` that of
        ``concat(x, agg)``, as the unfused chain's ops record them.
        Weights quantize per output channel."""
        a, p = op.attrs, op.params
        prod = op.inputs[0]
        a["in_scale"] = self.graph[prod].attrs.get("act_scale", 1.0)
        x = _as_fp(env[prod])[..., :p["ws"].shape[0]].contiguous()
        mask = _as_fp(env[op.inputs[1]])
        s = kops.fused_dense_batched(x, p["ws"], p["bs"], activation="none")
        f = kops.fused_dense_batched(x, p["wf"], p["bf"], activation="none")
        agg = kops.gravnet_aggregate_batched(s, f, mask, k=a["k"],
                                             scale=a["scale"])
        a["agg_scale"] = activation_scale(agg.abs().max().item())
        h = torch.cat([x, agg], dim=-1) if a.get("concat_x", True) else agg
        a["h_scale"] = activation_scale(h.abs().max().item())
        for nm in ("ws", "wf", "wo"):
            p[nm + "_q"], p[nm + "_scale"] = quantize_weight(p[nm])

    # inference -------------------------------------------------------------
    def _chunks(self, feeds):
        """(events, padded events, the chunks' feeds): the feeds on the
        device, zero-padded to whole micro-batches."""
        feeds = self._on_device(feeds)
        b = next(iter(feeds.values())).shape[0]
        mb = self.microbatch
        pad = (-b) % mb
        if pad:
            feeds = {k: torch.cat([v, v.new_zeros((pad, *v.shape[1:]))])
                     for k, v in feeds.items()}
        return b, b + pad, [{k: v[s:s + mb] for k, v in feeds.items()}
                            for s in range(0, b + pad, mb)]

    def run_eager(self, feeds):
        """A call without capture: ``run_chunk`` per chunk."""
        b, total, chunks = self._chunks(feeds)
        out = _tree_cat([self.run_chunk(c) for c in chunks])
        return _tree_map(lambda a: a[:b], out) if total > b else out

    def lane(self, device=None) -> "Lane":
        """A serving lane of this deployment (:class:`Lane`), on its
        device or on ``device``."""
        return Lane(self, device)

    def __call__(self, feeds):
        if self._graphs is None:
            return self.run_eager(feeds)
        b, total, chunks = self._chunks(feeds)
        out = None
        for i, chunk in enumerate(chunks):
            part = self._graphs.run(chunk)
            if out is None:
                out = _tree_map(lambda a: a.new_empty(
                    (len(chunks) * a.shape[0], *a.shape[1:])), part)
            # out of the static outputs before the next replay
            _tree_copy(out, part, i)
        return _tree_map(lambda a: a[:b], out) if total > b else out


# ----------------------------------------------------------------- deploy ----
def backend_of(device: torch.device) -> str:
    """The tuning-key backend of a device: the kernels on ``cuda``,
    their plain versions on the CPU."""
    return "cuda" if device.type == "cuda" else "cpu"


def deploy(model_graph: Graph, req: Requirements, *, calibration_feeds=None,
           tuning_cache=None, fuse_gravnet_block: bool = True,
           fuse_int8: bool = True, batch: int = 1, ragged: bool = False,
           max_events: int | None = None, device=None):
    """Run the design flow and emit one executable on ``device``
    (``cuda`` unless ``"cpu"`` is asked for; raises without CUDA).

    ``fuse_gravnet_block`` (default on) collapses every fusable GravNet
    chain into one ``gravnet_block`` at design points ≥ 2; ``False``
    keeps the unfused chain, whose aggregation runs the
    ``gravnet_aggregate`` kernel. The mixed policy needs
    ``calibration_feeds`` (``{"hits", "mask"}``) and then fuses its
    blocks into the quantized kernel; ``fuse_int8=False`` keeps the
    unfused calibrated int8 chain under mixed while fp still fuses.

    ``batch > 1`` emits a batch-packed executable: kernels are bound for
    the shapes one whole micro-batch of ``batch`` events launches, and
    every segment runs it at once (no P-chunking).

    ``ragged=True`` emits a padding-free executable (fp only, as in the
    reference): after fusion the graph is raggedized
    (``passes/ragged.py``) to take whole events first-fit packed into
    ``req.n_hits``-row bins (``data/ragged.py``), neighbours chosen by
    the ``knn_build`` kernel with segment masking and aggregated by
    ``knn_aggregate``. ``batch`` then counts bins per launch, and
    ``max_events`` (default ``2 * batch``) the events one launch's CPS
    holds; a call with more is split into launches, never truncated.
    Returns a :class:`RaggedPipeline`.

    ``tuning_cache`` (a ``repro_torch.tuning.TuningCache``) binds, at
    design point 3, every cached winner whose key (kernel, shape, dtype,
    and the backend of ``device``) matches an op's launch; a miss keeps
    the heuristic binding."""
    device = resolve_device(device)
    if req.precision_policy not in ("fp", "mixed"):
        raise ValueError(f"unknown precision policy "
                         f"{req.precision_policy!r}")
    mixed = req.precision_policy == "mixed"
    if ragged and mixed:
        raise NotImplementedError(
            "deploy(ragged=True) does not support the mixed precision "
            "policy (the reference has no quantized ragged block)")
    if mixed and calibration_feeds is None:
        raise ValueError("mixed precision requires calibration_feeds")
    verify(model_graph)  # legality check before any rewrite
    g = model_graph
    if req.design_point >= 2:
        g = fuse(g, gravnet_block=fuse_gravnet_block
                 and (not mixed or fuse_int8))
        verify(g)        # fusion must preserve well-formedness
    if ragged:
        g = raggedize(g)
        verify(g)        # so must the ragged rewrite
        g.meta["ragged_max_events"] = int(max_events or 2 * batch)
    g = partition(g, tpu_native_gravnet=req.tpu_native_gravnet)
    g = apply_precision_policy(g, policy=req.precision_policy)
    g = map_templates(g)
    if req.design_point >= 2:
        g = parallelize(g, req)
    else:
        for op in g:
            op.attrs_opt["P"] = 1
        g.meta["parallelization"] = {"P_mxu": 1, "P_xla": 1, "microbatch": 1,
                                     "model_throughput_ev_s": None,
                                     "target": req.target_throughput}
    if req.design_point >= 3:
        g = kernel_optimize(g, n_rows=req.n_hits, batch=batch,
                            tuning_cache=tuning_cache,
                            backend=backend_of(device))
    g.meta["n_hits"] = req.n_hits   # nodes per graph of edge_aggregate
    pipe = CompiledPipeline(g, device, batch=batch)
    if mixed:
        pipe.calibrate(calibration_feeds)
    if ragged:
        return RaggedPipeline(pipe, max_events=g.meta["ragged_max_events"],
                              capacity=req.n_hits,
                              example_feeds=calibration_feeds)
    return pipe


# ------------------------------------------------------ ragged deployment ----
class RaggedPipeline:
    """Padding-free, bin-packed deployment (``deploy(ragged=True)``).

    Wraps one raggedized ``CompiledPipeline`` whose launch is a fixed
    number of ``capacity``-row bins (its micro-batch). ``__call__`` takes
    a ``data.ragged.RaggedBatch`` (concatenated hits and CSR offsets) or
    the padded ``{"hits", "mask"}`` feeds; it first-fit packs whole
    events into bins, caps each launch at the executable's bin count and
    at ``max_events`` events (the CPS scatter's capacity: more events
    split into more launches, never truncate), and scatters the results
    back per event: ``{head: (n_events, capacity, d), "cps": {...:
    (n_events, ...)}}`` as numpy arrays, an event's hits in its first
    rows.
    """

    def __init__(self, pipe: CompiledPipeline, *, max_events: int,
                 capacity: int, example_feeds: dict | None = None):
        if not pipe.graph.meta.get("ragged"):
            raise ValueError("RaggedPipeline needs a raggedized graph "
                             "(deploy(ragged=True) builds one)")
        self.pipe = pipe
        self.backend = pipe.backend
        # bins per launch = the executable's micro-batch, so every launch
        # is exactly one chunk (a zero pad bin would alias segment id 0)
        self.microbatch = int(pipe.microbatch)
        self.max_events = int(max_events)
        self.capacity = int(capacity)
        self._example = example_feeds

    def _plan_launches(self, counts) -> list[tuple[int, int]]:
        """Split the events into contiguous ``[i, j)`` launch ranges by
        replaying ``bin_pack``'s first-fit packing, closing a launch when
        the next event would need a ``microbatch+1``-th bin or exceed
        ``max_events``."""
        launches = []
        start, n_ev, free = 0, 0, []
        for e, c in enumerate(counts):
            c = int(c)
            if c > self.capacity:
                raise ValueError(
                    f"event {e} has {c} hits > bin capacity "
                    f"{self.capacity} — it cannot be packed")
            placed = False
            for i, f in enumerate(free):
                if c <= f:
                    free[i] -= c
                    placed = True
                    break
            needs_bin = not placed
            if (needs_bin and len(free) == self.microbatch) \
                    or n_ev == self.max_events:
                launches.append((start, e))
                start, n_ev, free = e, 0, []
                needs_bin = True
            if needs_bin:
                free.append(self.capacity - c)
            n_ev += 1
        if n_ev or not launches:
            launches.append((start, start + n_ev))
        return launches

    @property
    def captures(self) -> int:
        """The inner executable's captured chunk shapes (one launch
        layout: 1 once warm on the card, 0 on the CPU)."""
        return self.pipe.captures

    def __call__(self, feeds):
        return self._launch(feeds, self.pipe)

    def run_eager(self, feeds):
        """A call whose launches run without capture
        (``CompiledPipeline.run_eager``)."""
        return self._launch(feeds, self.pipe.run_eager)

    def _launch(self, feeds, run):
        if isinstance(feeds, RaggedBatch):
            rb = feeds
        else:
            rb = pack_events(np.asarray(feeds["hits"]),
                             np.asarray(feeds["mask"]))
        offs = np.asarray(rb.offsets)
        parts = []
        for i, j in self._plan_launches(rb.counts()):
            sub = RaggedBatch(feats=rb.feats[offs[i]:offs[j]],
                              offsets=offs[i:j + 1] - offs[i])
            bp = bin_pack(sub, self.capacity, n_bins=self.microbatch)
            out = run({"hits": bp.feats,
                       "mask": (bp.segids >= 0).astype(np.float32),
                       "segids": bp.segids, "slots": bp.slots})
            n_ev = j - i
            part = {}
            for name, v in out.items():
                if name == "cps":
                    part[name] = {k: a[:n_ev].cpu().numpy()
                                  for k, a in v.items()}
                else:
                    part[name] = unpack_binned(v.cpu().numpy(), bp.segids,
                                               bp.slots, n_ev,
                                               self.capacity)
            parts.append(part)
        if len(parts) == 1:
            return parts[0]

        def cat(*xs):
            if isinstance(xs[0], dict):
                return {k: cat(*(x[k] for x in xs)) for k in xs[0]}
            return np.concatenate(xs, axis=0)
        return cat(*parts)

    def lane(self, device=None) -> "RaggedLane":
        """A serving lane of this deployment (:class:`RaggedLane`)."""
        return RaggedLane(self, device)

    def warmup_feeds(self) -> dict:
        """The example feeds (the calibration batch given to ``deploy``),
        else a synthetic full-occupancy batch."""
        if self._example is not None:
            return {k: np.asarray(v) for k, v in self._example.items()
                    if k in ("hits", "mask")}
        rng = np.random.default_rng(0)
        shape = (self.microbatch, self.capacity)
        d = self.pipe.graph["hits"].out_dim
        return {"hits": rng.normal(size=(*shape, d)).astype(np.float32),
                "mask": np.ones(shape, np.float32)}

    def warmup(self) -> int:
        """One call on :meth:`warmup_feeds`, so the first real call pays
        no first-use cost (kernel builds, the allocator's first blocks,
        and on the card the capture of the launch layout, whose every
        launch then replays one CUDA graph). Returns 1."""
        self(self.warmup_feeds())
        return 1


# ------------------------------------------------------------------ lanes ----
class InFlight(NamedTuple):
    """A lane's result while the card may still be writing it: ``out``,
    a tree of host tensors that non-blocking copies fill, and ``done``,
    the event recorded on the lane's stream behind those copies (None
    when the result is complete, as on the CPU). The counterpart of a
    jitted call's unfinished arrays and their ``is_ready()``."""
    out: Any
    done: Any = None

    def ready(self) -> bool:
        return self.done is None or self.done.query()

    def wait(self):
        """``out``, once the copies into it have landed."""
        if self.done is not None:
            self.done.synchronize()
        return self.out


def _to_host(dev, out):
    """Non-blocking copies of the device tree ``dev`` into the host tree
    ``out``; a leaf that is missing there or of another shape or dtype is
    allocated pinned."""
    if isinstance(dev, dict):
        out = out if isinstance(out, dict) else {}
        return {k: _to_host(v, out.get(k)) for k, v in dev.items()}
    if out is None or out.shape != dev.shape or out.dtype != dev.dtype:
        out = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
    return out.copy_(dev, non_blocking=True)


def _same_device(a: torch.device, b: torch.device) -> bool:
    if a.type != b.type:
        return False
    if a.type == "cpu":
        return True
    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == \
        (cur if b.index is None else b.index)


class Lane:
    """One serving lane of a deployed :class:`CompiledPipeline`.

    The lane shares the pipeline's weights, plans and kernel bindings
    (on another card, it holds a copy of them there). It owns what a call
    mutates: its executor (the per-call caches), its captured chunk graphs
    (static feeds and outputs, never shared with another lane) and, on
    ``cuda``, a ``torch.cuda.Stream``. The lanes of one pipeline run side
    by side on the card; the calls of one lane are serialized by its lock,
    so two threads never interleave their copies into its static buffers.

    ``lane(feeds, out=None)`` enqueues one call on the lane's stream and
    returns an :class:`InFlight` at once: the feeds copied in (without
    blocking from pinned host tensors), each chunk replayed, the outputs
    copied out without blocking into ``out`` (host tensors, e.g. a slot
    of the caller's output ring; pinned ones are allocated where it has
    none) and an event recorded behind them. The calling thread enters
    the stream itself (PyTorch's current stream is per thread). On the
    CPU the call runs eagerly and its result is complete.

    ``warmup()`` captures every chunk shape that the pipeline has
    captured (the pipeline's warm-up call at the serving width decides
    them). A capture in the default global mode fails if another thread
    calls CUDA meanwhile, so the lanes of a service capture one after
    another, before their replicas take traffic; a pipeline on the card
    with no capture to give its lanes raises. Make lanes after
    ``calibrate``: the captures bake its scales in.
    """

    def __init__(self, pipe: CompiledPipeline, device=None):
        device = pipe.device if device is None else torch.device(device)
        base = pipe if _same_device(device, pipe.device) else \
            CompiledPipeline(pipe.graph, device, batch=pipe.microbatch
                             if pipe.batch_packed else 1)
        run = copy.copy(base)       # the weights, plans and bindings
        run._ex = _Executor(base._ex.cfg, base._ex.max_events,
                            base._ex.n_hits)
        run._graphs = (None if base._graphs is None else
                       _ChunkGraphs(run, base._graphs.backend.fork()))
        self.parent = pipe
        self.device = base.device
        self.microbatch = pipe.microbatch
        self._run = run
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        self._lock = threading.Lock()

    @property
    def captures(self) -> int:
        """Chunk shapes this lane has captured (0 on the CPU)."""
        return 0 if self._run._graphs is None else len(self._run._graphs)

    def _on_stream(self):
        return (contextlib.nullcontext() if self.stream is None
                else torch.cuda.stream(self.stream))

    def warmup(self) -> int:
        """Capture the pipeline's captured chunk shapes on this lane, on
        the feeds its captures hold; returns :attr:`captures`."""
        if self._run._graphs is None:
            return 0
        src = self.parent._graphs
        if src is None or not len(src):
            raise RuntimeError(
                "the pipeline has captured no chunk shape for its lanes to "
                "capture: call it once at the serving width first")
        if self.stream is not None:      # the parent's last replay lands
            torch.cuda.synchronize(self.parent.device)
        with self._lock, self._on_stream():
            for cap in list(src._by_sig.values()):
                self._run._graphs.run({k: v.to(self.device)
                                       for k, v in cap.feeds.items()})
        return self.captures

    def __call__(self, feeds, out=None) -> InFlight:
        with self._lock, self._on_stream():
            res = self._run(feeds)
            if self.stream is None:
                return InFlight(res)
            host = _to_host(res, out)
            done = torch.cuda.Event()
            done.record(self.stream)
        return InFlight(host, done)


class RaggedLane:
    """One serving lane of a :class:`RaggedPipeline`: the pipeline's
    packing on the host around a :class:`Lane` of its inner executable.
    A call waits for each of its launches while it unpacks them, so its
    :class:`InFlight` is complete (numpy per event, as the pipeline
    returns). ``warmup()`` calls the lane once on the pipeline's warm-up
    feeds, which captures its launch layout."""

    def __init__(self, rp: RaggedPipeline, device=None):
        self.parent = rp
        self.lane = Lane(rp.pipe, device)
        self.device, self.stream = self.lane.device, self.lane.stream
        self.microbatch = rp.microbatch
        self.capacity = rp.capacity

    @property
    def captures(self) -> int:
        return self.lane.captures

    def warmup(self) -> int:
        self(self.parent.warmup_feeds())
        return self.captures

    def __call__(self, feeds, out=None) -> InFlight:
        return InFlight(self.parent._launch(
            feeds, lambda f: self.lane(f).wait()))
