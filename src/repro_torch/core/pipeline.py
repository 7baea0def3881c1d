"""Deployment pipeline: run the design flow's passes and emit an
executable.

Counterpart of ``repro/core/pipeline.py`` for the fp policy:
``deploy(graph, Requirements, device=...)`` runs verify → fuse (with the
GravNet block) → partition → precision → mapping → parallelize →
kernel_opt and returns a :class:`CompiledPipeline`, which runs
micro-batch chunks of ``graph.meta["parallelization"]["microbatch"]``
events through the graph's segments. Design points ② and ③ are
supported; they differ only in the dense variant the kernel-opt pass
binds, and on the card both variants launch the same ``fused_dense``
kernel.

What the reference compiles, the port runs eagerly: the P-chunking
``lax.map`` is a Python loop, the whole-pipeline ``jax.jit`` is a plain
call of the segments in order (CUDA graphs are later work). Not ported
yet, and refused with ``NotImplementedError``: the mixed precision
policy (its int8 kernels and calibration), graphs that keep an
unfused ``gravnet_aggregate`` (design point ①), whose kernel is not
ported, and fused blocks whose output dense reads the aggregate alone
(``concat_x=False``; no graph of CaloClusterNet has one).
"""
from __future__ import annotations

from typing import Any

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
from repro_torch.core.passes.verify import verify
from repro_torch.core.quantization import apply_precision_policy
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops

__all__ = ["CompiledPipeline", "Requirements", "deploy"]


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


# --------------------------------------------------------------- executor ----
class _Executor:
    """Runs single operators of a deployed graph on the pipeline's
    device; kernels are reached through ``kernels/ops.py``."""

    def __init__(self, cfg):
        self.cfg = cfg

    def run_op(self, op, vals, feeds):
        t = op.op_type
        if op.precision != "fp":
            raise NotImplementedError(
                f"{op.name}: precision {op.precision!r} is not ported")
        if t == "input":
            return feeds[op.attrs["feature"]]
        if t in ("dense", "linear"):
            return self._dense(op, vals[0])
        if t == "relu":
            return torch.relu(vals[0])
        if t == "concat":
            return torch.cat(vals, dim=-1)
        if t == "slice":
            st, sz = op.attrs["start"], op.attrs["size"]
            return vals[0][..., st:st + sz]
        if t == "retile":
            v = vals[0]
            if op.attrs["to"] == "lane128":
                return F.pad(v, (0, (-v.shape[-1]) % LANE))
            return v[..., :op.out_dim]
        if t == "gravnet_block":
            return self._gravnet_block(op, vals)
        if t == "cps":
            return self._cps(op, vals)
        if t == "output":
            names = op.attrs["head_names"]
            out = {n: vals[i] for i, n in enumerate(names)}
            if len(vals) > len(names):  # cps result dict
                out["cps"] = vals[len(names)]
            return out
        raise NotImplementedError(
            f"no executor for op {op.name!r} ({t!r}) in the port")

    def _dense(self, op, x):
        w = op.params["w"]
        b = op.params.get("b")
        act = op.attrs.get("activation", "none")
        if x.shape[-1] > w.shape[0]:   # lane128-padded input
            w = F.pad(w, (0, 0, 0, x.shape[-1] - w.shape[0]))
        x = x.contiguous()
        if x.ndim == 3:   # row-packs the micro-batch into one launch
            return kops.fused_dense_batched(x, w, b, activation=act)
        return kops.fused_dense(x, w, b, activation=act)

    def _gravnet_block(self, op, vals):
        """One fused GravNet block, one launch for the micro-batch."""
        if not op.attrs.get("concat_x", True):
            raise NotImplementedError(
                f"{op.name}: a gravnet_block whose output dense reads the "
                "aggregate alone (concat_x=False) is not ported; the port's "
                "kernel computes act(concat(x, agg) @ wo + bo)")
        x, mask = vals
        p = op.params
        xf = x[..., :p["ws"].shape[0]].contiguous()  # lane128 producer
        return kops.gravnet_block_batched(
            xf, mask, p["ws"], p["bs"], p["wf"], p["bf"], p["wo"], p["bo"],
            k=op.attrs["k"], scale=op.attrs["scale"],
            activation=op.attrs.get("activation", "none"))

    def _cps(self, op, vals):
        names = op.attrs["head_names"]
        hv = {n: vals[i] for i, n in enumerate(names)}
        outputs = {"beta_logit": hv["beta"][..., 0],
                   "coords": hv["coords"],
                   "energy": hv["energy"][..., 0]}
        return ccn.cps(outputs, vals[-1], self.cfg)


# -------------------------------------------------------- compiled object ----
class CompiledPipeline:
    """A deployed graph bound to a device. ``pipe(feeds)`` takes
    ``{"hits": (B,N,d_in), "mask": (B,N)}`` as numpy arrays or tensors
    and returns the per-hit heads and the CPS dict as tensors on the
    pipeline's device."""

    def __init__(self, graph: Graph, device: torch.device):
        self.device = device
        self.graph = graph.clone()
        for op in self.graph:   # weights move to the device once
            if op.params:
                op.params = {k: v.to(device, torch.float32).contiguous()
                             for k, v in op.params.items()}
        self.segments = segments(self.graph)
        self.microbatch = int(
            self.graph.meta["parallelization"]["microbatch"])
        self._ex = _Executor(self.graph.meta.get("config"))
        self._plans = [self._plan(seg) for seg in self.segments]
        self._out = self.graph.outputs()[0].name

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

        if p_seg >= mb:
            return body(env_in, feeds)
        # a segment with P < microbatch drains the micro-batch in
        # mb / P sequential chunks (the reference's lax.map)
        parts = [body(_tree_map(lambda a: a[c:c + p_seg], env_in),
                      _tree_map(lambda a: a[c:c + p_seg], feeds))
                 for c in range(0, mb, p_seg)]
        return _tree_cat(parts)

    def run_chunk(self, feeds):
        """One micro-batch chunk (exactly ``microbatch`` events, tensors
        on the device) through every segment."""
        env: dict[str, Any] = {}
        for plan in self._plans:
            env.update(self._run_segment(
                plan, {i: env[i] for i in plan[1] if i in env}, feeds))
        return env[self._out]

    def __call__(self, feeds):
        feeds = {k: torch.as_tensor(v).to(self.device)
                 for k, v in feeds.items()}
        b = next(iter(feeds.values())).shape[0]
        mb = self.microbatch
        pad = (-b) % mb
        if pad:
            feeds = {k: torch.cat([v, v.new_zeros((pad, *v.shape[1:]))])
                     for k, v in feeds.items()}
        chunks = [self.run_chunk({k: v[s:s + mb] for k, v in feeds.items()})
                  for s in range(0, b + pad, mb)]
        out = _tree_cat(chunks)
        return _tree_map(lambda a: a[:b], out) if pad else out


# ----------------------------------------------------------------- deploy ----
def deploy(model_graph: Graph, req: Requirements, *, device=None):
    """Run the design flow and emit one executable on ``device``
    (``cuda`` unless ``"cpu"`` is asked for; raises without CUDA)."""
    device = resolve_device(device)
    if req.precision_policy == "mixed":
        raise NotImplementedError(
            "the mixed precision policy needs the fused_dense_int8 and "
            "gravnet_block_int8 kernels and calibration, not ported yet; "
            "deploy with precision_policy='fp'")
    if req.precision_policy != "fp":
        raise ValueError(f"unknown precision policy "
                         f"{req.precision_policy!r}")
    if req.design_point < 2:
        raise NotImplementedError(
            "design point 1 runs the unfused GravNet chain, which needs the "
            "gravnet_aggregate kernel, not ported yet")
    verify(model_graph)  # legality check before any rewrite
    g = fuse(model_graph, gravnet_block=True)
    verify(g)
    unfused = [op.name for op in g if op.op_type == "gravnet_aggregate"]
    if unfused:
        raise NotImplementedError(
            f"{unfused} stay unfused: they need the gravnet_aggregate "
            "kernel, not ported yet")
    g = partition(g, tpu_native_gravnet=req.tpu_native_gravnet)
    g = apply_precision_policy(g, policy="fp")
    g = map_templates(g)
    g = parallelize(g, req)
    if req.design_point >= 3:
        g = kernel_optimize(g, n_rows=req.n_hits)
    return CompiledPipeline(g, device)
