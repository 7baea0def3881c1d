"""Spatial-parallelization pass (paper §III-A "Spatial Parallelization").

Counterpart of ``repro/core/passes/parallelize.py``: an exhaustive search
over power-of-two replication factors (P_mxu, P_xla) for the smallest
pair that meets the throughput target within the latency budget. P is
the event micro-batch a segment takes per step; a segment with a
smaller P runs the pipeline's micro-batch in B/P chunks. Segments
serialize on one device, so a step's modelled time is the latency the
budget constrains and the micro-batch over it the throughput.

The cost model prices each op on ``Requirements.platform``:

- ``"h100"`` (the default; the card the port deploys on): each op costs
  its kernel launches (``op_registry.op_launches``; an int8 dense that
  quantizes an f32 input counts that too) times the device time one
  launch takes inside a captured chunk (a hand kernel's, which carries a
  CTA's staging round trip, or a plain PyTorch kernel's), plus the
  larger of its compute and its bytes. An op that launches a hand kernel
  (its spec has an ``sm_fill`` hook: the executor launches one for every
  dense, GravNet, kNN, edge and attention op, whatever its target)
  computes at the kernel's rate, int8 for the int8 dense and f32 without
  FMA for the others (``flash_attention``, built with FMA, at the full
  f32 rate), times the share of the SMs its launch fills at P; a plain
  PyTorch op at the measured plain rate. Bytes move at the HBM rate. The
  constants are ``launch/mesh.py``'s ``H100_*``: datasheet figures, and
  the launch costs and plain rate measured on the card (NVIDIA H100 80GB
  HBM3, 700.00 W).
- ``"cpu"``: the reference's order-of-magnitude CPU constants and its
  MXU size factors, so the port picks the reference's P and micro-batch
  (the differential tests hold it to them).

The cost hooks (``op_registry``'s ``_cost_*``) count work, not a chip:
both platforms read them.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.graph_ir import Graph
from repro_torch.core.op_registry import (default_cost, op_launches,
                                          require_spec)
from repro_torch.launch import mesh as hw

#: the platforms the cost model prices ops on
PLATFORMS = ("h100", "cpu")


@dataclasses.dataclass
class Requirements:
    """The design flow's second input: target throughput, latency
    budget, platform of the cost model, design point, graph size."""
    target_throughput: float = 1.0e6     # events / s / replica-group
    max_latency_s: float | None = None   # trigger budget (paper: 10 µs)
    platform: str = "h100"               # cost-model constants: h100 | cpu
    design_point: int = 3                # ① ② ③
    n_hits: int = 128                    # graph size per event
    precision_policy: str = "mixed"      # 'fp' | 'mixed' (paper: 16b/8b)
    tpu_native_gravnet: bool = False     # beyond-paper partitioning
    max_p: int = 256


def op_cost(op, n_hits: int, *, precision_bytes: float = 1.0):
    """(flops, act_bytes, weight_bytes) per event, from the op's
    registered cost hook."""
    cost = require_spec(op).cost or default_cost
    return cost(op, n_hits, precision_bytes)


def _mxu_efficiency(op, n_rows: int, n_hits: int = 128) -> float:
    eff = require_spec(op).mxu_eff
    return eff(op, n_rows, n_hits) if eff is not None else 1.0


def _kernel_rate(op) -> float:
    """The compute rate of the hand kernel ``op`` launches: the int8
    dense on int8 tensor cores, flash attention at the f32 rate (built
    with FMA), every other source without FMA (``kernels/_build.py``)."""
    from repro_torch.core.passes.kernel_opt import fused_dense_dtype
    if op.op_type in ("dense", "linear") and fused_dense_dtype(op) == "int8":
        return hw.H100_PEAK_OPS_INT8
    if op.op_type == "attention":
        return hw.H100_PEAK_FLOPS_F32
    return hw.H100_PEAK_FLOPS_F32_NO_FMA


def sm_fill(op, n_hits: int, p: int) -> float | None:
    """The share of the card's SMs that ``op``'s hand-kernel launch over
    p events fills, or None for an op that launches none."""
    fill = require_spec(op).sm_fill
    return fill(op, n_hits, p) if fill is not None else None


def op_time_h100(op, n_hits: int, p: int, g: Graph | None = None) -> float:
    """Modelled device seconds of one call of ``op`` (of graph ``g``)
    over p events on the card: its launches' fixed cost (a hand kernel's
    for its own, a plain kernel's for an int8 dense's quantization of an
    f32 input and for every plain op), plus the larger of compute and
    bytes."""
    flops, act, wb = op_cost(op, n_hits)
    fill = sm_fill(op, n_hits, p)
    rate = (hw.H100_PLAIN_FLOPS if fill is None
            else _kernel_rate(op) * fill)
    t_compute = p * flops / rate
    t_mem = (p * act + wb) / hw.H100_HBM_BW
    own = op_launches(op)
    launches = (own * (hw.H100_LAUNCH_S if fill is None
                       else hw.H100_KERNEL_LAUNCH_S)
                + (op_launches(op, g) - own) * hw.H100_LAUNCH_S)
    return launches + max(t_compute, t_mem)


def segment_time(ops, n_hits: int, p: int, platform: str = "h100",
                 g: Graph | None = None) -> float:
    """Modelled seconds for one segment step processing p events (on
    "h100", ``g`` the ops' graph, which decides where an int8 dense
    quantizes its input)."""
    if platform == "h100":
        return sum(op_time_h100(op, n_hits, p, g) for op in ops)
    if platform != "cpu":
        raise ValueError(f"unknown platform {platform!r} (one of "
                         f"{PLATFORMS})")
    # the reference's calibrated-order-of-magnitude CPU constants
    # (relative use only)
    peak_mxu = peak_vpu = 5e10
    bw = 2e10
    t = 0.0
    for op in ops:
        flops, act, wb = op_cost(op, n_hits)
        is_mm = require_spec(op).mxu_matmul and op.target == "mxu"
        eff = _mxu_efficiency(op, n_hits * p, n_hits) if is_mm else 1.0
        peak = peak_mxu if is_mm else peak_vpu
        t_compute = p * flops / (eff * peak)
        t_mem = (p * act + wb) / bw
        t += max(t_compute, t_mem) + 1e-7  # fixed per-op issue overhead
    return t


def model_step(g: Graph, req: "Requirements", p_mxu: int,
               p_xla: int) -> tuple[float, float]:
    """(events/s, seconds a step) of ``g``'s segments at (P_mxu, P_xla)
    on ``req.platform``: segments serialize on one device, so the
    throughput is the micro-batch over the total time, and the total is
    the modelled per-event decision latency the trigger budget
    constrains."""
    segs: dict[int, list] = {}
    for op in g:
        segs.setdefault(op.segment or 0, []).append(op)
    b = max(p_mxu, p_xla)  # pipeline micro-batch width
    total = 0.0
    for ops in segs.values():
        p = p_mxu if ops[0].target == "mxu" else p_xla
        total += (b // p) * segment_time(ops, req.n_hits, p, req.platform,
                                         g)
    return (b / total if total > 0 else float("inf")), total


def parallelize(g: Graph, req: Requirements) -> Graph:
    """Pick the smallest (P_mxu, P_xla) meeting the throughput target."""
    if req.platform not in PLATFORMS:
        raise ValueError(f"unknown platform {req.platform!r} (one of "
                         f"{PLATFORMS})")
    g = g.clone()
    max_lat = req.max_latency_s or float("inf")
    pows = [2 ** i for i in range(int(math.log2(req.max_p)) + 1)]
    best = None
    fallback = None
    for p_mxu in pows:
        for p_xla in pows:
            if max(p_mxu, p_xla) % min(p_mxu, p_xla) != 0:
                continue
            tp, lat = model_step(g, req, p_mxu, p_xla)
            if lat <= max_lat and (fallback is None or tp > fallback[3]):
                fallback = (p_mxu + p_xla, p_mxu, p_xla, tp, lat)
            if tp >= req.target_throughput and lat <= max_lat:
                cost = p_mxu + p_xla  # resource proxy (paper: minimize P)
                if best is None or cost < best[0]:
                    best = (cost, p_mxu, p_xla, tp, lat)
    if best is None:
        # target unreachable within the latency budget: best-throughput
        # latency-feasible point (or P=1 if even that busts the budget)
        best = fallback or (2, 1, 1) + model_step(g, req, 1, 1)
    _, p_mxu, p_xla, tp, lat = best
    for op in g:
        op.attrs_opt["P"] = p_mxu if op.target == "mxu" else p_xla
    g.meta["parallelization"] = {
        "P_mxu": p_mxu, "P_xla": p_xla, "microbatch": max(p_mxu, p_xla),
        "model_throughput_ev_s": tp, "model_latency_s": lat,
        "target": req.target_throughput, "max_latency_s": max_lat,
    }
    return g
