"""Spatial-parallelization pass (paper §III-A "Spatial Parallelization").

Counterpart of ``repro/core/passes/parallelize.py``: an exhaustive search
over power-of-two replication factors (P_mxu, P_xla) for the smallest
pair that meets the throughput target within the latency budget. P is
the event micro-batch a segment takes per step; a segment with a
smaller P runs the pipeline's micro-batch in B/P chunks. The cost model
and its constants are the reference's — ``platform="tpu"`` reads
``launch/mesh.py``, ``platform="cpu"`` the order-of-magnitude CPU
constants — so the port picks the reference's P and micro-batch. They
are not a model of the H100.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.graph_ir import Graph
from repro_torch.core.op_registry import default_cost, require_spec
from repro_torch.launch import mesh as hw

VPU_PEAK = 4e12  # v5e vector unit, FLOP/s (non-MXU ops)


@dataclasses.dataclass
class Requirements:
    """The design flow's second input: target throughput, latency
    budget, platform of the cost model, design point, graph size."""
    target_throughput: float = 1.0e6     # events / s / replica-group
    max_latency_s: float | None = None   # trigger budget (paper: 10 µs)
    platform: str = "tpu"                # cost-model constants: tpu | cpu
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


def segment_time(ops, n_hits: int, p: int, platform: str = "tpu") -> float:
    """Modelled seconds for one segment step processing p events."""
    if platform == "tpu":
        peak_mxu, peak_vpu, bw = hw.PEAK_FLOPS_BF16, VPU_PEAK, hw.HBM_BW
    else:  # calibrated-order-of-magnitude CPU constants (relative use only)
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


def parallelize(g: Graph, req: Requirements) -> Graph:
    """Pick the smallest (P_mxu, P_xla) meeting the throughput target."""
    g = g.clone()
    segs: dict[int, list] = {}
    for op in g:
        segs.setdefault(op.segment or 0, []).append(op)

    def model(p_mxu: int, p_xla: int):
        # segments serialize on one device, so throughput is
        # micro-batch / total time, and the total is the modelled
        # per-event decision latency the trigger budget constrains
        b = max(p_mxu, p_xla)  # pipeline micro-batch width
        total = 0.0
        for ops in segs.values():
            tgt = ops[0].target
            p = p_mxu if tgt == "mxu" else p_xla
            chunks = b // p
            total += chunks * segment_time(ops, req.n_hits, p, req.platform)
        return (b / total if total > 0 else float("inf")), total

    max_lat = req.max_latency_s or float("inf")
    pows = [2 ** i for i in range(int(math.log2(req.max_p)) + 1)]
    best = None
    fallback = None
    for p_mxu in pows:
        for p_xla in pows:
            if max(p_mxu, p_xla) % min(p_mxu, p_xla) != 0:
                continue
            tp, lat = model(p_mxu, p_xla)
            if lat <= max_lat and (fallback is None or tp > fallback[3]):
                fallback = (p_mxu + p_xla, p_mxu, p_xla, tp, lat)
            if tp >= req.target_throughput and lat <= max_lat:
                cost = p_mxu + p_xla  # resource proxy (paper: minimize P)
                if best is None or cost < best[0]:
                    best = (cost, p_mxu, p_xla, tp, lat)
    if best is None:
        # target unreachable within the latency budget: best-throughput
        # latency-feasible point (or P=1 if even that busts the budget)
        best = fallback or (2, 1, 1) + model(1, 1)
    _, p_mxu, p_xla, tp, lat = best
    for op in g:
        op.attrs_opt["P"] = p_mxu if op.target == "mxu" else p_xla
    g.meta["parallelization"] = {
        "P_mxu": p_mxu, "P_xla": p_xla, "microbatch": max(p_mxu, p_xla),
        "model_throughput_ev_s": tp, "model_latency_s": lat,
        "target": req.target_throughput, "max_latency_s": max_lat,
    }
    return g
