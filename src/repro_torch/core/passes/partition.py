"""Partitioning pass (paper §III-A "Partitioning").

Counterpart of ``repro/core/passes/partition.py``: every operator whose
registry spec declares a regular access pattern goes to ``target='mxu'``,
the rest (the GravNet selection, CPS, input/output) to ``target='xla'``;
consecutive same-target ops form the pipeline's segments. The target
names are the reference's: they label the two sides of the paper's
split, and on the card both sides run CUDA.
"""
from __future__ import annotations

from repro_torch.core.graph_ir import Graph
from repro_torch.core.op_registry import is_regular


def partition(g: Graph, *, tpu_native_gravnet: bool = False) -> Graph:
    g = g.clone()
    for op in g:
        op.target = ("mxu" if is_regular(
            op, tpu_native_gravnet=tpu_native_gravnet) else "xla")
    # segmentation: consecutive same-target ops share a segment id
    seg = -1
    prev = None
    for op in g:
        if op.target != prev:
            seg += 1
            prev = op.target
        op.segment = seg
    return g


def segments(g: Graph) -> list[dict]:
    """Segment table: [{'id', 'target', 'ops': [names]}] in pipeline order."""
    table: list[dict] = []
    for op in g:
        if not table or table[-1]["id"] != op.segment:
            table.append({"id": op.segment, "target": op.target, "ops": []})
        table[-1]["ops"].append(op.name)
    return table
