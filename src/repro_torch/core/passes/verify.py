"""Graph-verification pass: shape/feature-dim inference over the IR.

Counterpart of ``repro/core/passes/verify.py``: walks the graph in topo
order, infers each operator's output feature dim through the registry's
``infer`` hooks, and raises on any inconsistency.
"""
from __future__ import annotations

from repro_torch.core.graph_ir import Graph
from repro_torch.core.op_registry import (GraphVerificationError,
                                          UnknownOperatorError,
                                          require_spec)


def verify(g: Graph) -> dict:
    """Returns {op_name: inferred_out_dim}; raises on malformed graphs."""
    dims: dict[str, int] = {}
    for op in g:
        for i in op.inputs:
            if i not in dims:
                raise GraphVerificationError(
                    f"{op.name}: input {i!r} not yet defined (topo order)")
        spec = require_spec(op)  # unknown op types raise here
        if spec.infer is None:
            raise UnknownOperatorError(
                f"{op.name}: op {op.op_type!r} is registered without a "
                "shape-inference hook")
        dims[op.name] = spec.infer(op, dims, g)
        if op.out_dim is not None and dims[op.name] != op.out_dim \
                and op.op_type not in ("output",):
            raise GraphVerificationError(
                f"{op.name}: declared out_dim {op.out_dim} != inferred "
                f"{dims[op.name]}")
    if not g.outputs():
        raise GraphVerificationError("graph has no output operator")
    return dims
