"""Kernel-level optimization pass (paper §III-A "Kernel-Level
Optimizations").

Counterpart of ``repro/core/passes/kernel_opt.py``, two of its steps:

1. **Kernel binding** through the registry (``op_registry.bind_kernels``):
   a small MXU dense binds the 'flattened' variant, a large one the
   'looped' variant with (bm, bn, bk) blocks. On the card one
   ``fused_dense`` kernel serves both variants, so the binding changes
   the graph (and the reference's graph equality holds) but not the
   launch; it is kept for when the variants differ on the card.
2. **Retile cancellation**: adjacent retiles that undo each other are
   bypassed.

The reference's int8 chain fusion waits for the mixed-precision slice,
and its whole-pipeline ``jax.jit`` has no counterpart here: the port
runs the segments eagerly (CUDA graphs are later work).
"""
from __future__ import annotations

from repro_torch.core.graph_ir import Graph
from repro_torch.core.op_registry import BindContext, bind_kernels

FLATTEN_ROWS = 512        # rows (hits × microbatch) below which we flatten
FLATTEN_DIM = 1024        # max feature dim for the flattened variant


def _pick_block(v: int, cap: int) -> int:
    p = 1
    while p * 2 <= min(v, cap):
        p *= 2
    return p


def fused_dense_shape(op, n_rows: int, batch: int = 1) -> tuple[int, int, int]:
    """(rows, d_in, d_out) of the product this op launches per step:
    rows scale with the segment's P (or the packed batch when > 1)."""
    d_in = op.params["w"].shape[0]
    d_out = op.out_dim or op.params["w"].shape[1]
    if batch > 1:
        rows = n_rows * batch
    else:
        rows = n_rows * op.attrs_opt.get("P", 1)
    return rows, d_in, d_out


def kernel_optimize(g: Graph, *, n_rows: int = 128, batch: int = 1) -> Graph:
    g = g.clone()

    # 1. per-op kernel binding, dispatched through the registry
    ctx = BindContext(n_rows=n_rows, batch=batch)
    for op in g:
        bind_kernels(op, ctx)

    # 2. retile cancellation: retile(B->A) after retile(A->B) bypasses both
    changed = True
    while changed:
        changed = False
        for op in list(g):
            if op.op_type != "retile":
                continue
            src = g[op.inputs[0]]
            if (src.op_type == "retile"
                    and src.attrs["from"] == op.attrs["to"]
                    and src.attrs["to"] == op.attrs["from"]):
                g.rewire(op.name, src.inputs[0])
                if not g.successors(op.name):
                    g.remove(op.name)
                if not g.successors(src.name):
                    g.remove(src.name)
                changed = True
                break
    return g
