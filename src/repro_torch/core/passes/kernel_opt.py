"""Kernel-level optimization pass (paper §III-A "Kernel-Level
Optimizations").

Counterpart of ``repro/core/passes/kernel_opt.py``, its four steps:

1. **Kernel binding** through the registry (``op_registry.bind_kernels``):
   a small MXU dense binds the 'flattened' variant, a large one the
   'looped' variant with (bm, bn, bk) blocks. On the card one
   ``fused_dense`` kernel serves both variants, so this heuristic
   binding keeps the reference's graph but changes no launch. With a
   tuning cache (``repro_torch.tuning``), a cached winner for the exact
   (kernel, shape, dtype, backend) problem beats the heuristic, and the
   executor hands its knobs to the kernel: a dense's tile (bm, bn), only
   where the binding is ``tuned``, as in the reference; the GravNet and
   kNN kernels' rows a CTA (bm), the blocks' too; the edge kernel's
   (bm, bn) rows and columns; the attention op's (bq, bk). The
   reference's knobs with no counterpart on the card stay annotations
   that no launch reads: the dense's ``variant`` and ``bk``, the blocks'
   epilogue ``bn`` and ``bk``, the edge kernel's ``be``. On ``"cuda"``
   keys an entry that is not among its family's candidates at the shape
   (``tuning/candidates.py``; a cache written before these knobs) binds
   nothing, with a warning. A miss keeps the heuristic, so an empty
   cache binds exactly what no cache does.
2. **Retile cancellation**: adjacent retiles that undo each other are
   bypassed.
3. **Int8 chain fusion**: inside an 8-bit partition, a dense whose
   consumers all declare an 8-bit passthrough (``OpSpec.int8_passthrough``)
   emits int8 straight from its epilogue (``emit_int8``), requantized
   with its own calibrated scale, instead of f32.

4. **Whole-pipeline compile**: ``g.meta["fuse_pipeline"] = True``, as
   the reference sets it for its whole-graph ``jax.jit``. On ``cuda``
   the ``CompiledPipeline`` of such a graph captures each micro-batch
   chunk, every segment with its P-chunking, CPS and the output, as one
   CUDA graph and replays it per chunk; a graph without the flag
   (design points 1–2, which run no kernel-opt pass) is captured one
   CUDA graph per segment, the reference's per-segment ``jax.jit``. On
   the CPU both run eagerly (``core/pipeline.py``).
"""
from __future__ import annotations

from repro_torch.core.graph_ir import Graph
from repro_torch.core.op_registry import (BindContext, bind_kernels,
                                          require_spec)

FLATTEN_ROWS = 512        # rows (hits × microbatch) below which we flatten
FLATTEN_DIM = 1024        # max feature dim for the flattened variant

_FUSED_DENSE_KNOBS = ("variant", "bm", "bn", "bk")


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


def fused_dense_dtype(op) -> str:
    """The dtype the executor runs this dense in (its tuning key's)."""
    if op.precision == "int8":
        return "int8"
    if op.precision == "bf16":
        return "bf16"
    return "float32"


def emits_int8(g: Graph, op) -> bool:
    """Whether int8 chain fusion lets ``op`` emit int8: an int8 dense
    whose consumers are all int8 and declare an 8-bit passthrough."""
    if op.precision != "int8" or op.op_type != "dense":
        return False
    succ = g.successors(op.name)
    return bool(succ) and all(s.precision == "int8"
                              and require_spec(s).int8_passthrough
                              for s in succ)


def kernel_optimize(g: Graph, *, n_rows: int = 128, batch: int = 1,
                    tuning_cache=None, backend: str = "cuda") -> Graph:
    """``n_rows`` is the per-event graph size, ``batch`` the packed
    micro-batch width (1 = per-event shapes and keys); ``backend`` is
    the tuning keys' ('cuda' or 'cpu')."""
    g = g.clone()

    # 1. per-op kernel binding, dispatched through the registry (cached
    # winner > heuristic; a miss leaves the heuristic binding)
    ctx = BindContext(n_rows=n_rows, batch=batch, cache=tuning_cache,
                      backend=backend)
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

    # 3. int8 chain fusion: a dense may emit int8 straight into
    # consumers whose specs declare an 8-bit passthrough
    for op in g:
        if emits_int8(g, op):
            op.attrs_opt["emit_int8"] = True

    # 4. whole-pipeline compile: each chunk captured as one CUDA graph
    g.meta["fuse_pipeline"] = True
    return g
