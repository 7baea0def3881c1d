"""The paper's precision policy for the deployment flow.

Counterpart of ``repro/core/quantization.py:apply_precision_policy``,
both branches, so that the port's graphs carry the reference's
precisions. Weight and activation quantization (``quantize_weight``,
``activation_scale``) come with the mixed-precision slice; until then
``deploy`` refuses the mixed policy.
"""
from __future__ import annotations


def apply_precision_policy(g, *, policy: str = "mixed"):
    """Set per-op precision from the paper's policy.

    'fp'    — everything float (the numerics reference).
    'mixed' — boundary segments (first and last, the paper's A and G)
              run bf16; all interior segments run int8.
    """
    g = g.clone()
    if policy == "fp":
        for op in g:
            op.precision = "fp"
        return g
    if policy != "mixed":
        raise ValueError(f"unknown precision policy {policy!r}")
    seg_ids = sorted({op.segment for op in g})
    first, last = seg_ids[0], seg_ids[-1]
    for op in g:
        if op.segment in (first, last):
            op.precision = "bf16"
        else:
            op.precision = "int8"
        # io/cps ops keep fp interface semantics regardless
        if op.op_type in ("input", "output", "cps"):
            op.precision = "bf16"
    g.meta["precision_policy"] = policy
    return g
