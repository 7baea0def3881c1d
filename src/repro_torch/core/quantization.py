"""The paper's precision policy and the int8 quantizers of the deployment
flow.

Counterpart of ``repro/core/quantization.py``:

- ``quantize_weight``       : per-output-channel int8 weights + f32 scales.
- ``activation_scale``      : the per-tensor activation scale of a
                              calibrated max-abs (a Python float).
- ``apply_precision_policy``: the paper's mixed policy — first/last
                              pipeline segments bf16, interior int8.

``fake_quant`` (quantization-aware training) comes with the training
slice.
"""
from __future__ import annotations

import numpy as np
import torch

QMAX = 127.0


def f32(v: float) -> float:
    """``v`` rounded to the nearest float32, as a Python float. A scale
    is kept in double (as the reference keeps it) and becomes float32
    only where it is used: a float32 tensor divided or multiplied by an
    f32-exact Python float gives the float32 result whether PyTorch
    computes in float or in double."""
    return float(np.float32(v))


def quantize_weight(w: torch.Tensor, *, bits: int = 8):
    """Per-output-channel symmetric int8 quantization. w: (d_in, d_out)
    f32 -> (w_q int8 (d_in, d_out), scale f32 (d_out,)); rounds half to
    even and clips to ±(2^(bits-1) - 1)."""
    qmax = 2.0 ** (bits - 1) - 1.0
    w = w.float()
    scale = torch.clamp_min(w.abs().amax(dim=0), f32(1e-8)) / qmax
    w_q = torch.clamp(torch.round(w / scale[None, :]), -qmax, qmax)
    return w_q.to(torch.int8), scale


def activation_scale(absmax: float, *, bits: int = 8) -> float:
    """``max(absmax, 1e-8) / (2^(bits-1) - 1)`` in double."""
    qmax = 2.0 ** (bits - 1) - 1.0
    return max(float(absmax), 1e-8) / qmax


def div_f32(v: torch.Tensor, s: float) -> torch.Tensor:
    """``v / f32(s)`` rounded as the IEEE float32 division, on every
    device. PyTorch's CUDA kernels divide by a Python scalar as a product
    with its float reciprocal, which misses the quotient's last bit on
    some inputs; a divisor tensor on v's device keeps the division."""
    return v / torch.full((), f32(s), dtype=torch.float32, device=v.device)


def quantize_act(v: torch.Tensor, scale: float) -> torch.Tensor:
    """f32 activations -> int8 on the grid of ``scale``: ``v / scale``
    (a division, as the reference quantizes), rounded half to even,
    clipped to ±127."""
    q = torch.clamp(torch.round(div_f32(v.float(), scale)), -QMAX, QMAX)
    return q.to(torch.int8)


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
