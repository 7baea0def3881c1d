"""Public kernel entry points of the port.

Counterpart of ``repro/kernels/ops.py`` for the kernels this port has.
The device of the tensors decides the route, and nothing else does: a
CPU tensor goes to the plain PyTorch version (``kernels/ref.py``), a
CUDA tensor to the hand-written kernel, which raises on what it does
not take. There is no backend switch and no fallback. The kernels mask
ragged shapes themselves, so no wrapper pads.
"""
from __future__ import annotations

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.fused_dense import fused_dense_cuda
from repro_torch.kernels.gravnet_block import gravnet_block_cuda


def fused_dense(x, w, b=None, *, activation="relu"):
    """act(x @ w + b). x:(M,K) w:(K,N) b:(N,)|None -> (M,N)."""
    if x.device.type == "cpu":
        return _ref.fused_dense_ref(x, w, b, activation=activation)
    return fused_dense_cuda(x, w, b, activation=activation)


def fused_dense_batched(x, w, b=None, *, activation="relu"):
    """act(x @ w + b) over a micro-batch x:(B,M,K) in one launch: the
    events are row-packed into one (B·M, K) product (a dense couples no
    rows, so packing is exact)."""
    bsz, m, kdim = x.shape
    y = fused_dense(x.reshape(bsz * m, kdim), w, b, activation=activation)
    return y.reshape(bsz, m, -1)


def gravnet_block_batched(x, mask, ws, bs, wf, bf, wo, bo, *, k=8,
                          scale=10.0, activation="relu"):
    """One fused GravNet block over a micro-batch, one launch.
    x:(B,N,dh), mask:(B,N) -> (B,N,d_out) = act(concat(x, agg) @ wo + bo);
    neighbours are chosen within each event only."""
    if x.device.type == "cpu":
        return _ref.gravnet_block_ref(x, mask, ws, bs, wf, bf, wo, bo, k=k,
                                      scale=scale, activation=activation)
    return gravnet_block_cuda(x, mask, ws, bs, wf, bf, wo, bo, k=k,
                              scale=scale, activation=activation)


def gravnet_block(x, mask, ws, bs, wf, bf, wo, bo, *, k=8, scale=10.0,
                  activation="relu"):
    """One fused GravNet block for one event: the batched kernel at
    B = 1. x:(N,dh), mask:(N,) -> (N,d_out)."""
    return gravnet_block_batched(x[None], mask[None], ws, bs, wf, bf, wo,
                                 bo, k=k, scale=scale,
                                 activation=activation)[0]
