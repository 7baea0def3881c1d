"""Hopper kernel: masked edge aggregation (segment sum / mean), f32.

Counterpart of ``repro/kernels/edge_aggregate.py``
(``edge_aggregate_batched_pallas``; the per-graph
``edge_aggregate_pallas`` is the same kernel at B = 1). The CUDA source
is ``csrc/edge_aggregate.cu``, a counting sort by destination and a
segment walk in shared memory; the plain version is
``kernels/ref.py:edge_aggregate_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: destination rows per CTA: 8 CTAs per event at the routes' 64 nodes
BM = 8
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("edge_aggregate")
        lib.edge_aggregate_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.edge_aggregate_smem_bytes.restype = ctypes.c_longlong
        fn = lib.edge_aggregate_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def edge_aggregate_cuda(messages, dst, mask, *, n_nodes, reduce="sum"):
    """Masked segment sum (or mean) of edge messages into their
    destination nodes on the card, for a micro-batch of graphs.
    messages:(B,E,d) f32, dst:(B,E) int32, mask:(B,E) f32 ->
    (B, n_nodes, d): per node, ``mask[e]·msg[e]`` summed over its edges
    in increasing e (``mean`` divides by the masked in-degree, at least
    1); a dst outside [0, n_nodes) contributes nothing. Raises on an
    edge count whose shared-memory plan exceeds the card's 227 KB. Adds
    one to ``edge_aggregate_cuda.launches`` per launch."""
    if reduce not in ("sum", "mean"):
        raise ValueError(f"edge_aggregate_cuda: reduce={reduce!r}")
    if messages.ndim != 3 or dst.shape != messages.shape[:2] \
            or mask.shape != dst.shape:
        raise ValueError(f"edge_aggregate_cuda: messages "
                         f"{tuple(messages.shape)}, dst {tuple(dst.shape)}, "
                         f"mask {tuple(mask.shape)} are not (B, E, d), "
                         "(B, E), (B, E)")
    bsz, e, d = messages.shape
    _build.check_cuda("edge_aggregate_cuda", [messages, dst, mask],
                      [torch.float32, torch.int32, torch.float32])
    lib = _library()
    _build.check_smem("edge_aggregate_cuda",
                      lib.edge_aggregate_smem_bytes(e, BM), f"E={e}")
    out = torch.empty((bsz, n_nodes, d), dtype=torch.float32,
                      device=messages.device)
    with torch.cuda.device(messages.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.edge_aggregate_f32(messages.data_ptr(), dst.data_ptr(),
                                      mask.data_ptr(), out.data_ptr(), bsz,
                                      e, int(n_nodes), d, BM,
                                      int(reduce == "mean"), stream)
    _build.check(code, "edge_aggregate")
    edge_aggregate_cuda.launches += 1
    return out


edge_aggregate_cuda.launches = 0
