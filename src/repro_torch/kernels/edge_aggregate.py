"""Hopper kernel: masked edge aggregation (segment sum / mean), f32.

Counterpart of ``repro/kernels/edge_aggregate.py``
(``edge_aggregate_batched_pallas``; the per-graph
``edge_aggregate_pallas`` is the same kernel at B = 1). The CUDA source
is ``csrc/edge_aggregate.cu``: each CTA stages its column slice of the
messages with the event's destinations and masks in one round trip,
counting-sorts the edges by destination with all its warps, and walks
each row's segment in shared memory; the plain version is
``kernels/ref.py:edge_aggregate_ref``. :func:`plan` picks the CTA's
rows and columns. An edge list longer than one launch takes
(:func:`max_edges`) is walked in chunks of consecutive edges, each
launch continuing the sums the one before left in the output.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: destination rows per CTA, at most (``csrc/edge_aggregate.cu:kMaxRows``)
BM = 64
#: warps of a CTA (``csrc/edge_aggregate.cu:kWarps``)
WARPS = 8
#: a CTA's (rows, message columns), smallest first (:func:`plan`)
TILES = ((16, 8), (32, 8), (64, 8), (64, 16), (64, 32))
#: CTAs that fill the card: one per SM of the H100
FILL_CTAS = 132
_lib = None


def plan(n_nodes: int, d: int, bsz: int = 1) -> tuple[int, int]:
    """(bm, cw): the destination rows and message columns of one CTA,
    which runs one (column block, row block, event): the smallest tile
    of :data:`TILES` (cut to n_nodes and d) whose CTAs fill the card at
    most once, else the largest. Measured on the H100 at the routes'
    shapes, a CTA's time is one chain of round trip, sort and walk that
    a smaller tile hardly shortens, while CTAs past one per SM queue.
    cw is even where d is (the walk reads column pairs)."""
    for bm, cw in TILES:
        bm, cw = min(bm, n_nodes), min(cw, d)
        if -(-d // cw) * -(-n_nodes // bm) * bsz <= FILL_CTAS:
            break
    return bm, cw


def smem_bytes(e: int, cw: int, staged: bool) -> int:
    """Shared memory of one CTA (the formula of the source's
    ``edge_aggregate_smem_bytes``): the count table (BM x WARPS + 4),
    the staged message slice (e x cw), and keys, masks, ranks and sorted
    edge ids (e each)."""
    return 4 * (BM * WARPS + 4 + (e * cw if staged else 0) + 4 * e)


def staged(e: int, cw: int) -> bool:
    """Whether a CTA stages its message slice: where the slice fits the
    card's shared memory beside the sort, else the walk reads the
    messages from device memory."""
    return smem_bytes(e, cw, True) <= _build.SMEM_LIMIT


def max_edges() -> int:
    """The largest edge count one launch takes (a longer list is walked
    in chunks of this many edges)."""
    return (_build.SMEM_LIMIT - smem_bytes(0, 1, False)) // 16


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("edge_aggregate")
        lib.edge_aggregate_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.edge_aggregate_smem_bytes.restype = ctypes.c_longlong
        fn = lib.edge_aggregate_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def library_smem_bytes(e: int, cw: int, staged_: bool) -> int:
    """The built library's own answer for :func:`smem_bytes`."""
    return int(_library().edge_aggregate_smem_bytes(e, cw, int(staged_)))


def edge_aggregate_cuda(messages, dst, mask, *, n_nodes, reduce="sum"):
    """Masked segment sum (or mean) of edge messages into their
    destination nodes on the card, for a micro-batch of graphs.
    messages:(B,E,d) f32, dst:(B,E) int32, mask:(B,E) f32 ->
    (B, n_nodes, d): per node, ``mask[e]·msg[e]`` summed over its edges
    in increasing e (``mean`` divides by the masked in-degree, at least
    1); a dst outside [0, n_nodes) contributes nothing. E past
    :func:`max_edges` takes one launch a chunk (``mean`` then sums the
    messages and the masks by chunks and divides once). Adds one to
    ``edge_aggregate_cuda.launches`` per launch."""
    if reduce not in ("sum", "mean"):
        raise ValueError(f"edge_aggregate_cuda: reduce={reduce!r}")
    if messages.ndim != 3 or dst.shape != messages.shape[:2] \
            or mask.shape != dst.shape:
        raise ValueError(f"edge_aggregate_cuda: messages "
                         f"{tuple(messages.shape)}, dst {tuple(dst.shape)}, "
                         f"mask {tuple(mask.shape)} are not (B, E, d), "
                         "(B, E), (B, E)")
    _build.check_cuda("edge_aggregate_cuda", [messages, dst, mask],
                      [torch.float32, torch.int32, torch.float32])
    n_nodes = int(n_nodes)
    if messages.shape[1] <= max_edges():
        return _launches(messages, dst, mask, n_nodes, reduce == "mean")
    out = _launches(messages, dst, mask, n_nodes, False)
    if reduce == "mean":
        ones = torch.ones(dst.shape + (1,), dtype=torch.float32,
                          device=messages.device)
        cnt = _launches(ones, dst, mask, n_nodes, False)
        out = out / torch.clamp_min(cnt, 1.0)
    return out


def _launches(messages, dst, mask, n_nodes, mean):
    """The kernel over the edges in chunks of at most :func:`max_edges`,
    in order, each launch after the first accumulating into the output
    (``mean`` only where one launch takes them all)."""
    bsz, e, d = messages.shape
    lib = _library()
    bm, cw = plan(n_nodes, d, bsz)
    step = max_edges()
    out = torch.empty((bsz, n_nodes, d), dtype=torch.float32,
                      device=messages.device)
    with torch.cuda.device(messages.device):
        stream = torch.cuda.current_stream().cuda_stream
        for e0 in range(0, max(e, 1), step):
            ec = min(step, e - e0)
            stage = staged(ec, cw)
            _build.check_smem("edge_aggregate_cuda",
                              smem_bytes(ec, cw, stage), f"E={ec}")
            code = lib.edge_aggregate_f32(
                messages.data_ptr() + 4 * e0 * d, dst.data_ptr() + 4 * e0,
                mask.data_ptr() + 4 * e0, out.data_ptr(), bsz, ec, e,
                n_nodes, d, bm, cw, int(stage), int(mean), int(e0 > 0),
                stream)
            _build.check(code, "edge_aggregate")
            edge_aggregate_cuda.launches += 1
    return out


edge_aggregate_cuda.launches = 0
