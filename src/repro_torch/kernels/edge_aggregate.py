"""Hopper kernel: masked edge aggregation (segment sum / mean), f32 (or
bf16 messages, widened by the kernel; the output f32 or bf16).

Counterpart of ``repro/kernels/edge_aggregate.py``
(``edge_aggregate_batched_pallas``; the per-graph
``edge_aggregate_pallas`` is the same kernel at B = 1). The CUDA source
is ``csrc/edge_aggregate.cu``: each CTA stages its column slice of the
messages with the event's destinations and masks in one round trip,
counting-sorts the edges by destination with all its warps, and walks
each row's segment in shared memory; the plain version is
``kernels/ref.py:edge_aggregate_ref``. :func:`plan` picks the CTA's
rows and columns, or takes the caller's (``bm``, ``bn``, the tuner's
knobs). An edge list longer than one launch takes
(:func:`max_edges`) is walked in chunks of consecutive edges
(:func:`chunk_plan`), each launch continuing the f32 sums and counts the
one before left in a scratch buffer; the last launch alone writes the
output, dividing a mean and rounding to bf16 once.
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


def plan(n_nodes: int, d: int, bsz: int = 1, bm=None,
         bn=None) -> tuple[int, int]:
    """(bm, cw): the destination rows and message columns of one CTA,
    which runs one (column block, row block, event): the smallest tile
    of :data:`TILES` (cut to n_nodes and d) whose CTAs fill the card at
    most once, else the largest. Measured on the H100 at the routes'
    shapes, a CTA's time is one chain of round trip, sort and walk that
    a smaller tile hardly shortens, while CTAs past one per SM queue.
    cw is even where d is (the walk reads column pairs). A given ``bm``
    (1 to :data:`BM` rows) or ``bn`` (the columns cw, even where d is)
    replaces the plan's; ``ValueError`` on any other."""
    for pbm, pcw in TILES:
        pbm, pcw = min(pbm, n_nodes), min(pcw, d)
        if -(-d // pcw) * -(-n_nodes // pbm) * bsz <= FILL_CTAS:
            break
    if bm is not None:
        pbm = _build.check_rows("edge_aggregate", bm, "edge", BM)
    if bn is not None:
        if isinstance(bn, bool) or int(bn) != bn or bn < 1 or (
                d % 2 == 0 and bn % 2):
            raise ValueError(f"edge_aggregate: bn={bn!r} columns a CTA; "
                             "the walk takes at least 1, an even number "
                             f"where d ({d}) is even")
        pcw = int(bn)
    return pbm, pcw


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


def chunk_plan(e: int, step: int | None = None
               ) -> list[tuple[int, int, bool, bool]]:
    """(first edge, edges, carry, last) of each launch over e edges in
    chunks of ``step`` (:func:`max_edges`): one launch of all of them
    (e = 0 included, which writes zeros) where they fit, else one a
    chunk in order, each after the first carrying the sums (and counts)
    the one before left, the last writing the output."""
    step = step or max_edges()
    starts = range(0, max(e, 1), step)
    return [(e0, min(step, e - e0), i > 0, i == len(starts) - 1)
            for i, e0 in enumerate(starts)]


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("edge_aggregate")
        lib.edge_aggregate_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.edge_aggregate_smem_bytes.restype = ctypes.c_longlong
        fn = lib.edge_aggregate_ex
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 13 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def library_smem_bytes(e: int, cw: int, staged_: bool) -> int:
    """The built library's own answer for :func:`smem_bytes`."""
    return int(_library().edge_aggregate_smem_bytes(e, cw, int(staged_)))


def edge_aggregate_cuda(messages, dst, mask, *, n_nodes, reduce="sum",
                        out_dtype=None, bm=None, bn=None):
    """Masked segment sum (or mean) of edge messages into their
    destination nodes on the card, for a micro-batch of graphs.
    messages:(B,E,d) float32 or bfloat16, dst:(B,E) int32, mask:(B,E) f32
    -> (B, n_nodes, d) of ``out_dtype`` (None: the messages' dtype): per
    node, ``mask[e]·msg[e]`` summed in f32 over its edges in increasing e
    (``mean`` divides by the masked in-degree, at least 1), rounded once;
    a dst outside [0, n_nodes) contributes nothing. E past
    :func:`max_edges` takes one launch a chunk (:func:`chunk_plan`; the
    sums and counts carried in f32, the output written by the last).
    ``bm`` rows and ``bn`` columns a CTA, or :func:`plan`'s where None,
    kept in ``edge_aggregate_cuda.last_plan``. Adds one to
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
                      [messages.dtype, torch.int32, torch.float32])
    in_code, out_code, out_dtype = _build.io_dtypes(
        "edge_aggregate_cuda", [messages], out_dtype)
    bsz, e, d = messages.shape
    n_nodes = int(n_nodes)
    mean = reduce == "mean"
    lib = _library()
    bm, cw = plan(n_nodes, d, bsz, bm, bn)
    chunks = chunk_plan(e)
    dev = messages.device
    out = torch.empty((bsz, n_nodes, d), dtype=out_dtype, device=dev)
    part = cnt = None
    if len(chunks) > 1:
        # the sums between chunks, in f32; for mean the counts, two
        # buffers that the chunks take in turns (a launch reads one and
        # writes the other)
        part = torch.empty((bsz, n_nodes, d), dtype=torch.float32,
                           device=dev)
        if mean:
            cnt = torch.empty((2, bsz, n_nodes), dtype=torch.float32,
                              device=dev)
    esz = messages.element_size()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for i, (e0, ec, carry, last) in enumerate(chunks):
            stage = staged(ec, cw)
            _build.check_smem("edge_aggregate_cuda",
                              smem_bytes(ec, cw, stage), f"E={ec}")
            # the first of several chunks runs as a last launch into the
            # f32 scratch, undivided (csrc/edge_aggregate.cu: walk)
            first = part is not None and not carry
            code = lib.edge_aggregate_ex(
                messages.data_ptr() + esz * e0 * d, dst.data_ptr() + 4 * e0,
                mask.data_ptr() + 4 * e0,
                (part if first else out).data_ptr(),
                None if part is None or first else part.data_ptr(),
                cnt[(i - 1) % 2].data_ptr() if cnt is not None and carry
                else None,
                cnt[i % 2].data_ptr() if cnt is not None and not last
                else None,
                bsz, ec, e, n_nodes, d, bm, cw, int(stage),
                int(mean and not first), int(carry), int(last or first),
                in_code, 0 if first else out_code, stream)
            _build.check(code, "edge_aggregate")
            edge_aggregate_cuda.launches += 1
    edge_aggregate_cuda.last_plan = {"bm": bm, "bn": cw}
    return out


edge_aggregate_cuda.launches = 0
edge_aggregate_cuda.last_plan = None
