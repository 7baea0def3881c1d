"""Hopper kernel: the standalone GravNet kNN aggregation, f32 (or bf16
s and f, widened by the kernel; the output f32 or bf16).

Counterpart of ``repro/kernels/gravnet.py``
(``gravnet_aggregate_batched_pallas``; ``gravnet_aggregate_pallas`` is
the same kernel at B = 1). The CUDA source is
``csrc/gravnet_aggregate.cu``, which includes the register-resident cell
``csrc/gravnet_cell_reg.cuh`` that the fused blocks share (and, past its
limits, the shared-memory cell ``csrc/gravnet_cell.cuh``); the plain
version is ``kernels/ref.py:gravnet_aggregate_ref``. It runs where the
GravNet block stays unfused. :func:`plan` picks the rows per CTA and
the cell, or takes the caller's rows (``bm``, the tuner's knob) on the
cell the shape runs.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gravnet_block import BM_SHARED, MAX_DF, MAX_HITS

#: query rows per CTA on the register cell, one per warp, smallest first
ROWS = (4, 8, 16)
#: the most rows a register-cell CTA takes (``csrc/*.cu:kMaxRows``)
MAX_ROWS = ROWS[-1]
#: CTAs that fill the card: one per SM of the H100
FILL_CTAS = 132
_lib = None


def fill_rows(n: int, bsz: int) -> int:
    """Query rows per CTA of a one-warp-a-row kernel over bsz events of
    n rows: the fewest of :data:`ROWS` whose CTAs fill the card at most
    once, else the most (at most n)."""
    for bm in ROWS:
        bm = min(bm, n)
        if -(-n // bm) * bsz <= FILL_CTAS:
            break
    return bm


def plan(n: int, bsz: int = 1, df: int = 1, bm=None) -> tuple[int, str]:
    """(bm, cell) of a launch over bsz events of n hits: on the register
    cell (n <= 512, d_f <= 128) the rows of :func:`fill_rows`. A CTA
    repeats only the staging of its event, so smaller CTAs cost nothing
    but launches past one per SM: 32 CTAs at one event of 128 hits, 8 at
    one of 32. Past the register cell, the first design's 32 rows on the
    shared-memory cell. A given ``bm`` is taken on the same cell: 1 to
    16 rows (``kMaxRows``) on the register cell, any on the other; else
    ``ValueError``."""
    return rows_on("gravnet_aggregate", n, bsz,
                   "shared" if n > MAX_HITS or df > MAX_DF else "register",
                   bm)


def rows_on(name: str, n: int, bsz: int, cell: str,
            bm=None) -> tuple[int, str]:
    """(bm, cell) of a one-warp-a-row launch of ``name`` on ``cell``: a
    given bm checked against the cell (``_build.check_rows``: at most
    :data:`MAX_ROWS` on the register cell), else :func:`fill_rows` on the
    register cell and the first design's 32 rows on the shared one."""
    if bm is not None:
        return _build.check_rows(name, bm, cell, MAX_ROWS
                                 if cell == "register" else None), cell
    if cell == "shared":
        return min(n, BM_SHARED), cell
    return fill_rows(n, bsz), cell


def _round4(v: int) -> int:
    return (v + 3) & ~3


def smem_bytes(n: int, ds: int, df: int) -> int:
    """Shared memory of one CTA (the formula of the source's
    ``gravnet_aggregate_smem_bytes``) on :func:`plan`'s cell. Register
    cell: S, F and the mask, each 16-byte aligned; shared-memory cell: S,
    F, |s|², the mask, and 8 warps' output and distance rows."""
    if n <= MAX_HITS and df <= MAX_DF:
        return 4 * (_round4(n * ds) + _round4(n * df) + _round4(n))
    return 4 * (n * (ds + df + 2) + 8 * 2 * df + 8 * n)


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("gravnet_aggregate")
        lib.gravnet_aggregate_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.gravnet_aggregate_smem_bytes.restype = ctypes.c_longlong
        fn = lib.gravnet_aggregate_ex
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_float] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def library_smem_bytes(n: int, ds: int, df: int) -> int:
    """The built library's own answer for :func:`smem_bytes`."""
    return int(_library().gravnet_aggregate_smem_bytes(n, ds, df))


def gravnet_aggregate_cuda(s, f, mask, *, k=8, scale=10.0, out_dtype=None,
                           bm=None):
    """GravNet aggregation on the card for a micro-batch.
    s:(B,N,ds), f:(B,N,df) both float32 or both bfloat16, mask:(B,N) f32
    -> (B,N,2·df) of ``out_dtype`` (None: f's dtype) = concat(mean, max)
    over each row's k nearest valid rows of its own event; ``bm`` rows a
    CTA, or :func:`plan`'s where None, kept in
    ``gravnet_aggregate_cuda.last_plan``. Raises on a
    shape whose shared-memory plan (:func:`plan`, :func:`smem_bytes`)
    exceeds the card's 227 KB. Adds one to
    ``gravnet_aggregate_cuda.launches`` per launch."""
    if s.ndim != 3 or f.ndim != 3:
        raise ValueError(f"gravnet_aggregate_cuda: s {tuple(s.shape)}, f "
                         f"{tuple(f.shape)} are not (B, N, d)")
    bsz, n, ds = s.shape
    df = f.shape[2]
    if f.shape[:2] != s.shape[:2] or tuple(mask.shape) != (bsz, n):
        raise ValueError(f"gravnet_aggregate_cuda: s {tuple(s.shape)}, f "
                         f"{tuple(f.shape)}, mask {tuple(mask.shape)}")
    mask = mask.to(torch.float32).contiguous()
    ops = [s, f, mask]
    if any(not t.is_cuda or t.device != s.device for t in ops):
        raise ValueError("gravnet_aggregate_cuda takes CUDA tensors on one "
                         "device")
    in_code, out_code, out_dtype = _build.io_dtypes(
        "gravnet_aggregate_cuda", [s, f], out_dtype)
    if any(not t.is_contiguous() for t in ops):
        raise ValueError("gravnet_aggregate_cuda takes contiguous operands")
    lib = _library()
    bm, _ = plan(n, bsz, df, bm)
    smem = smem_bytes(n, ds, df)
    if smem > _build.SMEM_LIMIT:
        raise ValueError(f"gravnet_aggregate_cuda: n={n}, d_s={ds}, "
                         f"d_f={df} needs {smem} B of shared memory > "
                         f"{_build.SMEM_LIMIT} B")
    y = torch.empty((bsz, n, 2 * df), dtype=out_dtype, device=s.device)
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.gravnet_aggregate_ex(
            s.data_ptr(), f.data_ptr(), mask.data_ptr(), y.data_ptr(), bsz,
            n, ds, df, int(k), float(scale), bm, in_code, out_code, stream)
    _build.check(code, "gravnet_aggregate")
    gravnet_aggregate_cuda.last_plan = {"bm": bm}
    gravnet_aggregate_cuda.launches += 1
    return y


gravnet_aggregate_cuda.launches = 0
gravnet_aggregate_cuda.last_plan = None
