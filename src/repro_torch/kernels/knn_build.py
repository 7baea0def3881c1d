"""Hopper kernels: the ragged path's kNN pair, f32 (or bf16 s and f,
widened by the kernels; the aggregation's output f32 or bf16).

Counterpart of ``repro/kernels/knn_build.py``
(``knn_build_batched_pallas`` and ``knn_aggregate_batched_pallas``; the
per-bin ``knn_build_pallas`` and ``knn_aggregate_pallas`` are the same
kernels at B = 1). The CUDA sources are ``csrc/knn_build.cu`` (the
segment-masked selection, the selection half of the register cell in
``csrc/gravnet_cell_reg.cuh``) and ``csrc/knn_aggregate.cu`` (the
Gaussian-potential mean/max over the selected rows, its accumulation
half); past the register cell's limits both run their first designs on
the shared-memory cell of ``csrc/gravnet_cell.cuh``. The plain versions
are ``kernels/ref.py:knn_build_ref`` and ``knn_aggregate_ref``.
:func:`build_plan` and :func:`aggregate_plan` pick each launch's rows
per CTA and its cell, or take the caller's rows (``bm``, the tuner's
knob) on the cell the shape runs.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gravnet import rows_on
from repro_torch.kernels.gravnet_block import MAX_DF, MAX_HITS

_lib_build = None
_lib_agg = None


def _round4(v: int) -> int:
    return (v + 3) & ~3


def build_plan(n: int, bsz: int = 1, bm=None) -> tuple[int, str]:
    """(bm, cell) of a ``knn_build`` launch over bsz bins of n rows: on
    the register cell (n <= 512: 16 candidates a lane) the rows of
    ``gravnet.fill_rows``, one warp a row (8 rows, 128 CTAs at the
    ragged path's 8 bins of 128); past it the first design's 32 rows on
    the shared-memory cell. A given ``bm`` is taken on the same cell (1
    to 16 rows on the register cell), else ``ValueError``."""
    return rows_on("knn_build", n, bsz,
                 "shared" if n > MAX_HITS else "register", bm)


def aggregate_plan(n: int, bsz: int = 1, df: int = 1,
                   bm=None) -> tuple[int, str]:
    """(bm, cell) of a ``knn_aggregate`` launch over bsz bins of n rows
    and d_f columns: on the register path (d_f <= 128: 4 columns a lane;
    any n, since nothing is staged) the rows of ``gravnet.fill_rows``;
    past it the first design's 32 rows on the shared-memory cell. A
    given ``bm`` is taken on the same path (1 to 16 rows on the
    register path), else ``ValueError``."""
    return rows_on("knn_aggregate", n, bsz,
                 "shared" if df > MAX_DF else "register", bm)


def build_smem_bytes(n: int, ds: int) -> int:
    """Shared memory of one ``knn_build`` CTA (the formula of the
    source's ``knn_build_smem_bytes``) on :func:`build_plan`'s cell.
    Register cell: S and the segment ids, each 16-byte aligned;
    shared-memory cell: S, |s|², the segment ids and 8 warps' distance
    rows."""
    if n <= MAX_HITS:
        return 4 * (_round4(n * ds) + _round4(n))
    return 4 * (n * (ds + 2) + 8 * n)


def aggregate_smem_bytes(n: int, df: int) -> int:
    """Shared memory of one ``knn_aggregate`` CTA (the formula of the
    source's ``knn_aggregate_smem_bytes``) on :func:`aggregate_plan`'s
    cell: none on the register path (the selected rows are read from
    device memory); the first design's F, a row of zeros and 8 warps'
    output rows past it."""
    if df <= MAX_DF:
        return 0
    return 4 * ((n + 1) * df + 8 * 2 * df)


def _library_build():
    global _lib_build
    if _lib_build is None:
        lib = _build.load("knn_build")
        lib.knn_build_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.knn_build_smem_bytes.restype = ctypes.c_longlong
        fn = lib.knn_build_ex
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib_build = lib
    return _lib_build


def _library_agg():
    global _lib_agg
    if _lib_agg is None:
        lib = _build.load("knn_aggregate")
        lib.knn_aggregate_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.knn_aggregate_smem_bytes.restype = ctypes.c_longlong
        fn = lib.knn_aggregate_ex
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.c_float] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib_agg = lib
    return _lib_agg


def library_build_smem_bytes(n: int, ds: int) -> int:
    """The built library's own answer for :func:`build_smem_bytes`."""
    return int(_library_build().knn_build_smem_bytes(n, ds))


def library_aggregate_smem_bytes(n: int, df: int) -> int:
    """The built library's own answer for :func:`aggregate_smem_bytes`."""
    return int(_library_agg().knn_aggregate_smem_bytes(n, df))


def knn_build_cuda(s, segids, *, k=8, bm=None):
    """Segment-masked kNN selection on the card for a micro-batch of
    bins. s:(B,N,ds) float32 or bfloat16 (the distances computed in f32
    on its exact f32 values), segids:(B,N) int (−1 on padding) ->
    (idx:(B,N,k) int32, d2:(B,N,k) f32): per row, the k nearest rows of
    its own event, ties to the lowest column; a slot with no candidate
    left is (0, 1e30). ``bm`` rows a CTA, or :func:`build_plan`'s where
    None, kept in ``knn_build_cuda.last_plan``. Adds one to
    ``knn_build_cuda.launches`` per launch."""
    if s.ndim != 3 or segids.shape != s.shape[:2]:
        raise ValueError(f"knn_build_cuda: s {tuple(s.shape)}, segids "
                         f"{tuple(segids.shape)} are not (B, N, ds), "
                         "(B, N)")
    if k < 1:
        raise ValueError(f"knn_build_cuda: k={k}")
    bsz, n, ds = s.shape
    segids = segids.to(torch.int32).contiguous()
    _build.check_cuda("knn_build_cuda", [s, segids], [s.dtype, torch.int32])
    in_code, _, _ = _build.io_dtypes("knn_build_cuda", [s])
    lib = _library_build()
    bm, _ = build_plan(n, bsz, bm)
    _build.check_smem("knn_build_cuda", build_smem_bytes(n, ds),
                      f"n={n}, d_s={ds}")
    idx = torch.empty((bsz, n, k), dtype=torch.int32, device=s.device)
    d2 = torch.empty((bsz, n, k), dtype=torch.float32, device=s.device)
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.knn_build_ex(s.data_ptr(), segids.data_ptr(),
                                idx.data_ptr(), d2.data_ptr(), bsz, n, ds,
                                int(k), bm, in_code, stream)
    _build.check(code, "knn_build")
    knn_build_cuda.last_plan = {"bm": bm}
    knn_build_cuda.launches += 1
    return idx, d2


knn_build_cuda.launches = 0
knn_build_cuda.last_plan = None


def knn_aggregate_cuda(f, idx, d2, *, scale=10.0, out_dtype=None, bm=None):
    """Gaussian-potential mean/max over prebuilt neighbours on the card.
    f:(B,N,df) float32 or bfloat16, idx:(B,N,k) int32 (from knn_build;
    an index outside [0, N) selects a row of zeros, as the TPU kernel's
    one-hot product does), d2:(B,N,k) f32 -> (B,N,2·df) of ``out_dtype``
    (None: f's dtype), computed in f32; ``bm`` rows a CTA, or
    :func:`aggregate_plan`'s where None, kept in
    ``knn_aggregate_cuda.last_plan``. Adds one to
    ``knn_aggregate_cuda.launches`` per launch."""
    if f.ndim != 3 or idx.ndim != 3 or idx.shape[:2] != f.shape[:2] \
            or d2.shape != idx.shape:
        raise ValueError(f"knn_aggregate_cuda: f {tuple(f.shape)}, idx "
                         f"{tuple(idx.shape)}, d2 {tuple(d2.shape)}")
    bsz, n, df = f.shape
    k = idx.shape[2]
    if k < 1:
        raise ValueError("knn_aggregate_cuda: no neighbour slot")
    _build.check_cuda("knn_aggregate_cuda", [f, idx, d2],
                      [f.dtype, torch.int32, torch.float32])
    in_code, out_code, out_dtype = _build.io_dtypes("knn_aggregate_cuda",
                                                    [f], out_dtype)
    lib = _library_agg()
    bm, _ = aggregate_plan(n, bsz, df, bm)
    _build.check_smem("knn_aggregate_cuda", aggregate_smem_bytes(n, df),
                      f"n={n}, d_f={df}")
    y = torch.empty((bsz, n, 2 * df), dtype=out_dtype, device=f.device)
    with torch.cuda.device(f.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.knn_aggregate_ex(f.data_ptr(), idx.data_ptr(),
                                    d2.data_ptr(), y.data_ptr(), bsz, n,
                                    df, k, float(scale), bm, in_code,
                                    out_code, stream)
    _build.check(code, "knn_aggregate")
    knn_aggregate_cuda.last_plan = {"bm": bm}
    knn_aggregate_cuda.launches += 1
    return y


knn_aggregate_cuda.launches = 0
knn_aggregate_cuda.last_plan = None
