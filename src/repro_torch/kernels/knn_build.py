"""Hopper kernels: the ragged path's kNN pair, f32.

Counterpart of ``repro/kernels/knn_build.py``
(``knn_build_batched_pallas`` and ``knn_aggregate_batched_pallas``; the
per-bin ``knn_build_pallas`` and ``knn_aggregate_pallas`` are the same
kernels at B = 1). The CUDA sources are ``csrc/knn_build.cu`` (the
segment-masked selection) and ``csrc/knn_aggregate.cu`` (the
Gaussian-potential mean/max over the selected rows), both built from
the cell in ``csrc/gravnet_cell.cuh``; the plain versions are
``kernels/ref.py:knn_build_ref`` and ``knn_aggregate_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: query rows (bins' rows) per CTA of both kernels: 4 CTAs per bin of 128
#: rows, 8 warps of 4 rows each (``csrc/knn_build.cu``,
#: ``csrc/knn_aggregate.cu``)
BM = 32

_lib_build = None
_lib_agg = None


def _library_build():
    global _lib_build
    if _lib_build is None:
        lib = _build.load("knn_build")
        lib.knn_build_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.knn_build_smem_bytes.restype = ctypes.c_longlong
        fn = lib.knn_build_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
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
        fn = lib.knn_aggregate_f32
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib_agg = lib
    return _lib_agg


def knn_build_cuda(s, segids, *, k=8):
    """Segment-masked kNN selection on the card for a micro-batch of
    bins. s:(B,N,ds) f32, segids:(B,N) int (−1 on padding) ->
    (idx:(B,N,k) int32, d2:(B,N,k) f32): per row, the k nearest rows of
    its own event, ties to the lowest column; a slot with no candidate
    left is (0, 1e30). Adds one to ``knn_build_cuda.launches`` per
    launch."""
    if s.ndim != 3 or segids.shape != s.shape[:2]:
        raise ValueError(f"knn_build_cuda: s {tuple(s.shape)}, segids "
                         f"{tuple(segids.shape)} are not (B, N, ds), "
                         "(B, N)")
    if k < 1:
        raise ValueError(f"knn_build_cuda: k={k}")
    bsz, n, ds = s.shape
    segids = segids.to(torch.int32).contiguous()
    _build.check_cuda("knn_build_cuda", [s, segids],
                      [torch.float32, torch.int32])
    lib = _library_build()
    _build.check_smem("knn_build_cuda", lib.knn_build_smem_bytes(n, ds),
                      f"n={n}, d_s={ds}")
    idx = torch.empty((bsz, n, k), dtype=torch.int32, device=s.device)
    d2 = torch.empty((bsz, n, k), dtype=torch.float32, device=s.device)
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.knn_build_f32(s.data_ptr(), segids.data_ptr(),
                                 idx.data_ptr(), d2.data_ptr(), bsz, n, ds,
                                 int(k), min(n, BM), stream)
    _build.check(code, "knn_build")
    knn_build_cuda.launches += 1
    return idx, d2


knn_build_cuda.launches = 0


def knn_aggregate_cuda(f, idx, d2, *, scale=10.0):
    """Gaussian-potential mean/max over prebuilt neighbours on the card.
    f:(B,N,df) f32, idx:(B,N,k) int32 (from knn_build; an index outside
    [0, N) selects a row of zeros, as the TPU kernel's one-hot product
    does), d2:(B,N,k) f32 -> (B,N,2·df). Adds one to
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
                      [torch.float32, torch.int32, torch.float32])
    lib = _library_agg()
    _build.check_smem("knn_aggregate_cuda",
                      lib.knn_aggregate_smem_bytes(n, df), f"n={n}, d_f={df}")
    y = torch.empty((bsz, n, 2 * df), dtype=torch.float32, device=f.device)
    with torch.cuda.device(f.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.knn_aggregate_f32(f.data_ptr(), idx.data_ptr(),
                                     d2.data_ptr(), y.data_ptr(), bsz, n,
                                     df, k, float(scale), min(n, BM), stream)
    _build.check(code, "knn_aggregate")
    knn_aggregate_cuda.launches += 1
    return y


knn_aggregate_cuda.launches = 0
