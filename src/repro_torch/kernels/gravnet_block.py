"""Hopper kernel: one whole GravNet block per launch, f32.

Counterpart of ``repro/kernels/gravnet_block.py``
(``gravnet_block_batched_pallas``; ``gravnet_block_pallas`` is the same
kernel at B = 1). The CUDA source is ``csrc/gravnet_block.cu`` with the
cell in ``csrc/gravnet_cell.cuh``; the plain version is
``kernels/ref.py:gravnet_block_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_dense import act_code

#: shared memory one block may use on Hopper (227 KB)
SMEM_LIMIT = 232448
#: query rows per CTA: 4 CTAs per event at the main path's 128 hits
BM = 32
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("gravnet_block")
        lib.gravnet_block_smem_bytes.argtypes = [ctypes.c_int] * 6
        lib.gravnet_block_smem_bytes.restype = ctypes.c_longlong
        fn = lib.gravnet_block_f32
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def gravnet_block_cuda(x, mask, ws, bs, wf, bf, wo, bo, *, k=8, scale=10.0,
                       activation="relu"):
    """One fused GravNet block on the card for a micro-batch:
    act(concat(x, agg) @ wo + bo).

    x:(B,N,dh) f32, mask:(B,N) -> (B,N,d_out). ws:(dh,ds) bs:(ds,)
    wf:(dh,df) bf:(df,) wo:(dh+2df, d_out) bo:(d_out,). Raises on
    a shape whose shared-memory plan exceeds the card's 227 KB. Adds one
    to ``gravnet_block_cuda.launches`` per launch."""
    act = act_code(activation)
    if x.ndim != 3:
        raise ValueError(f"gravnet_block_cuda: x {tuple(x.shape)} is not "
                         "(B, N, d_hidden)")
    bsz, n, dh = x.shape
    ds, df = ws.shape[1], wf.shape[1]
    dcat, dout = wo.shape
    want = {"mask": (bsz, n), "ws": (dh, ds), "bs": (ds,), "wf": (dh, df),
            "bf": (df,), "wo": (dh + 2 * df, dout),
            "bo": (dout,)}
    got = {"mask": mask, "ws": ws, "bs": bs, "wf": wf, "bf": bf, "wo": wo,
           "bo": bo}
    for nm, t in got.items():
        if tuple(t.shape) != want[nm]:
            raise ValueError(f"gravnet_block_cuda: {nm} {tuple(t.shape)}, "
                             f"expected {want[nm]}")
    mask = mask.to(torch.float32).contiguous()
    ops = [x, mask, ws, bs, wf, bf, wo, bo]
    if any(not t.is_cuda or t.device != x.device for t in ops):
        raise ValueError("gravnet_block_cuda takes CUDA tensors on one "
                         "device")
    if any(t.dtype != torch.float32 for t in ops):
        raise TypeError("gravnet_block_cuda takes float32 operands")
    if any(not t.is_contiguous() for t in ops):
        raise ValueError("gravnet_block_cuda takes contiguous operands")
    bm = min(n, BM)
    lib = _library()
    smem = lib.gravnet_block_smem_bytes(n, dh, ds, df, dout, bm)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"gravnet_block_cuda: n={n}, d_hidden={dh}, d_f={df}, "
            f"d_out={dout}, bm={bm} needs {smem} B of shared memory "
            f"> {SMEM_LIMIT} B")
    y = torch.empty((bsz, n, dout), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.gravnet_block_f32(
            *(t.data_ptr() for t in ops), y.data_ptr(), bsz, n, dh, ds, df,
            dout, int(k), float(scale), act, bm, stream)
    _build.check(code, "gravnet_block")
    gravnet_block_cuda.launches += 1
    return y


gravnet_block_cuda.launches = 0
