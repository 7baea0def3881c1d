"""Hopper kernel: fused dense = matmul + bias + activation, f32.

Counterpart of ``repro/kernels/fused_dense.py`` (``fused_dense_pallas``,
``fused_dense_batched_pallas``). The CUDA source is
``csrc/fused_dense.cu``; the plain version is
``kernels/ref.py:fused_dense_ref``. The TPU kernel's two variants
(one whole-operand cell, or a grid looped over K) were ways to fill the
TPU's matrix unit; on the card one tiled kernel serves both, and the
batched form row-packs its events into the same launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ACT = {None: 0, "none": 0, "linear": 0, "relu": 1}
_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("fused_dense")
        fn = lib.fused_dense_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib.fused_dense_f32


def act_code(activation) -> int:
    if activation not in _ACT:
        raise NotImplementedError(
            f"activation {activation!r}: only 'none' and 'relu' are ported")
    return _ACT[activation]


def fused_dense_cuda(x, w, b=None, *, activation="relu"):
    """act(x @ w + b) on the card. x:(M,K) w:(K,N) b:(N,)|None, f32,
    contiguous CUDA tensors -> (M,N). Adds one to
    ``fused_dense_cuda.launches`` per launch."""
    act = act_code(activation)
    ops = [x, w] + ([] if b is None else [b])
    if any(not t.is_cuda for t in ops):
        raise ValueError("fused_dense_cuda takes CUDA tensors")
    if any(t.device != x.device for t in ops):
        raise ValueError("fused_dense_cuda: operands on different devices")
    if any(t.dtype != torch.float32 for t in ops):
        raise TypeError("fused_dense_cuda takes float32 operands "
                        f"(got {[t.dtype for t in ops]})")
    if any(not t.is_contiguous() for t in ops):
        raise ValueError("fused_dense_cuda takes contiguous operands")
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"fused_dense_cuda: x {tuple(x.shape)} @ w "
                         f"{tuple(w.shape)}")
    m, kdim = x.shape
    n = w.shape[1]
    if b is not None and tuple(b.shape) != (n,):
        raise ValueError(f"fused_dense_cuda: bias {tuple(b.shape)} for "
                         f"{n} outputs")
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(x.data_ptr(), w.data_ptr(),
                  None if b is None else b.data_ptr(), y.data_ptr(),
                  m, kdim, n, act, stream)
    _build.check(code, "fused_dense")
    fused_dense_cuda.launches += 1
    return y


fused_dense_cuda.launches = 0
