"""Hopper kernel: blockwise (flash) attention, f32.

Counterpart of ``repro/kernels/flash_attention.py``
(``flash_attention_pallas``). The CUDA source is
``csrc/flash_attention.cu``: one CTA per (bh, q block) walks the kv
blocks itself, with the K and V tiles, the accumulator and the running
max and denominator in shared memory. The plain version is
``kernels/ref.py:flash_attention_blocked_ref``; ``kernels/ops.py`` pads S
and T to the blocks before either runs.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

#: the largest head width and kv block the kernel takes
MAX_D = 128
MAX_BK = 256
_lib = None


def smem_bytes(bq: int, bk: int, d: int) -> int:
    """Shared memory one CTA needs for (bq, bk, d): the K tile at row
    stride d + 1, the V tile, the accumulator, the running max and
    denominator, all f32 — the formula of the source's
    ``flash_attention_smem_bytes``, here so that a plan can be refused
    where the library cannot be built (``tuning/candidates.py``)."""
    return 4 * (bk * (d + 1) + bk * d + bq * d + 2 * bq)


def fits(bq: int, bk: int, d: int) -> bool:
    """Whether (bq, bk, d) is a plan the kernel launches: its shared
    memory within the card's 227 KB, bk and d within the kernel's
    limits."""
    return (1 <= bk <= MAX_BK and 1 <= d <= MAX_D
            and smem_bytes(bq, bk, d) <= _build.SMEM_LIMIT)


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("flash_attention")
        lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.flash_attention_smem_bytes.restype = ctypes.c_longlong
        fn = lib.flash_attention_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def library_smem_bytes(bq: int, bk: int, d: int) -> int:
    """The built library's own answer for :func:`smem_bytes`."""
    return int(_library().flash_attention_smem_bytes(bq, bk, d))


def flash_attention_cuda(q, k, v, *, causal=True, bq=128, bk=128):
    """Blockwise attention on the card. q:(BH,S,D), k/v:(BH,T,D), f32,
    contiguous, S % bq == 0 and T % bk == 0 (``kernels/ops.py`` pads) ->
    (BH,S,D): per row, softmax(q.kᵀ/√D) v over its keys, those after the
    row masked under ``causal`` (top-left aligned, the reference's
    -1e30 fill). Raises on another dtype (bf16 is not ported), a
    D above 128, a bk above 256 or a plan above 227 KB of shared memory.
    Adds one to ``flash_attention_cuda.launches`` and to
    ``flash_attention_cuda.launches_by_blocks[(bq, bk)]`` per launch."""
    if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape \
            or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError(f"flash_attention_cuda: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not "
                         "(BH, S, D), (BH, T, D), (BH, T, D)")
    bh, s, d = q.shape
    t = k.shape[1]
    _build.check_cuda("flash_attention_cuda", [q, k, v],
                      [torch.float32] * 3)
    if not 1 <= d <= MAX_D or not 1 <= bk <= MAX_BK or bq < 1:
        raise ValueError(f"flash_attention_cuda: D={d}, bq={bq}, bk={bk}; "
                         f"the kernel takes D <= {MAX_D}, bk <= {MAX_BK}")
    if s % bq or t % bk or t == 0:
        raise ValueError(f"flash_attention_cuda: S={s}, T={t} are not "
                         f"multiples of bq={bq}, bk={bk} (ops pads them)")
    lib = _library()
    _build.check_smem("flash_attention_cuda",
                      lib.flash_attention_smem_bytes(bq, bk, d),
                      f"bq={bq} bk={bk} D={d}")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.flash_attention_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, s,
            t, d, bq, bk, int(bool(causal)), 1.0 / math.sqrt(d), stream)
    _build.check(code, "flash_attention")
    flash_attention_cuda.launches += 1
    by = flash_attention_cuda.launches_by_blocks
    by[(bq, bk)] = by.get((bq, bk), 0) + 1
    return out


flash_attention_cuda.launches = 0
flash_attention_cuda.launches_by_blocks = {}
