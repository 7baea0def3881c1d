"""Hopper kernels: fused dense = matmul + bias + activation, in f32 (or
bf16 operands, summed in f32) and in int8.

Counterpart of ``repro/kernels/fused_dense.py`` (``fused_dense_pallas``,
``fused_dense_batched_pallas``, ``fused_dense_int8_pallas``). The CUDA
sources are ``csrc/fused_dense.cu`` and ``csrc/fused_dense_int8.cu``;
the plain versions are ``kernels/ref.py:fused_dense_ref`` and
``fused_dense_int8_ref``. The TPU kernel's two variants (one
whole-operand cell, or a grid looped over K) were ways to fill the
TPU's matrix unit; on the card one tiled kernel serves both, its tile
chosen from the shape by :func:`plan`, and the batched form row-packs
its events into the same launch. A caller may name the tile instead
(``bm``, ``bn``: :func:`variant_of`; the int8 kernel's among
:data:`INT8_TILES`), the tuner's knob; a pair that is not a tile raises
``ValueError``. The f32 kernel reads x through a row
stride, so a row-strided view (the executor's own-K view of a
lane-padded input) launches without a copy. It takes x, w and b in f32
or all three in bf16, as the TPU kernel does (bf16 × bf16 summed in
f32), and returns f32 or bf16 (``out_dtype``, by default x's): the
kernel reads the bf16 operands as they lie and widens them itself.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: the epilogues' activation codes (``csrc/activation.cuh``): gelu in its
#: tanh form (``jax.nn.gelu``'s default), silu as x·sigmoid(x)
_ACT = {None: 0, "none": 0, "linear": 0, "relu": 1, "gelu": 2, "silu": 3}
#: the f32 kernel's tiles, by variant (``csrc/fused_dense.cu:kTiles``):
#: (TR, TC, TY, TX), a thread's block of TR x TC outputs and the CTA's
#: TY x TX threads, so a CTA computes a (TR·TY) x (TC·TX) output tile
TILES = ((1, 2, 8, 16), (2, 2, 8, 16), (2, 2, 16, 16), (4, 4, 16, 16),
         (1, 1, 16, 8))
#: K staged whole in one round trip up to here; above it, slabs of
#: SLAB_K, two buffers deep
STAGE_K = 256
SLAB_K = 64
#: CTAs per launch that the plan stays within where it can: three per
#: SM of the H100
MAX_CTAS = 3 * 132
#: the tile of a narrow output (N at most its columns)
NARROW = 4
#: the variants from the smallest tile to the largest
BY_SIZE = (4, 0, 1, 2, 3)
#: the int8 kernel's CTA tiles (rows, columns) by their code in
#: ``csrc/fused_dense_int8.cu``; the first is the default
INT8_TILES = ((32, 16), (16, 16), (64, 16), (32, 32))
_lib = None
_lib_int8 = None


def tile(variant: int) -> tuple[int, int]:
    """(rows, columns) of a CTA's output tile."""
    tr, tc, ty, tx = TILES[variant]
    return tr * ty, tc * tx


def ctas(variant: int, m: int, n: int) -> int:
    """CTAs of a (m, ·) -> n product under ``variant``."""
    bm, bn = tile(variant)
    return -(-m // bm) * -(-n // bn)


def plan(m: int, n: int) -> int:
    """The tile of a (m, K) -> n product: 16 x 8 for a narrow output
    (the heads' N of 2 to 7), else the smallest tile whose CTAs stay
    within ``MAX_CTAS``, else the largest (64 x 64, 4 x 4 outputs a
    thread). Measured on the H100 over the paths' shapes, a CTA's time
    is its round trip and its outputs' chains of K adds, so more, smaller
    CTAs win until they queue three deep on the SMs (16 x 8 tiles: 144
    CTAs for (256, K) -> 70). K does not enter: every K up to ``STAGE_K``
    stages whole, and each output's chain is K long in every tile."""
    if n <= tile(NARROW)[1]:
        return NARROW
    return next((v for v in BY_SIZE if ctas(v, m, n) <= MAX_CTAS),
                BY_SIZE[-1])


def variant_of(m: int, n: int, bm=None, bn=None) -> int:
    """The variant of a (m, K) -> n launch: :func:`plan`'s where bm and
    bn are None, else the one whose tile is bm x bn; raises
    ``ValueError`` on a pair that is not a tile of :data:`TILES`."""
    if bm is None and bn is None:
        return plan(m, n)
    tiles = [tile(v) for v in range(len(TILES))]
    if (bm, bn) not in tiles:
        raise ValueError(f"fused_dense: (bm, bn) = ({bm}, {bn}) is not a "
                         f"tile of the kernel ({tiles})")
    return tiles.index((bm, bn))


def int8_tile_of(bm=None, bn=None) -> int:
    """The code of the int8 kernel's tile bm x bn (None, None: the
    default, 32 x 16); raises ``ValueError`` on a pair that is not one
    of :data:`INT8_TILES`."""
    if bm is None and bn is None:
        return 0
    if (bm, bn) not in INT8_TILES:
        raise ValueError(f"fused_dense_int8: (bm, bn) = ({bm}, {bn}) is "
                         f"not a tile of the kernel ({list(INT8_TILES)})")
    return INT8_TILES.index((bm, bn))


def smem_bytes(variant: int, k: int) -> int:
    """Shared memory of one CTA at depth k: its x slab (tile rows at a
    row stride of K rounded up to 4, plus 4) and w slab (K x tile
    columns), one buffer of the whole K up to ``STAGE_K``, else two of
    ``SLAB_K`` — the formula of the source's ``fused_dense_smem_bytes``.
    Both forms stage f32 (a bf16 operand widened on its way in)."""
    bm, bn = tile(variant)
    ks = k if k <= STAGE_K else SLAB_K
    nbuf = 1 if k <= STAGE_K else 2
    return 4 * nbuf * (bm * ((ks + 3) // 4 * 4 + 4) + ks * bn)


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("fused_dense")
        fn = lib.fused_dense_ex
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong]
                       + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.fused_dense_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.fused_dense_smem_bytes.restype = ctypes.c_longlong
        _lib = lib
    return _lib.fused_dense_ex


def library_smem_bytes(variant: int, k: int) -> int:
    """The built library's own answer for :func:`smem_bytes`."""
    _kernel()
    return int(_lib.fused_dense_smem_bytes(variant, k))


def _kernel_int8():
    global _lib_int8
    if _lib_int8 is None:
        lib = _build.load("fused_dense_int8")
        fn = lib.fused_dense_int8_ex
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_float,
                                                ctypes.c_void_p]
                       + [ctypes.c_int] * 5 + [ctypes.c_float,
                                               ctypes.c_int,
                                               ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib_int8 = lib
    return _lib_int8.fused_dense_int8_ex


def act_code(activation) -> int:
    if activation not in _ACT:
        raise ValueError(f"unknown activation {activation!r}")
    return _ACT[activation]


def row_strided(x) -> bool:
    """Whether the f32 kernel reads x:(M, K) as it lies: its columns
    contiguous and its rows one stride of at least K apart (any stride
    for a single row) — a contiguous matrix, or a column slice of one."""
    m, kdim = x.shape
    return (kdim <= 1 or x.stride(1) == 1) and (m <= 1
                                                or x.stride(0) >= kdim)


def fused_dense_cuda(x, w, b=None, *, activation="relu", out_dtype=None,
                     bm=None, bn=None):
    """act(x @ w + b) on the card. x:(M,K) w:(K,N) b:(N,)|None CUDA
    tensors, all float32 or all bfloat16 (summed in f32 either way), w and
    b contiguous, x contiguous or row-strided (:func:`row_strided`: a
    column slice of a contiguous matrix launches without a copy) ->
    (M,N) of ``out_dtype`` (float32 or bfloat16; None: x's dtype). The
    tile is bm x bn, or :func:`plan`'s where both are None
    (:func:`variant_of`), and is kept in ``fused_dense_cuda.last_plan``.
    Adds one to ``fused_dense_cuda.launches`` per launch."""
    act = act_code(activation)
    ops = [x, w] + ([] if b is None else [b])
    if any(not t.is_cuda for t in ops):
        raise ValueError("fused_dense_cuda takes CUDA tensors")
    if any(t.device != x.device for t in ops):
        raise ValueError("fused_dense_cuda: operands on different devices")
    in_code, out_code, out_dtype = _build.io_dtypes("fused_dense_cuda", ops,
                                                    out_dtype)
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"fused_dense_cuda: x {tuple(x.shape)} @ w "
                         f"{tuple(w.shape)}")
    if not row_strided(x) or any(not t.is_contiguous() for t in ops[1:]):
        raise ValueError("fused_dense_cuda takes contiguous w and b and an "
                         "x whose rows lie at one stride >= K with "
                         f"contiguous columns (x strides {x.stride()})")
    m, kdim = x.shape
    n = w.shape[1]
    if b is not None and tuple(b.shape) != (n,):
        raise ValueError(f"fused_dense_cuda: bias {tuple(b.shape)} for "
                         f"{n} outputs")
    variant = variant_of(m, n, bm, bn)
    _build.check_smem("fused_dense_cuda", smem_bytes(variant, kdim),
                      f"K={kdim}")
    y = torch.empty((m, n), dtype=out_dtype, device=x.device)
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(x.data_ptr(), x.stride(0) if m > 1 else kdim,
                  w.data_ptr(), None if b is None else b.data_ptr(),
                  y.data_ptr(), m, kdim, n, act, variant, in_code,
                  out_code, stream)
    _build.check(code, "fused_dense")
    fused_dense_cuda.last_plan = dict(zip(("bm", "bn"), tile(variant)))
    fused_dense_cuda.launches += 1
    return y


fused_dense_cuda.launches = 0
fused_dense_cuda.last_plan = None


def fused_dense_int8_cuda(x_q, w_q, b, x_scale, w_scale, *,
                          activation="relu", out_int8=False, out_scale=1.0,
                          bm=None, bn=None):
    """The quantized dense on the card: int8 x_q:(M,K) by int8 w_q:(K,N)
    into exact int32 sums, ``y = act(acc·(x_scale·w_scale[c]) + b)``,
    returned as f32, or requantized to int8 with ``out_scale`` when
    ``out_int8``. b:(N,) f32 or None, w_scale:(N,) f32; x_scale and
    out_scale are Python floats, passed as float32. The CTA tile is bm x
    bn of :data:`INT8_TILES` (None, None: 32 x 16; :func:`int8_tile_of`),
    kept in ``fused_dense_int8_cuda.last_plan``. Adds one to
    ``fused_dense_int8_cuda.launches`` per launch."""
    act = act_code(activation)
    ops = [x_q, w_q, w_scale] + ([] if b is None else [b])
    if any(not t.is_cuda or t.device != x_q.device for t in ops):
        raise ValueError("fused_dense_int8_cuda takes CUDA tensors on one "
                         "device")
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError("fused_dense_int8_cuda takes int8 x_q and w_q "
                        f"(got {x_q.dtype}, {w_q.dtype})")
    if w_scale.dtype != torch.float32 or (
            b is not None and b.dtype != torch.float32):
        raise TypeError("fused_dense_int8_cuda takes float32 w_scale and b")
    if any(not t.is_contiguous() for t in ops):
        raise ValueError("fused_dense_int8_cuda takes contiguous operands")
    if x_q.ndim != 2 or w_q.ndim != 2 or x_q.shape[1] != w_q.shape[0]:
        raise ValueError(f"fused_dense_int8_cuda: x {tuple(x_q.shape)} @ w "
                         f"{tuple(w_q.shape)}")
    m, kdim = x_q.shape
    n = w_q.shape[1]
    for nm, t in (("w_scale", w_scale), ("b", b)):
        if t is not None and tuple(t.shape) != (n,):
            raise ValueError(f"fused_dense_int8_cuda: {nm} "
                             f"{tuple(t.shape)} for {n} outputs")
    code_tile = int8_tile_of(bm, bn)
    y = torch.empty((m, n), dtype=torch.int8 if out_int8 else torch.float32,
                    device=x_q.device)
    fn = _kernel_int8()
    with torch.cuda.device(x_q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(x_q.data_ptr(), w_q.data_ptr(),
                  None if b is None else b.data_ptr(), w_scale.data_ptr(),
                  float(x_scale), y.data_ptr(), m, kdim, n, act,
                  int(out_int8), float(out_scale), code_tile, stream)
    _build.check(code, "fused_dense_int8")
    fused_dense_int8_cuda.last_plan = dict(zip(("bm", "bn"),
                                               INT8_TILES[code_tile]))
    fused_dense_int8_cuda.launches += 1
    return y


fused_dense_int8_cuda.launches = 0
fused_dense_int8_cuda.last_plan = None
