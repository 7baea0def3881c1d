"""Hopper kernels: one whole GravNet block per launch, in f32 and
quantized (int8).

Counterpart of ``repro/kernels/gravnet_block.py``
(``gravnet_block_batched_pallas`` and
``gravnet_block_int8_batched_pallas``; the per-event
``gravnet_block_pallas`` and ``gravnet_block_int8_pallas`` are the same
kernels at B = 1). The CUDA sources are ``csrc/gravnet_block.cu`` and
``csrc/gravnet_block_int8.cu``, both with the register-resident cell of
``csrc/gravnet_cell_reg.cuh`` (the f32 one, past that cell's limits,
with the shared-memory cell of ``csrc/gravnet_cell.cuh``), the second
with int8 tensor-core products; the plain versions are
``kernels/ref.py:gravnet_block_ref`` and ``gravnet_block_int8_ref``.
:func:`plan` picks the f32 block's rows per CTA and its cell,
:func:`int8_plan` the int8 block's rows; either takes the caller's rows
instead (``bm``, the tuner's knob) on the cell the shape runs. Both
blocks take the reference's forms: the output dense over concat(x, agg)
or, with ``concat_x=False``, over agg alone; the activations of
``fused_dense.act_code``; the int8 block's output f32 or requantized to
int8 (``out_int8``, ``out_scale``); the f32 block's x, weights and
biases in f32 or all in bf16 with its output f32 or bf16 (``out_dtype``,
by default x's), and the int8 block's x in f32 or bf16, each read as it
lies and widened by the kernel. The C entries with every form are
``gravnet_block_ex`` and ``gravnet_block_int8_ex``; the sources' earlier
entries stay for the tools that call them.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_dense import act_code

#: query rows per CTA of the f32 block on the register cell, one per
#: warp: 16 CTAs at the fp chunk's 2 events of 128 hits
BM = 16
#: query rows per CTA of its shared-memory cell (the first design's)
BM_SHARED = 32
#: query rows per CTA of the int8 block, one per warp: 8 CTAs per event
#: at the main path's 128 hits (the kernel takes at most 16)
BM_INT8 = 16
#: the register cell keeps a row's distances and outputs in registers:
#: at most 16 candidates and 4 feature columns per lane
#: (``csrc/gravnet_cell_reg.cuh``)
MAX_HITS = 512
MAX_DF = 128
_lib = None
_lib_int8 = None


def _round4(v: int) -> int:
    return (v + 3) & ~3


def _dcat(dh: int, df: int, concat_x: bool) -> int:
    """The output dense's K: concat(x, agg), or agg alone."""
    return (dh if concat_x else 0) + 2 * df


def smem_bytes(n: int, dh: int, ds: int, df: int, dout: int, bm: int,
               cell: str, concat_x: bool = True) -> int:
    """Shared memory of one CTA of the f32 block (the formulas of the
    source's ``layout`` and ``shared_layout``). ``register``: x in rows
    padded to 4 floats plus 4 (and to a multiple of 4 rows), S, F, the
    mask, the weights in rows padded to 4 floats, the biases and 16 rows
    of h, each 16-byte aligned; ``shared``: the first design's x, S, F,
    |s|², mask, weights, bm rows of the aggregate and 8 warps' distance
    rows. Wo and h are (dh + 2·df) wide, 2·df without ``concat_x``."""
    dcat = _dcat(dh, df, concat_x)
    if cell == "register":
        return 4 * (_round4(n) * (_round4(dh) + 4)
                    + _round4(n * ds) + _round4(n * df) + _round4(n)
                    + dh * (_round4(ds) + _round4(df))
                    + dcat * _round4(dout) + _round4(ds) + _round4(df)
                    + _round4(dout) + BM * (_round4(dcat) + 4))
    return 4 * (n * (dh + ds + df + 2) + dh * (ds + df) + ds + df
                + dcat * dout + dout + bm * 2 * df + 8 * n)


def plan(n: int, dh: int, ds: int, df: int, dout: int,
         concat_x: bool = True, bm=None) -> tuple[int, str]:
    """(bm, cell) of an f32 block launch at these widths: 16 query rows a
    CTA on the register cell wherever it takes the shape (n <= 512, d_f
    <= 128) and its shared memory fits the card, else the first design's
    32 on the shared-memory cell. The source's ``register_cell`` applies
    the same rule to the bm it is given. A given ``bm`` is taken on the
    same cell: 1 to 16 rows on the register cell, any whose shared
    memory fits on the other; else ``ValueError``."""
    if n <= MAX_HITS and df <= MAX_DF and smem_bytes(
            n, dh, ds, df, dout, BM, "register",
            concat_x) <= _build.SMEM_LIMIT:
        if bm is None:
            return min(n, BM), "register"
        return _build.check_rows("gravnet_block", bm, "register", BM), \
            "register"
    if bm is None:
        return min(n, BM_SHARED), "shared"
    bm = _build.check_rows("gravnet_block", bm, "shared", None)
    _build.check_smem("gravnet_block",
                      smem_bytes(n, dh, ds, df, dout, bm, "shared", concat_x),
                      f"bm={bm}")
    return bm, "shared"


def int8_smem_bytes(n: int, dh: int, ds: int, df: int, dout: int, bm: int,
                    concat_x: bool = True) -> int:
    """Shared memory of one CTA of the int8 block (the formula of the
    source's ``layout``, in bytes): x and h quantized in rows padded to
    32 bytes plus 16 (h: 16 rows), Ws and Wf, then Wo, transposed in
    rows of 8; the weights as they lie, overlaid by S and F; bm rows of
    x in f32, the mask, the biases and the scales."""
    def up(v, m):
        return (v + m - 1) // m * m
    dcat = _dcat(dh, df, concat_x)
    ldx, ldh = up(dh, 32) + 16, up(dcat, 32) + 16
    o = (up(n, 16) * ldx + BM_INT8 * ldh + (up(ds, 8) + up(df, 8)) * ldx
         + up(dout, 8) * ldh)
    raw_end = o + up(dh * ds, 16) + up(dh * df, 16) + up(dcat * dout, 16)
    sf_end = up(o + 4 * n * ds + 4 * n * df, 16)
    return (max(raw_end, sf_end) + 4 * up(bm * dh, 4) + 4 * up(n, 4)
            + 8 * (ds + df + dout))


def int8_plan(n: int, dh: int, ds: int, df: int, dout: int,
              concat_x: bool = True, bm=None) -> int:
    """The int8 block's query rows a CTA: ``min(n, 16)``, or a given
    ``bm`` of 1 to 16 (the source's ``kMaxRows``: one MMA row tile);
    ``ValueError`` on any other, on more than 512 hits or d_f above 128
    (the cell's registers) and on a shared-memory plan past the card's
    227 KB."""
    if n > MAX_HITS or df > MAX_DF:
        raise ValueError(
            f"gravnet_block_int8: n={n}, d_f={df}: the cell takes at most "
            f"{MAX_HITS} hits and d_f <= {MAX_DF}")
    bm = min(n, BM_INT8) if bm is None else _build.check_rows(
        "gravnet_block_int8", bm, "register", BM_INT8)
    _build.check_smem("gravnet_block_int8",
                      int8_smem_bytes(n, dh, ds, df, dout, bm, concat_x),
                      f"n={n}, d_hidden={dh}, d_f={df}, d_out={dout}, "
                      f"bm={bm}")
    return bm


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("gravnet_block")
        lib.gravnet_block_smem_bytes.argtypes = [ctypes.c_int] * 7
        lib.gravnet_block_smem_bytes.restype = ctypes.c_longlong
        fn = lib.gravnet_block_ex
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                       + [ctypes.c_float] + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def library_smem_bytes(n: int, dh: int, ds: int, df: int, dout: int,
                       bm: int, concat_x: bool = True) -> int:
    """The built library's own answer for :func:`smem_bytes` on the path
    it takes at this bm."""
    return int(_library().gravnet_block_smem_bytes(n, dh, ds, df, dout, bm,
                                                   int(concat_x)))


def gravnet_block_cuda(x, mask, ws, bs, wf, bf, wo, bo, *, k=8, scale=10.0,
                       activation="relu", concat_x=True, out_dtype=None,
                       bm=None):
    """One fused GravNet block on the card for a micro-batch:
    act(concat(x, agg) @ wo + bo), or act(agg @ wo + bo) without
    ``concat_x``.

    x:(B,N,dh), mask:(B,N) -> (B,N,d_out) of ``out_dtype`` (float32 or
    bfloat16; None: x's dtype). ws:(dh,ds) bs:(ds,) wf:(dh,df) bf:(df,)
    wo:(dh+2df, d_out) (or (2df, d_out)) bo:(d_out,); x, the weights and
    the biases all float32 or all bfloat16 (computed in f32). ``bm``
    rows a CTA, or :func:`plan`'s where None, kept in
    ``gravnet_block_cuda.last_plan``.
    Raises on a shape whose shared-memory plan (:func:`plan`) exceeds
    the card's 227 KB. Adds one to ``gravnet_block_cuda.launches`` per
    launch."""
    act = act_code(activation)
    if x.ndim != 3:
        raise ValueError(f"gravnet_block_cuda: x {tuple(x.shape)} is not "
                         "(B, N, d_hidden)")
    bsz, n, dh = x.shape
    ds, df = ws.shape[1], wf.shape[1]
    dout = wo.shape[1]
    want = {"mask": (bsz, n), "ws": (dh, ds), "bs": (ds,), "wf": (dh, df),
            "bf": (df,), "wo": (_dcat(dh, df, concat_x), dout),
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
    in_code, out_code, out_dtype = _build.io_dtypes(
        "gravnet_block_cuda", [x, ws, bs, wf, bf, wo, bo], out_dtype)
    if any(not t.is_contiguous() for t in ops):
        raise ValueError("gravnet_block_cuda takes contiguous operands")
    bm, cell = plan(n, dh, ds, df, dout, concat_x, bm)
    lib = _library()
    smem = smem_bytes(n, dh, ds, df, dout, bm, cell, concat_x)
    if smem > _build.SMEM_LIMIT:
        raise ValueError(
            f"gravnet_block_cuda: n={n}, d_hidden={dh}, d_f={df}, "
            f"d_out={dout}, bm={bm} needs {smem} B of shared memory "
            f"> {_build.SMEM_LIMIT} B")
    y = torch.empty((bsz, n, dout), dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.gravnet_block_ex(
            *(t.data_ptr() for t in ops), y.data_ptr(), bsz, n, dh, ds, df,
            dout, int(k), float(scale), act, int(concat_x), bm, in_code,
            out_code, stream)
    _build.check(code, "gravnet_block")
    gravnet_block_cuda.last_plan = {"bm": bm}
    gravnet_block_cuda.launches += 1
    return y


gravnet_block_cuda.launches = 0
gravnet_block_cuda.last_plan = None


def _library_int8():
    global _lib_int8
    if _lib_int8 is None:
        lib = _build.load("gravnet_block_int8")
        lib.gravnet_block_int8_smem_bytes.argtypes = [ctypes.c_int] * 7
        lib.gravnet_block_int8_smem_bytes.restype = ctypes.c_longlong
        fn = lib.gravnet_block_int8_ex
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 7
                       + [ctypes.c_float] * 4 + [ctypes.c_int] * 3
                       + [ctypes.c_float] + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib_int8 = lib
    return _lib_int8


def library_int8_smem_bytes(n: int, dh: int, ds: int, df: int, dout: int,
                            bm: int, concat_x: bool = True) -> int:
    """The built library's own answer for :func:`int8_smem_bytes`."""
    return int(_library_int8().gravnet_block_int8_smem_bytes(
        n, dh, ds, df, dout, bm, int(concat_x)))


def gravnet_block_int8_cuda(x, mask, ws_q, bs, wf_q, bf, wo_q, bo, ws_scale,
                            wf_scale, wo_scale, *, x_scale, agg_scale,
                            h_scale, k=8, scale=10.0, activation="relu",
                            concat_x=True, out_int8=False, out_scale=1.0,
                            bm=None):
    """One quantized GravNet block on the card for a micro-batch:
    quantize x with ``x_scale``, int8 S/F dots, the f32 cell, snap the
    aggregate to ``agg_scale``'s grid, quantize concat(x, agg) (agg
    alone without ``concat_x``) with ``h_scale``, int8 output dot with
    dequant, bias and activation, and with ``out_int8`` the output
    requantized as ``clip(round(y / out_scale), ±127)``.

    x:(B,N,dh) float32 or bfloat16 (read as f32), mask:(B,N) ->
    (B,N,d_out) f32 (int8 with ``out_int8``). ws_q:(dh,ds)
    wf_q:(dh,df) wo_q:(dh+2df, d_out) (or (2df, d_out)) int8; bs, bf,
    bo and the per-channel ``*_scale``
    vectors f32 of the matching output widths. The activation scales
    are Python floats, passed as float32. ``bm`` rows a CTA, or
    :func:`int8_plan`'s where None, kept in
    ``gravnet_block_int8_cuda.last_plan``.
    Raises on more than 512 hits, on d_f above 128 (the cell's
    registers) and on a shape whose shared-memory plan exceeds the
    card's 227 KB. Adds one to ``gravnet_block_int8_cuda.launches`` per
    launch."""
    act = act_code(activation)
    if x.ndim != 3:
        raise ValueError(f"gravnet_block_int8_cuda: x {tuple(x.shape)} is "
                         "not (B, N, d_hidden)")
    bsz, n, dh = x.shape
    ds, df = ws_q.shape[1], wf_q.shape[1]
    dout = wo_q.shape[1]
    want = {"mask": (bsz, n), "ws_q": (dh, ds), "bs": (ds,),
            "wf_q": (dh, df), "bf": (df,),
            "wo_q": (_dcat(dh, df, concat_x), dout),
            "bo": (dout,), "ws_scale": (ds,), "wf_scale": (df,),
            "wo_scale": (dout,)}
    got = {"mask": mask, "ws_q": ws_q, "bs": bs, "wf_q": wf_q, "bf": bf,
           "wo_q": wo_q, "bo": bo, "ws_scale": ws_scale,
           "wf_scale": wf_scale, "wo_scale": wo_scale}
    for nm, t in got.items():
        if tuple(t.shape) != want[nm]:
            raise ValueError(f"gravnet_block_int8_cuda: {nm} "
                             f"{tuple(t.shape)}, expected {want[nm]}")
    mask = mask.to(torch.float32).contiguous()
    ops = [x, mask, ws_q, bs, wf_q, bf, wo_q, bo, ws_scale, wf_scale,
           wo_scale]
    if any(not t.is_cuda or t.device != x.device for t in ops):
        raise ValueError("gravnet_block_int8_cuda takes CUDA tensors on one "
                         "device")
    if any(t.dtype != (torch.int8 if nm.endswith("_q") else torch.float32)
           for nm, t in zip(got, ops[1:])):
        raise TypeError("gravnet_block_int8_cuda takes int8 weights and "
                        "float32 biases and scales")
    x_code, _, _ = _build.io_dtypes("gravnet_block_int8_cuda", [x])
    if any(not t.is_contiguous() for t in ops):
        raise ValueError("gravnet_block_int8_cuda takes contiguous operands")
    bm = int8_plan(n, dh, ds, df, dout, concat_x, bm)
    lib = _library_int8()
    y = torch.empty((bsz, n, dout), device=x.device,
                    dtype=torch.int8 if out_int8 else torch.float32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.gravnet_block_int8_ex(
            *(t.data_ptr() for t in ops), y.data_ptr(), bsz, n, dh, ds, df,
            dout, int(k), float(scale), float(x_scale), float(agg_scale),
            float(h_scale), act, int(concat_x), int(out_int8),
            float(out_scale), bm, x_code, stream)
    _build.check(code, "gravnet_block_int8")
    gravnet_block_int8_cuda.last_plan = {"bm": bm}
    gravnet_block_int8_cuda.launches += 1
    return y


gravnet_block_int8_cuda.launches = 0
gravnet_block_int8_cuda.last_plan = None
