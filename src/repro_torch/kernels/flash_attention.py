"""Hopper kernel: blockwise (flash) attention, f32 or bf16.

Counterpart of ``repro/kernels/flash_attention.py``
(``flash_attention_pallas``). The CUDA source is
``csrc/flash_attention.cu``: a register-tiled SIMT kernel (FMA pipes,
f32 inside) whose CTA owns a tile of query rows and walks its kv tiles
through a double-buffered ``cp.async`` pipeline; where the q tiles
cannot fill the card, the kv tiles of a q tile are split over several
CTAs and a second pass merges their partial (m, l, acc). The plain
version is ``kernels/ref.py:flash_attention_blocked_ref``;
``kernels/ops.py`` pads S and T to the caller's blocks before either
runs.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

#: the largest head width the kernel takes
MAX_D = 128
#: the kernel's tiles of query rows and of keys (``plan_block``)
PLAN_BLOCKS = (32, 64, 128)
#: at most this many CTAs share the kv tiles of one q tile
MAX_SPLIT = 16
_lib = None
_n_sm: dict = {}


def plan_block(b: int) -> int:
    """The kernel's tile for a requested block ``b`` (bq or bk): the
    smallest of 32, 64, 128 that holds it, else 128. The blocks only
    move the rounding (a causal row sees the keys up to itself, whatever
    the tiles), so any request is served by one of the three."""
    return next((p for p in PLAN_BLOCKS if b <= p), PLAN_BLOCKS[-1])


def plan_width(d: int) -> int:
    """The head width the kernel's registers are laid out for."""
    return 64 if d <= 64 else 128


def _plan_floats(bq: int, bk: int, dp: int, stages: int) -> int:
    return (bq * (dp + 4) + stages * bk * (dp + 4) + stages * bk * dp
            + 32 * (bq + 4))


def plan_stages(bq: int, bk: int, d: int) -> int:
    """K/V buffers of the plan serving (bq, bk, d): two (the next tile
    loads while this one is computed) where they fit 227 KB, else one."""
    pq, pk, dp = plan_block(bq), plan_block(bk), plan_width(d)
    return 2 if 4 * _plan_floats(pq, pk, dp, 2) <= _build.SMEM_LIMIT else 1


def smem_bytes(bq: int, bk: int, d: int) -> int:
    """Shared memory one CTA needs for (bq, bk, d): the plan's Q tile
    and K tiles at row stride D + 4, its V tiles, and 32 keys of p at
    row stride BQ + 4, all f32, with ``plan_stages`` K/V buffers — the
    formula of the source's ``flash_attention_smem_bytes``, here so that
    a plan can be refused where the library cannot be built
    (``tuning/candidates.py``)."""
    pq, pk, dp = plan_block(bq), plan_block(bk), plan_width(d)
    return 4 * _plan_floats(pq, pk, dp, plan_stages(bq, bk, d))


def fits(bq: int, bk: int, d: int) -> bool:
    """Whether (bq, bk, d) is a plan the kernel launches: blocks of at
    least 1, d within the kernel's limit, its shared memory within the
    card's 227 KB."""
    return (bq >= 1 and bk >= 1 and 1 <= d <= MAX_D
            and smem_bytes(bq, bk, d) <= _build.SMEM_LIMIT)


def kv_split(bh: int, s: int, t: int, *, bq: int, bk: int,
             n_sm: int) -> tuple[int, int]:
    """(chunk, nsplit): the kv tiles of each q tile run in ``nsplit``
    CTAs of ``chunk`` tiles each. Where the BH x S/BQ q tiles are fewer
    than the card's ``n_sm`` SMs, as many splits as keep one CTA per SM
    (at most ``MAX_SPLIT``, at most one per kv tile); else one. On the
    H100 the split ran 2.5× faster than one CTA per q tile at (8, 512,
    512, 64) causal in 32 q tiles (``PERF.md`` §6)."""
    nkt = -(-t // plan_block(bk))
    base = bh * -(-s // plan_block(bq))
    nsplit = max(1, min(nkt, MAX_SPLIT, n_sm // max(base, 1)))
    chunk = -(-nkt // nsplit)
    return chunk, -(-nkt // chunk)


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("flash_attention")
        lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.flash_attention_smem_bytes.restype = ctypes.c_longlong
        for fn in (lib.flash_attention_f32, lib.flash_attention_bf16):
            fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p])
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def library_smem_bytes(bq: int, bk: int, d: int) -> int:
    """The built library's own answer for :func:`smem_bytes`."""
    return int(_library().flash_attention_smem_bytes(bq, bk, d))


def _sm_count(dev) -> int:
    if dev not in _n_sm:
        props = torch.cuda.get_device_properties(dev)
        _n_sm[dev] = props.multi_processor_count
    return _n_sm[dev]


def flash_attention_cuda(q, k, v, *, causal=True, bq=128, bk=128,
                         splits=None):
    """Blockwise attention on the card. q:(BH,S,D), k/v:(BH,T,D),
    contiguous, all f32 or all bf16 -> (BH,S,D) of the same dtype: per
    row, softmax(q.kᵀ/√D) v over its keys, those after the row masked
    under ``causal`` (top-left aligned, the reference's -1e30 fill).
    bf16 inputs are widened to f32 as they are loaded and the output is
    rounded to bf16. (bq, bk) pick the kernel's tiles (``plan_block``);
    ``kernels/ops.py`` pads S and T to them. ``splits`` forces the number
    of CTAs that share a q tile's kv tiles (default: ``kv_split``).
    Raises on another dtype, a D above 128 or T = 0. Adds one to
    ``flash_attention_cuda.launches`` and to
    ``flash_attention_cuda.launches_by_blocks[(bq, bk)]`` per launch
    (a split launch's merge pass included)."""
    if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape \
            or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError(f"flash_attention_cuda: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not "
                         "(BH, S, D), (BH, T, D), (BH, T, D)")
    bh, s, d = q.shape
    t = k.shape[1]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("flash_attention_cuda takes float32 or bfloat16, "
                        f"got {q.dtype}")
    _build.check_cuda("flash_attention_cuda", [q, k, v], [q.dtype] * 3)
    if not 1 <= d <= MAX_D or bq < 1 or bk < 1 or t == 0:
        raise ValueError(f"flash_attention_cuda: D={d}, T={t}, bq={bq}, "
                         f"bk={bk}; the kernel takes 1 <= D <= {MAX_D}, "
                         "T >= 1 and blocks >= 1")
    lib = _library()
    _build.check_smem("flash_attention_cuda",
                      lib.flash_attention_smem_bytes(bq, bk, d),
                      f"bq={bq} bk={bk} D={d}")
    nkt = -(-t // plan_block(bk))
    if splits is None:
        chunk, nsplit = kv_split(bh, s, t, bq=bq, bk=bk,
                                 n_sm=_sm_count(q.device))
    else:
        if not 1 <= splits <= MAX_SPLIT:
            raise ValueError(f"flash_attention_cuda: splits={splits}, the "
                             f"kernel takes 1 to {MAX_SPLIT}")
        chunk = -(-nkt // splits)
        nsplit = -(-nkt // chunk)
    out = torch.empty_like(q)
    ws_acc = ws_ml = None
    if nsplit > 1:
        ws_acc = torch.empty((nsplit, bh, s, d), dtype=torch.float32,
                             device=q.device)
        ws_ml = torch.empty((nsplit, bh, s, 2), dtype=torch.float32,
                            device=q.device)
    fn = (lib.flash_attention_f32 if q.dtype == torch.float32
          else lib.flash_attention_bf16)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  None if ws_acc is None else ws_acc.data_ptr(),
                  None if ws_ml is None else ws_ml.data_ptr(), bh, s, t, d,
                  bq, bk, int(bool(causal)), 1.0 / math.sqrt(d), chunk,
                  nsplit, stream)
    _build.check(code, "flash_attention")
    flash_attention_cuda.launches += 1
    by = flash_attention_cuda.launches_by_blocks
    by[(bq, bk)] = by.get((bq, bk), 0) + 1
    return out


flash_attention_cuda.launches = 0
flash_attention_cuda.launches_by_blocks = {}
