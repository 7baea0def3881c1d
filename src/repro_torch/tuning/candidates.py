"""Candidate launch configurations for the port's kernels.

Counterpart of ``repro/tuning/candidates.py``. Every list starts with
the **heuristic default**, the configuration the code picks without
tuning; the autotuner switches away from it only on a measured win of
more than ``autotune.MIN_GAIN``, so a noisy timing cannot make a
deployment slower than untuned.

Of the port's CUDA sources, only ``csrc/flash_attention.cu`` takes a
launch knob yet: its ``(bq, bk)`` blocks, which pick its tiles of query
rows and keys (``kernels/flash_attention.py:plan_block``). They are
searched over the kernel's own tiles, 32, 64 and 128, less every pair
whose shared memory plan (``smem_bytes``, the source's
``flash_attention_smem_bytes``) exceeds the card's 227 KB at the
problem's head width, so no refused plan is ever launched. The other
kernels (``fused_dense``, ``fused_dense_int8``, ``gravnet_aggregate``,
``gravnet_block``, ``gravnet_block_int8``, ``edge_aggregate``,
``knn_build``, ``knn_aggregate``) read no knob the binder writes, so
their lists hold the default alone: a search would time one program
several times. The defaults are the reference's, so a cache entry
records what the binder writes. A PR that gives one of them a knob
gives it a Hopper candidate space here.
"""
from __future__ import annotations

from repro_torch.core.passes import kernel_opt as _ko
from repro_torch.kernels.flash_attention import PLAN_BLOCKS as _FLASH_TILES
from repro_torch.kernels.flash_attention import fits as _flash_fits


def _dedup_keep_order(cands: list[dict]) -> list[dict]:
    seen, out = set(), []
    for c in cands:
        sig = tuple(sorted(c.items()))
        if sig not in seen:
            seen.add(sig)
            out.append(c)
    return out


def default_fused_dense(rows: int, d_in: int, d_out: int) -> dict:
    """The untuned binding of ``op_registry._bind_fused_dense``."""
    if rows <= _ko.FLATTEN_ROWS and max(d_in, d_out) <= _ko.FLATTEN_DIM:
        return {"variant": "flattened"}
    return {"variant": "looped",
            "bm": _ko._pick_block(rows, 512),
            "bn": _ko._pick_block(d_out, 512),
            "bk": _ko._pick_block(d_in, 2048)}


def fused_dense_candidates(rows: int, d_in: int, d_out: int) -> list[dict]:
    return [default_fused_dense(rows, d_in, d_out)]


def default_fused_dense_int8(rows: int, d_in: int, d_out: int) -> dict:
    return {"variant": "looped", "bm": 128, "bn": 128, "bk": 512}


def fused_dense_int8_candidates(rows: int, d_in: int,
                                d_out: int) -> list[dict]:
    return [default_fused_dense_int8(rows, d_in, d_out)]


def default_gravnet(n: int, batch: int = 1) -> dict:
    return {"bm": min(n, 128)}


def gravnet_candidates(n: int, *, batch: int = 1) -> list[dict]:
    return [default_gravnet(n, batch)]


def default_gravnet_block(n: int, batch: int = 1) -> dict:
    return {"bm": min(n, 128)}


def gravnet_block_candidates(n: int, d_hidden: int, d_f: int, d_out: int,
                             *, concat_x: bool = True,
                             batch: int = 1) -> list[dict]:
    return [default_gravnet_block(n, batch)]


def default_gravnet_block_int8(n: int, batch: int = 1) -> dict:
    return {"bm": min(n, 128)}


def gravnet_block_int8_candidates(n: int, d_hidden: int, d_f: int,
                                  d_out: int, *, concat_x: bool = True,
                                  batch: int = 1) -> list[dict]:
    return [default_gravnet_block_int8(n, batch)]


def default_edge_aggregate(n: int, e: int, batch: int = 1) -> dict:
    return {"bm": min(n, 128)}


def edge_aggregate_candidates(n: int, e: int, *,
                              batch: int = 1) -> list[dict]:
    return [default_edge_aggregate(n, e, batch)]


def default_knn_build(n: int, batch: int = 1) -> dict:
    return {"bm": min(n, 128)}


def knn_build_candidates(n: int, *, batch: int = 1) -> list[dict]:
    return [default_knn_build(n, batch)]


def default_knn_aggregate(n: int, batch: int = 1) -> dict:
    return {"bm": min(n, 128)}


def knn_aggregate_candidates(n: int, *, batch: int = 1) -> list[dict]:
    return [default_knn_aggregate(n, batch)]


def default_flash_attention() -> dict:
    """``kernels/ops.py:flash_attention``'s blocks."""
    return {"bq": 128, "bk": 128}


def flash_attention_candidates(s: int, t: int, d: int, *,
                               max_candidates: int = 10) -> list[dict]:
    """The default, then every (bq, bk) of the kernel's tiles 32, 64,
    128, cut to (s, t) as the wrapper cuts them, whose plan fits the card
    at head width d."""
    cands = [default_flash_attention()]
    for bq in _FLASH_TILES:
        for bk in _FLASH_TILES:
            c = {"bq": min(bq, s), "bk": min(bk, t)}
            if _flash_fits(c["bq"], c["bk"], d):
                cands.append(c)
    return _dedup_keep_order(cands)[:max_candidates]
