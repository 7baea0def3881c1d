"""Candidate launch configurations for the port's kernels.

Counterpart of ``repro/tuning/candidates.py``. Every list starts with
the **default**, the plan the kernel's wrapper picks with no knob, in
knob form, so the autotuner compares every candidate against today's
launch and switches away from it only on a measured win of more than
``autotune.MIN_GAIN``: a noisy timing cannot make a deployment slower
than untuned. Then come the source's other plans that can run the
shape, each once; none of them changes a result bit, since no knob here
reorders an f32 sum (each output keeps its chain of adds, and integer
sums are exact in any order).

The Hopper spaces, by family (the reference's names where the meaning
carries over: ``bm`` a CTA's query or destination rows, ``bn`` its
output columns):

- ``fused_dense``: (bm, bn), one of the f32 kernel's five tiles
  (``kernels/fused_dense.py:TILES``: 16x8, 8x32, 16x32, 32x32, 64x64)
  whose shared memory fits at the problem's K; ``fused_dense_int8``:
  the int8 kernel's tiles (``INT8_TILES``: 32x16, 16x16, 64x16, 32x32);
- ``gravnet``, ``knn_build``, ``knn_aggregate``: bm, 4, 8 or 16 rows
  cut to n on the register cell, 8, 16 or 32 on the shared-memory cell
  (``kernels/gravnet.py:plan``, ``knn_build.py:build_plan``,
  ``aggregate_plan``);
- ``gravnet_block``: bm, 4, 8 or 16 on the register cell, the first
  design's 32 where the shape needs the shared-memory cell
  (``gravnet_block.py:plan``); ``gravnet_block_int8``: 4, 8 or 16
  (``int8_plan``); a raggedized block, which runs the kNN pair, the
  rows both kNN kernels take, after ``{}`` (no knob) where the two
  kernels' own plans differ;
- ``edge_aggregate``: (bm, bn), the edge kernel's five (rows, columns)
  tiles cut to (n, d) (``edge_aggregate.py:TILES``);
- ``flash_attention``: (bq, bk), its tiles 32, 64 and 128, less every
  pair whose shared memory plan (``flash_attention_smem_bytes``)
  exceeds the card's 227 KB at the problem's head width.

Every candidate passes its wrapper's own plan check, so no refused plan
is ever launched. The reference's other knobs (the dense's ``variant``
and ``bk``, the blocks' epilogue ``bn`` and ``bk``, the edge kernel's
``be``) have no counterpart on the card and are searched nowhere here.
"""
from __future__ import annotations

from repro_torch.kernels import _build
from repro_torch.kernels import edge_aggregate as _edge
from repro_torch.kernels import fused_dense as _dense
from repro_torch.kernels import gravnet as _gravnet
from repro_torch.kernels import gravnet_block as _block
from repro_torch.kernels import knn_build as _knn
from repro_torch.kernels.flash_attention import PLAN_BLOCKS as _FLASH_TILES
from repro_torch.kernels.flash_attention import fits as _flash_fits

#: the rows a CTA of a one-warp-a-row kernel is searched over, by cell
ROWS = {"register": _gravnet.ROWS, "shared": (8, 16, 32)}


def _dedup_keep_order(cands: list[dict]) -> list[dict]:
    seen, out = set(), []
    for c in cands:
        sig = tuple(sorted(c.items()))
        if sig not in seen:
            seen.add(sig)
            out.append(c)
    return out


def _runnable(cands: list[dict], plan) -> list[dict]:
    """The candidates (the first, the default, kept) that ``plan(**c)``,
    the wrapper's own check, does not refuse; without duplicates."""
    out = cands[:1]
    for c in cands[1:]:
        try:
            plan(**c)
        except ValueError:
            continue
        out.append(c)
    return _dedup_keep_order(out)


def default_fused_dense(rows: int, d_in: int, d_out: int) -> dict:
    """``fused_dense_cuda``'s tile without a knob (``fused_dense.plan``)."""
    return dict(zip(("bm", "bn"), _dense.tile(_dense.plan(rows, d_out))))


def fused_dense_candidates(rows: int, d_in: int, d_out: int) -> list[dict]:
    """The default, then every tile of the f32 kernel whose shared
    memory fits at K = d_in."""
    return _dedup_keep_order(
        [default_fused_dense(rows, d_in, d_out)]
        + [dict(zip(("bm", "bn"), _dense.tile(v)))
           for v in _dense.BY_SIZE
           if _dense.smem_bytes(v, d_in) <= _build.SMEM_LIMIT])


def default_fused_dense_int8(rows: int, d_in: int, d_out: int) -> dict:
    """``fused_dense_int8_cuda``'s tile without a knob: 32 x 16."""
    return dict(zip(("bm", "bn"), _dense.INT8_TILES[0]))


def fused_dense_int8_candidates(rows: int, d_in: int,
                                d_out: int) -> list[dict]:
    """The int8 kernel's tiles, the default first (its CTAs' shared
    memory is static, 11 KB at most)."""
    return [dict(zip(("bm", "bn"), t)) for t in _dense.INT8_TILES]


def _rows_candidates(n: int, default: dict, cell: str, plan) -> list[dict]:
    return _runnable([default] + [{"bm": min(b, n)} for b in ROWS[cell]],
                     plan)


def default_gravnet(n: int, batch: int = 1, *, d_f: int) -> dict:
    return {"bm": _gravnet.plan(n, batch, d_f)[0]}


def gravnet_candidates(n: int, *, batch: int = 1, d_f: int) -> list[dict]:
    """The default, then 4, 8 or 16 rows a CTA cut to n on the register
    cell, 8, 16 or 32 on the shared-memory cell."""
    return _rows_candidates(
        n, default_gravnet(n, batch, d_f=d_f),
        _gravnet.plan(n, batch, d_f)[1],
        lambda bm: _gravnet.plan(n, batch, d_f, bm))


def default_gravnet_block(n: int, batch: int = 1, *, d_hidden: int,
                          d_s: int, d_f: int, d_out: int,
                          concat_x: bool = True) -> dict:
    return {"bm": _block.plan(n, d_hidden, d_s, d_f, d_out, concat_x)[0]}


def gravnet_block_candidates(n: int, d_hidden: int, d_f: int, d_out: int,
                             *, d_s: int, concat_x: bool = True,
                             batch: int = 1) -> list[dict]:
    """The default, then 4, 8 or 16 rows cut to n on the register cell;
    where the shape needs the shared-memory cell, its 32 rows alone."""
    default = default_gravnet_block(n, batch, d_hidden=d_hidden, d_s=d_s,
                                    d_f=d_f, d_out=d_out, concat_x=concat_x)
    if _block.plan(n, d_hidden, d_s, d_f, d_out, concat_x)[1] == "shared":
        return [default]
    return _rows_candidates(
        n, default, "register",
        lambda bm: _block.plan(n, d_hidden, d_s, d_f, d_out, concat_x, bm))


def default_gravnet_block_int8(n: int, batch: int = 1) -> dict:
    return {"bm": min(n, _block.BM_INT8)}


def gravnet_block_int8_candidates(n: int, d_hidden: int, d_f: int,
                                  d_out: int, *, d_s: int,
                                  concat_x: bool = True,
                                  batch: int = 1) -> list[dict]:
    """The default, then 4, 8 or 16 rows cut to n whose shared memory
    fits (the int8 block has one cell)."""
    return _rows_candidates(
        n, default_gravnet_block_int8(n, batch), "register",
        lambda bm: _block.int8_plan(n, d_hidden, d_s, d_f, d_out, concat_x,
                                    bm))


def gravnet_block_ragged_candidates(n: int, *, batch: int = 1,
                                    d_f: int) -> list[dict]:
    """A raggedized block launches the kNN pair (``ops.gravnet_block_
    ragged``) with one bm: the untuned launch first, then the rows both
    kNN kernels take. Where the two kernels' own plans agree (d_f <= 128:
    both on the register cell) that common bm is the untuned launch;
    where they differ (past d_f 128 the aggregation's shared-memory
    cell), the untuned launch is ``{}``, no knob: each kernel runs its
    own plan."""
    build = knn_build_candidates(n, batch=batch)
    agg = knn_aggregate_candidates(n, batch=batch, d_f=d_f)
    common = [c for c in build if c in agg]
    return common if build[0] == agg[0] else [{}] + common


def default_edge_aggregate(n: int, e: int, batch: int = 1, *,
                           d: int) -> dict:
    return dict(zip(("bm", "bn"), _edge.plan(n, d, batch)))


def edge_aggregate_candidates(n: int, e: int, *, d: int,
                              batch: int = 1) -> list[dict]:
    """The default, then the kernel's (rows, columns) tiles cut to (n,
    d)."""
    return _runnable(
        [default_edge_aggregate(n, e, batch, d=d)]
        + [{"bm": min(bm, n), "bn": min(cw, d)} for bm, cw in _edge.TILES],
        lambda bm, bn: _edge.plan(n, d, batch, bm, bn))


def default_knn_build(n: int, batch: int = 1) -> dict:
    return {"bm": _knn.build_plan(n, batch)[0]}


def knn_build_candidates(n: int, *, batch: int = 1) -> list[dict]:
    return _rows_candidates(n, default_knn_build(n, batch),
                            _knn.build_plan(n, batch)[1],
                            lambda bm: _knn.build_plan(n, batch, bm))


def default_knn_aggregate(n: int, batch: int = 1, *, d_f: int) -> dict:
    return {"bm": _knn.aggregate_plan(n, batch, d_f)[0]}


def knn_aggregate_candidates(n: int, *, batch: int = 1,
                             d_f: int) -> list[dict]:
    return _rows_candidates(
        n, default_knn_aggregate(n, batch, d_f=d_f),
        _knn.aggregate_plan(n, batch, d_f)[1],
        lambda bm: _knn.aggregate_plan(n, batch, d_f, bm))


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


def among(config: dict, cands: list[dict]) -> bool:
    """Whether ``config`` (a cached entry, which may carry replay dims
    and the reference's annotations beside its knobs) names one of
    ``cands``: every knob the candidates name equal to some candidate's,
    a knob the candidate leaves out absent from ``config`` (so ``{}``,
    the untuned launch, names only an entry without those knobs)."""
    knobs = {k for c in cands for k in c}
    return any(all(config.get(k) == c.get(k) for k in knobs) for c in cands)
