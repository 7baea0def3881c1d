"""The f32 GravNet kernels' plain versions against the JAX package on the
inputs that stress the kernels' designs (``kernels/f32_cases.py``), and
the kernels' plans, on the CPU.

``gravnet_block_ref`` and ``gravnet_aggregate_ref`` are what
``chip_smoke.py`` holds ``csrc/gravnet_block.cu`` and
``csrc/gravnet_aggregate.cu`` to, bitwise, on the card; here they meet
``repro.kernels.ops.gravnet_block_batched`` and
``gravnet_aggregate_batched`` (the jnp reference and the Pallas kernel
in interpret mode) on the same numpy inputs, within the float32 row. The
inputs put x, ws and bs (the aggregation's s) on dyadic grids, so that
every distance is exact in both packages and both choose the same
neighbours, ties included. :func:`plan` of each kernel picks its rows
per CTA and its cell; every shape the first designs took is still
taken.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _numerics import assert_bitwise, assert_close

from repro.kernels import ops as jops
from repro_torch.kernels import _build, f32_cases
from repro_torch.kernels import gravnet as gmod
from repro_torch.kernels import gravnet_block as bmod
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

BACKENDS = ("xla", "pallas_interpret")
CASES = sorted(f32_cases.GRAVNET_CASES)


def _t(a):
    return torch.from_numpy(np.array(a))


def _block_case(case):
    b, n, dh, ds, df, dout, k, nv, dup, masked = f32_cases.GRAVNET_CASES[
        case]
    ops = f32_cases.block_inputs(b, n, dh=dh, ds=ds, df=df, dout=dout,
                                 seed=len(case), n_valid=nv, dup=dup,
                                 masked_event=masked)
    return ops, k


def _aggregate_case(case):
    b, n, _, ds, df, _, k, nv, dup, masked = f32_cases.GRAVNET_CASES[case]
    ops = f32_cases.aggregate_inputs(b, n, ds=ds, df=df, seed=len(case),
                                     n_valid=nv, dup=dup,
                                     masked_event=masked)
    return ops, k


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", CASES)
def test_block_plain_version_matches_jax(case, backend):
    ops, k = _block_case(case)
    want = np.asarray(jops.gravnet_block_batched(
        *(jnp.asarray(a) for a in ops), k=k, backend=backend))
    targs = [_t(a) for a in ops]
    got = tref.gravnet_block_ref(*targs, k=k)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert_close(got.numpy(), want, dtype="float32", context=backend)
    before = bmod.gravnet_block_cuda.launches
    assert_bitwise(tops.gravnet_block_batched(*targs, k=k).numpy(),
                   got.numpy())
    assert bmod.gravnet_block_cuda.launches == before


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", CASES)
def test_aggregate_plain_version_matches_jax(case, backend):
    (s, f, mask), k = _aggregate_case(case)
    want = np.asarray(jops.gravnet_aggregate_batched(
        jnp.asarray(s), jnp.asarray(f), jnp.asarray(mask), k=k,
        backend=backend))
    got = tref.gravnet_aggregate_ref(_t(s), _t(f), _t(mask), k=k)
    assert got.shape == want.shape == (*s.shape[:2], 2 * f.shape[2])
    assert_close(got.numpy(), want, dtype="float32", context=backend)
    before = gmod.gravnet_aggregate_cuda.launches
    assert_bitwise(tops.gravnet_aggregate_batched(
        _t(s), _t(f), _t(mask), k=k).numpy(), got.numpy())
    assert gmod.gravnet_aggregate_cuda.launches == before


def _tied_slots(s, mask, k):
    """Slots of valid rows whose distance is exactly tied with another
    candidate's; asserts that each of the plain version's selections
    (knn_build_ref runs the cell's rounds) takes the lowest such
    column."""
    valid = mask > 0
    idx, d2 = tref.knn_build_ref(s, torch.where(valid, 0, -1), k=k)
    n = s.shape[1]
    col = torch.arange(n)
    full = torch.where(valid[:, None, :] & (col[None, :] != col[:, None]),
                       tref._pairwise_d2(s), tref.BIG)
    tied = 0
    for e, i in zip(*torch.nonzero(valid, as_tuple=True)):
        taken = []
        for slot in range(k):
            dmin = d2[e, i, slot]
            if dmin >= tref.BIG * 0.5:
                break
            same = [j for j in range(n)
                    if full[e, i, j] == dmin and j not in taken]
            tied += len(same) > 1
            assert int(idx[e, i, slot]) == min(same)
            taken.append(int(idx[e, i, slot]))
    return tied


@pytest.mark.parametrize("case", ["n17_ties", "ds1", "n128_all_masked_event"])
def test_ties_go_to_the_lowest_column(case):
    """The tie cases hold exact distance ties among a valid row's chosen
    slots (duplicated rows, and the grid), and the plain version takes
    the lowest column of each, as the kernels' cell does."""
    ops, k = _block_case(case)
    x, mask, ws, bs = (_t(a) for a in ops[:4])
    s = tref.fused_dense_ref(x, ws, bs, activation="none")
    assert _tied_slots(s, mask, k) > 0
    (s, _, mask), k = _aggregate_case(case)
    assert _tied_slots(_t(s), _t(mask), k) > 0


def test_plans_at_the_paths_shapes():
    """The fp chunk's block (2 events of 128 hits): 16 rows a CTA on the
    register cell, 16 CTAs; the unfused chunk's aggregation (1 event):
    4 rows a CTA, 32 CTAs; at 16 and 64 events, 16 rows; the current
    detector's 32 hits at 8 events: 4 rows, 64 CTAs."""
    assert bmod.plan(128, 64, 4, 22, 64) == (16, "register")
    assert bmod.plan(32, 64, 4, 22, 64) == (16, "register")
    assert gmod.plan(128, 1, 22) == (4, "register")
    assert gmod.plan(128, 16, 22) == (16, "register")
    assert gmod.plan(128, 64, 22) == (16, "register")
    assert gmod.plan(32, 8, 22) == (4, "register")
    assert gmod.plan(1, 2, 22) == (1, "register")


@pytest.mark.parametrize("case", CASES)
def test_each_case_takes_the_cell_its_shape_allows(case):
    """The register cell up to 512 hits and d_f 128 (16 candidates and 4
    feature columns a lane), the shared-memory cell past them; every
    case fits the card's shared memory on its cell, and an aggregation
    CTA holds at most 16 warps."""
    b, n, dh, ds, df, dout, _, _, _, _ = f32_cases.GRAVNET_CASES[case]
    reg = n <= 512 and df <= 128
    bm, cell = bmod.plan(n, dh, ds, df, dout)
    assert cell == ("register" if reg else "shared")
    assert bm == min(n, 16 if reg else 32)
    assert bmod.smem_bytes(n, dh, ds, df, dout, bm,
                           cell) <= _build.SMEM_LIMIT
    for bsz in sorted({1, b, 16, 64}):
        bm, cell = gmod.plan(n, bsz, df)
        assert cell == ("register" if reg else "shared")
        assert 1 <= bm <= (min(n, 16) if reg else min(n, 32))
        if reg and bm < min(n, 16):   # a smaller CTA only to fill the card
            assert -(-n // bm) * bsz <= gmod.FILL_CTAS
    assert gmod.smem_bytes(n, ds, df) <= _build.SMEM_LIMIT
    assert ("past_the_register_cell" in case) == (not reg)


def _first_design_smem(n, dh, ds, df, dout):
    """Bytes of shared memory the first designs' CTAs asked for (x, S, F,
    |s|², mask, the weights, 32 rows of the aggregate and 8 warps'
    distance rows for the block; S, F, |s|², mask and 8 warps' output and
    distance rows for the aggregation); their wrappers took a shape where
    it was at most the card's 227 KB."""
    bm = min(n, 32)
    block = 4 * (n * (dh + ds + df + 2) + dh * (ds + df) + ds + df
                 + (dh + 2 * df) * dout + dout + bm * 2 * df + 8 * n)
    agg = 4 * (n * (ds + df + 2) + 16 * df + 8 * n)
    return block, agg


@pytest.mark.parametrize("widths", [
    (64, 4, 22, 64), (24, 3, 8, 24), (32, 9, 129, 32), (16, 1, 1, 7),
    (128, 4, 64, 128), (256, 8, 128, 16)])
def test_no_shape_the_first_designs_took_is_refused(widths):
    """Over hit counts from 1 to past both first designs' limits: where
    the first design fitted the card, the new plan fits it too (its
    shared memory is at most the first design's wherever it leaves the
    register cell, and the shared-memory cell is the first design)."""
    dh, ds, df, dout = widths
    for n in [*range(1, 70), *range(70, 2000, 13)]:
        old_block, old_agg = _first_design_smem(n, dh, ds, df, dout)
        bm, cell = bmod.plan(n, dh, ds, df, dout)
        new_block = bmod.smem_bytes(n, dh, ds, df, dout, bm, cell)
        if old_block <= _build.SMEM_LIMIT:
            assert new_block <= _build.SMEM_LIMIT, (n, widths)
        if cell == "shared":
            assert new_block == old_block
        if old_agg <= _build.SMEM_LIMIT:
            assert gmod.smem_bytes(n, ds, df) <= _build.SMEM_LIMIT
        if n > 512 or df > 128:
            assert gmod.smem_bytes(n, ds, df) == old_agg


def test_wrappers_refuse_where_the_first_designs_refused():
    """A shape past the card's shared memory on both cells raises before
    any launch, naming the plan; the block at the served widths takes
    500 hits on the register cell (the first design refused it)."""
    assert bmod.plan(500, 64, 4, 22, 64) == (16, "register")
    assert _first_design_smem(500, 64, 4, 22, 64)[0] > _build.SMEM_LIMIT
    bm, cell = bmod.plan(2000, 64, 4, 22, 64)
    assert (bm, cell) == (32, "shared")
    assert bmod.smem_bytes(2000, 64, 4, 22, 64, bm,
                           cell) > _build.SMEM_LIMIT
