"""The ragged kNN pair's plain versions against the JAX package on the
inputs that stress the kernels' designs (``kernels/f32_cases.py``'s kNN
cases), a numpy model of the selection ``csrc/knn_build.cu`` runs, and
both kernels' plans, on the CPU.

``knn_build_ref`` and ``knn_aggregate_ref`` are what ``chip_smoke.py``
holds ``csrc/knn_build.cu`` and ``csrc/knn_aggregate.cu`` to, bitwise,
on the card; here they meet ``repro.kernels.ops.knn_build_batched`` and
``knn_aggregate_batched`` (the jnp reference and the Pallas kernel in
interpret mode) on the same numpy inputs: ``idx`` bitwise, ``d2``
bitwise where every distance is exact (s on a dyadic grid), else within
the float32 row (there the draws keep each row's k-th and (k+1)-th
distances far apart, so both packages choose the same neighbours), the
aggregation within the float32 row. The selection model keeps a row's
distances as the kernel does — 32 lanes of columns j = lane + 32c, the
distances' bits as keys — and takes per round the smallest key, then
the lowest column holding it, and knocks it out; it must give the plain
version's bits, spent slots included.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _numerics import assert_bitwise, assert_close

from repro.kernels import ops as jops
from repro_torch.kernels import _build, f32_cases
from repro_torch.kernels import knn_build as kmod
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

BACKENDS = ("xla", "pallas_interpret")
CASES = sorted(f32_cases.KNN_CASES)
BIG = np.float32(1e30)


def _t(a):
    return torch.from_numpy(np.array(a))


def _build_case(case):
    bins, n, ds, df, k, values, dup, corrupted = f32_cases.KNN_CASES[case]
    s, seg = f32_cases.knn_build_inputs(bins, n, ds, k, values, dup,
                                        seed=len(case))
    return s, seg, k, values


def _aggregate_case(case):
    bins, n, ds, df, k, values, dup, corrupted = f32_cases.KNN_CASES[case]
    s, seg, k, _ = _build_case(case)
    idx, d2 = tref.knn_build_ref(_t(s), _t(seg), k=k)
    f, idx = f32_cases.knn_aggregate_inputs(idx.numpy(), n, df, corrupted,
                                            seed=len(case))
    return f, idx, d2.numpy()


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", CASES)
def test_build_plain_version_matches_jax(case, backend):
    s, seg, k, values = _build_case(case)
    widx, wd2 = (np.asarray(a) for a in jops.knn_build_batched(
        jnp.asarray(s), jnp.asarray(seg), k=k, backend=backend))
    idx, d2 = tref.knn_build_ref(_t(s), _t(seg), k=k)
    assert idx.dtype == torch.int32 and d2.dtype == torch.float32
    assert_bitwise(idx.numpy(), widx, context=f"{backend} idx")
    if values == "separated":
        assert_close(d2.numpy(), wd2, dtype="float32", context=backend)
    else:                      # every distance exact in both packages
        assert_bitwise(d2.numpy(), wd2, context=f"{backend} d2")
    before = kmod.knn_build_cuda.launches
    gidx, gd2 = tops.knn_build_batched(_t(s), _t(seg), k=k)
    assert_bitwise(gidx.numpy(), idx.numpy())
    assert_bitwise(gd2.numpy(), d2.numpy())
    assert kmod.knn_build_cuda.launches == before


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", CASES)
def test_aggregate_plain_version_matches_jax(case, backend):
    f, idx, d2 = _aggregate_case(case)
    want = np.asarray(jops.knn_aggregate_batched(
        jnp.asarray(f), jnp.asarray(idx), jnp.asarray(d2), backend=backend))
    got = tref.knn_aggregate_ref(_t(f), _t(idx), _t(d2))
    assert got.shape == want.shape == (*f.shape[:2], 2 * f.shape[2])
    rows = np.ones(idx.shape[:2], bool)
    if backend == "xla":
        # the jnp reference reads an index outside [0, n) as jnp.take
        # does (NaN past n, negative ones from the end); the TPU kernel,
        # the port's plain version and its kernel select a row of zeros
        # (a one-hot product): held on the rows whose indices all lie in
        # [0, n)
        rows = ((idx >= 0) & (idx < idx.shape[1])).all(axis=2)
        assert rows.any()
    assert_close(got.numpy()[rows], want[rows], dtype="float32",
                 context=backend)
    before = kmod.knn_aggregate_cuda.launches
    assert_bitwise(tops.knn_aggregate_batched(_t(f), _t(idx),
                                              _t(d2)).numpy(), got.numpy())
    assert kmod.knn_aggregate_cuda.launches == before


def _key(v):
    """The kernel's key of a non-negative distance: its bits, -0 as
    +0."""
    u = v.astype(np.float32).view(np.uint32)
    return np.where(u == np.uint32(0x80000000), np.uint32(0), u)


def select_model(s, seg, k):
    """The selection of ``csrc/knn_build.cu``'s register cell in numpy:
    lane l holds the columns j = l + 32c as keys (1e30's bits where j is
    no candidate, 0xffffffff past n), |s|² and the dot summed over d in
    order in float32; a round takes the smallest key over the lanes'
    minima, then the lowest column holding it, and the owning lane
    knocks that column out to 1e30. s:(B,n,ds) f32, seg:(B,n) ->
    (idx:(B,n,k) int32, d2:(B,n,k) f32)."""
    bsz, n, ds = s.shape
    cpl = -(-n // 32)
    col = np.arange(32 * cpl).reshape(cpl, 32)          # [c, lane] -> j
    sp = np.zeros((bsz, 32 * cpl, ds), np.float32)
    sp[:, :n] = s
    sq = np.zeros((bsz, 32 * cpl), np.float32)
    dot = np.zeros((bsz, n, 32 * cpl), np.float32)
    for q in range(ds):
        sq = sq + sp[:, :, q] * sp[:, :, q]
        dot = dot + s[:, :, None, q] * sp[:, None, :, q]
    v = np.maximum((sq[:, :n, None] + sq[:, None, :]) - np.float32(2) * dot,
                   np.float32(0))
    segp = np.full((bsz, 32 * cpl), -1, np.int64)
    segp[:, :n] = seg
    j = np.arange(32 * cpl)
    valid = ((segp[:, None, :] == seg[:, :, None])
             & (j[None, None, :] != np.arange(n)[None, :, None])
             & (segp[:, None, :] >= 0))
    keys = np.where(valid, _key(v), _key(np.asarray(BIG)))
    keys = np.where(j[None, None, :] < n, keys, np.uint32(0xffffffff))
    keys = keys[..., col]                               # (B, n, cpl, 32)
    idx = np.zeros((bsz, n, k), np.int32)
    d2 = np.zeros((bsz, n, k), np.float32)
    rows = np.indices((bsz, n))
    for t in range(k):
        lv = keys.min(axis=2)                           # each lane's min
        lc = np.where(keys == lv[:, :, None, :], col[None, None],
                      1 << 30).min(axis=2)              # its lowest column
        m = lv.min(axis=2)
        jstar = np.where(lv == m[..., None], lc, 1 << 30).min(axis=2)
        idx[..., t] = jstar
        d2[..., t] = m.view(np.float32)
        keys[rows[0], rows[1], jstar >> 5, jstar & 31] = _key(np.asarray(BIG))
    return idx, d2


@pytest.mark.parametrize("case", CASES)
def test_selection_model_matches_plain_version(case):
    s, seg, k, _ = _build_case(case)
    idx, d2 = tref.knn_build_ref(_t(s), _t(seg), k=k)
    midx, md2 = select_model(s, seg, k)
    assert_bitwise(midx, idx.numpy(), context="idx")
    assert_bitwise(md2, d2.numpy(), context="d2")


@pytest.mark.parametrize("case", CASES)
def test_each_case_holds_what_it_names(case):
    """Every spent slot is (0, 1e30) — padding rows' and one-hit events'
    every slot among them; the coincident rows give d2 = +0 exactly;
    coarse values tie; bins hold 1–3 events; corrupted indices leave
    [0, n) both ways."""
    bins, n, ds, df, k, values, dup, corrupted = f32_cases.KNN_CASES[case]
    s, seg, k, _ = _build_case(case)
    idx, d2 = (a.numpy() for a in tref.knn_build_ref(_t(s), _t(seg), k=k))
    spent = d2 == BIG
    assert (idx[spent] == 0).all() and spent[seg < 0].all()
    assert spent.any()
    sizes = [c for b in bins for c in b]
    if 1 in sizes:
        rows = np.isin(seg, [e for e, c in enumerate(sizes) if c == 1])
        assert spent[rows].all()
    if () in bins:
        assert (seg[list(bins).index(())] < 0).all()
    if dup:
        assert (d2 == 0).any()
        assert not np.signbit(d2[d2 == 0]).any()
    if values == "coarse":
        row = d2[:, :, :-1][~spent[:, :, 1:]]
        assert (row == d2[:, :, 1:][~spent[:, :, 1:]]).any()
    if case.startswith("occupancy"):
        assert all(1 <= len(b) <= 3 for b in bins)
        assert set(sizes) == {1, 33, 65, 97}
    if corrupted:
        _, cidx, _ = _aggregate_case(case)
        assert (cidx < 0).any() and (cidx >= n).any()
    assert all(sum(b) <= n for b in bins)


def test_plans_at_the_paths_shapes():
    """The ragged path's 8 bins of 128 rows: 8 rows a CTA on the
    register cell, 128 CTAs; one bin: 4 rows, 32 CTAs; 16 bins: 16 rows;
    past 512 rows (the build) or d_f 128 (the aggregation), the first
    designs' 32 rows on the shared-memory cell."""
    for bsz, bm in ((1, 4), (8, 8), (16, 16)):
        assert kmod.build_plan(128, bsz) == (bm, "register")
        assert kmod.aggregate_plan(128, bsz, 22) == (bm, "register")
    assert kmod.build_plan(512, 2) == (8, "register")
    assert kmod.build_plan(600, 2) == (32, "shared")
    assert kmod.aggregate_plan(600, 2, 22) == (16, "register")
    assert kmod.aggregate_plan(128, 2, 129) == (32, "shared")
    assert kmod.build_plan(1, 8) == (1, "register")
    assert kmod.build_smem_bytes(128, 4) == 4 * (512 + 128)
    assert kmod.aggregate_smem_bytes(128, 22) == 0


@pytest.mark.parametrize("case", CASES)
def test_each_case_takes_the_cell_its_shape_allows(case):
    """The build on the register cell up to 512 rows (16 candidates a
    lane), the aggregation up to d_f 128 (4 columns a lane); every case
    fits the card's shared memory on its cell, and a CTA holds at most
    16 warps on the register cell."""
    bins, n, ds, df, k, _, _, _ = f32_cases.KNN_CASES[case]
    for bsz in sorted({1, len(bins), 8, 16}):
        for (bm, cell), reg in ((kmod.build_plan(n, bsz), n <= 512),
                                (kmod.aggregate_plan(n, bsz, df),
                                 df <= 128)):
            assert cell == ("register" if reg else "shared")
            assert 1 <= bm <= (min(n, 16) if reg else min(n, 32))
            if reg and bm < min(n, 16):   # smaller CTAs only to fill it
                assert -(-n // bm) * bsz <= 132
    assert kmod.build_smem_bytes(n, ds) <= _build.SMEM_LIMIT
    assert kmod.aggregate_smem_bytes(n, df) <= _build.SMEM_LIMIT
    assert ("past_the_register" in case) == (n > 512 or df > 128)


def _first_design_smem(n, ds, df):
    """Bytes of shared memory the first designs' CTAs asked for: S,
    |s|², the segment ids and 8 warps' distance rows (the build); F, a
    row of zeros and 8 warps' output rows (the aggregation). Their
    wrappers took a shape where it was at most the card's 227 KB."""
    return 4 * (n * (ds + 2) + 8 * n), 4 * ((n + 1) * df + 16 * df)


@pytest.mark.parametrize("widths", [(4, 22), (3, 8), (12, 129), (1, 1),
                                    (8, 128), (64, 300)])
def test_no_shape_the_first_designs_took_is_refused(widths):
    """Over row counts from 1 to past the register cell: where a first
    design fitted the card, the new plan fits it too, and wherever the
    launch leaves the register cell its shared memory is the first
    design's."""
    ds, df = widths
    for n in [*range(1, 70), *range(70, 4000, 13)]:
        old_build, old_agg = _first_design_smem(n, ds, df)
        if old_build <= _build.SMEM_LIMIT:
            assert kmod.build_smem_bytes(n, ds) <= _build.SMEM_LIMIT
        if old_agg <= _build.SMEM_LIMIT:
            assert kmod.aggregate_smem_bytes(n, df) <= _build.SMEM_LIMIT
        if kmod.build_plan(n)[1] == "shared":
            assert kmod.build_smem_bytes(n, ds) == old_build
        if kmod.aggregate_plan(n, 1, df)[1] == "shared":
            assert kmod.aggregate_smem_bytes(n, df) == old_agg
