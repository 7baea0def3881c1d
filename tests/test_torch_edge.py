"""The port's edge aggregation (``kernels/ref.py:edge_aggregate_ref`` and
the ``kernels/ops.py`` entry points on CPU tensors) against the JAX
package's ``ops.edge_aggregate`` / ``edge_aggregate_batched``, run as
the Pallas body in interpret mode and through its jnp reference, on the
same numpy inputs; the plain version's order of summation against a
loop over the edges, also on ``kernels/f32_cases.py``'s edge inputs; and
a numpy replica of the kernel's counting sort and its launch plan. The
CUDA kernel is held against the plain version on the card by
``chip_smoke.py`` (phase 7).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _numerics import assert_bitwise, assert_close

from repro.kernels import ops as jops
from repro_torch.kernels import edge_aggregate as ea
from repro_torch.kernels import f32_cases
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.edge_aggregate import edge_aggregate_cuda

BACKENDS = ("xla", "pallas_interpret")
WIDTHS = (16, 32, 70, 128)      # the routes' and the published widths
N, E, B = 32, 128, 3            # tests/test_model_export.py's sizes


def _problem(d, *, seed, b=B, n=N, e=E):
    rng = np.random.default_rng(seed)
    msgs = rng.normal(size=(b, e, d)).astype(np.float32)
    ei = rng.integers(0, n, size=(b, 2, e)).astype(np.int32)
    mask = (rng.uniform(size=(b, e)) < 0.7).astype(np.float32)
    return msgs, ei, mask


def _jax(msgs, ei, n, mask, reduce, backend, batched=True):
    fn = jops.edge_aggregate_batched if batched else jops.edge_aggregate
    return np.asarray(fn(jnp.asarray(msgs), jnp.asarray(ei), n,
                         None if mask is None else jnp.asarray(mask),
                         reduce=reduce, backend=backend))


def _port(msgs, ei, n, mask, reduce, batched=True):
    fn = tops.edge_aggregate_batched if batched else tops.edge_aggregate
    return fn(torch.from_numpy(msgs), torch.from_numpy(ei), n,
              None if mask is None else torch.from_numpy(mask),
              reduce=reduce).numpy()


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("d", WIDTHS)
def test_batched_matches_jax(backend, reduce, d):
    msgs, ei, mask = _problem(d, seed=d)
    want = _jax(msgs, ei, N, mask, reduce, backend)
    got = _port(msgs, ei, N, mask, reduce)
    assert got.shape == (B, N, d)
    assert_close(got, want, dtype="float32", context=f"{backend}/{reduce}")


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_single_graph_and_none_mask_match_jax(backend, reduce):
    """``edge_aggregate`` (one graph, the batched kernel at B = 1) with
    no mask, on a node count and edge count that fill no tile."""
    msgs, ei, _ = _problem(6, seed=3, b=1, n=50, e=90)
    want = _jax(msgs[0], ei[0], 50, None, reduce, backend, batched=False)
    got = _port(msgs[0], ei[0], 50, None, reduce, batched=False)
    assert_close(got, want, dtype="float32", context=f"{backend}/{reduce}")


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_padded_edges_contribute_nothing(backend, reduce):
    """Padded edges point at node 0 with mask 0, as the model zoo pads
    its edge lists: node 0 gets neither their messages nor their count,
    and the result equals the unpadded graph's."""
    msgs, ei, mask = _problem(32, seed=5)
    pad = 40
    msgs_p = np.concatenate([msgs, 1e3 * np.ones((B, pad, 32), np.float32)],
                            axis=1)
    ei_p = np.concatenate([ei, np.zeros((B, 2, pad), np.int32)], axis=2)
    mask_p = np.concatenate([mask, np.zeros((B, pad), np.float32)], axis=1)
    want = _jax(msgs_p, ei_p, N, mask_p, reduce, backend)
    got = _port(msgs_p, ei_p, N, mask_p, reduce)
    assert_close(got, want, dtype="float32", context=f"{backend}/{reduce}")
    assert_bitwise(got, _port(msgs, ei, N, mask, reduce))


@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_out_of_range_destinations_contribute_nothing(reduce):
    """A dst outside [0, N) is dropped, as the TPU kernel's one-hot rows
    drop it (held against the Pallas body)."""
    msgs, ei, mask = _problem(16, seed=7)
    ei[:, 1, ::5] = np.array([-1, N, N + 9, -40, 2 * N])[
        np.arange(ei[:, 1, ::5].size) % 5].reshape(B, -1)
    want = _jax(msgs, ei, N, mask, reduce, "pallas_interpret")
    got = _port(msgs, ei, N, mask, reduce)
    assert_close(got, want, dtype="float32", context=reduce)


@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_batched_equals_per_graph_loop(reduce):
    """Aggregation is block-diagonal over the micro-batch: each graph of
    the batched call equals the same graph alone, bitwise."""
    msgs, ei, mask = _problem(70, seed=9)
    got = _port(msgs, ei, N, mask, reduce)
    for b in range(B):
        assert_bitwise(got[b], _port(msgs[b], ei[b], N, mask[b], reduce,
                                     batched=False), context=f"graph {b}")


@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_plain_version_replays_the_kernels_order(reduce):
    """The plain version equals, bitwise, a loop over the edges in
    increasing order that adds each ``mask·msg`` product to its node
    (and, for mean, each mask to its node's count), rounding every
    product and sum to f32 — the kernel's order. Fractional masks and
    stray destinations included."""
    rng = np.random.default_rng(11)
    n, e, d = 12, 60, 5
    msgs = rng.normal(size=(2, e, d)).astype(np.float32)
    dst = rng.integers(-2, n + 2, size=(2, e)).astype(np.int32)
    mask = rng.choice(np.float32([0, 0.25, 0.5, 1, 1.5]), size=(2, e))
    got = tref.edge_aggregate_ref(torch.from_numpy(msgs),
                                  torch.from_numpy(dst),
                                  torch.from_numpy(mask), n_nodes=n,
                                  reduce=reduce)
    assert_bitwise(got.numpy(), _edge_loop(msgs, dst, mask, n, reduce))


def _edge_loop(msgs, dst, mask, n, reduce):
    """The kernel's order as a loop over the edges in increasing order:
    each ``mask·msg`` product added to its node (and, for mean, each mask
    to its node's count), every product and sum rounded to f32."""
    bsz, e, d = msgs.shape
    want = np.zeros((bsz, n, d), np.float32)
    cnt = np.zeros((bsz, n), np.float32)
    for b in range(bsz):
        for j in range(e):
            i = dst[b, j]
            if 0 <= i < n:
                want[b, i] = want[b, i] + mask[b, j] * msgs[b, j]
                cnt[b, i] = cnt[b, i] + mask[b, j]
    if reduce == "mean":
        want = want / np.maximum(cnt, np.float32(1))[..., None]
    return want


@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("case", sorted(f32_cases.EDGE_CASES))
def test_plain_version_on_the_kernels_edge_inputs(case, reduce):
    """On the inputs that stress the kernel's design
    (``kernels/f32_cases.py``: E from 1 to the largest a launch takes,
    one node taking every edge, every edge masked, every dst out of
    range, odd widths), the plain version equals the loop over the edges
    bitwise and the JAX package's jnp reference within the float32
    row."""
    bsz, e, d, kind = f32_cases.EDGE_CASES[case]
    msgs, dst, mask = f32_cases.edge_inputs(bsz, e or ea.max_edges(), d,
                                            kind, seed=len(case))
    n = f32_cases.EDGE_NODES
    got = tref.edge_aggregate_ref(torch.from_numpy(msgs),
                                  torch.from_numpy(dst),
                                  torch.from_numpy(mask), n_nodes=n,
                                  reduce=reduce).numpy()
    assert_bitwise(got, _edge_loop(msgs, dst, mask, n, reduce))
    ei = np.stack([np.zeros_like(dst), dst], axis=1)
    assert_close(got, _jax(msgs, ei, n, mask, reduce, "xla"),
                 dtype="float32", context=case)


def test_ops_route_cpu_tensors_to_plain_version():
    msgs, ei, mask = _problem(16, seed=13)
    before = edge_aggregate_cuda.launches
    got = _port(msgs, ei, N, mask, "mean")
    want = tref.edge_aggregate_ref(
        torch.from_numpy(msgs), torch.from_numpy(ei[:, 1]),
        torch.from_numpy(mask), n_nodes=N, reduce="mean")
    assert_bitwise(got, want.numpy())
    assert edge_aggregate_cuda.launches == before


def test_wrapper_refuses_cpu_tensors_and_unknown_reduce():
    """The kernel wrapper takes CUDA tensors only, never runs the plain
    version itself and counts no launch when it refuses; an unknown
    reduction raises everywhere."""
    msgs = torch.zeros(1, 8, 4)
    dst = torch.zeros(1, 8, dtype=torch.int32)
    mask = torch.ones(1, 8)
    before = edge_aggregate_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        edge_aggregate_cuda(msgs, dst, mask, n_nodes=4)
    with pytest.raises(ValueError, match="reduce"):
        edge_aggregate_cuda(msgs, dst, mask, n_nodes=4, reduce="max")
    with pytest.raises(ValueError, match="reduce"):
        tref.edge_aggregate_ref(msgs, dst, mask, n_nodes=4, reduce="max")
    assert edge_aggregate_cuda.launches == before


# ------------------------------------------------ the kernel's placement ----
WARPS, MAX_ROWS = 8, 64     # csrc/edge_aggregate.cu: kWarps, kMaxRows


def _kernel_placement(dst, row0, rows):
    """numpy replica of one CTA's counting sort in
    ``csrc/edge_aggregate.cu``: warp w owns the edges [w·span, (w+1)·span)
    and takes them 32 a round; a lane's group is the round's lanes of its
    row (``__match_any_sync``), its rank the warp's earlier edges of that
    row (tab[row][w] before the round) plus the group's lanes below it;
    warp 0 scans tab in (row, warp) order, lane l holding rows 2l and
    2l + 1; each edge lands at tab[row][w] + rank. Returns (perm, the
    rows' segment bounds)."""
    e_count = len(dst)
    key = np.where((dst >= row0) & (dst < row0 + rows), dst - row0, -1)
    span = -(-e_count // (32 * WARPS)) * 32
    tab = np.zeros(MAX_ROWS * WARPS + 4, np.int64)
    rank = np.zeros(e_count, np.int64)
    for w in range(WARPS):
        lo, hi = w * span, min((w + 1) * span, e_count)
        for base in range(lo, hi, 32):
            lanes = [key[e] if e < hi else -1 for e in range(base, base + 32)]
            for lane, k in enumerate(lanes):
                if k >= 0:
                    below = sum(lanes[j] == k for j in range(lane))
                    rank[base + lane] = tab[k * WARPS + w] + below
            for k in set(lanes) - {-1}:
                tab[k * WARPS + w] += lanes.count(k)
    counts = tab[:MAX_ROWS * WARPS].reshape(32, 16)   # lane: two rows
    lane_total = counts.sum(axis=1)
    base = np.cumsum(lane_total) - lane_total
    tab[:MAX_ROWS * WARPS] = (base[:, None] + np.cumsum(counts, axis=1)
                              - counts).ravel()
    tab[MAX_ROWS * WARPS] = lane_total.sum()
    perm = np.full(e_count, -1, np.int64)
    for e in range(e_count):
        if key[e] >= 0:
            perm[tab[key[e] * WARPS + e // span] + rank[e]] = e
    bounds = tab[np.arange(rows + 1) * WARPS]
    return perm, bounds


@pytest.mark.parametrize("e_count", [1, 31, 33, 100, 256, 257, 1000])
@pytest.mark.parametrize("n,row0,rows", [(64, 0, 64), (64, 16, 16),
                                         (100, 96, 4), (40, 32, 8)])
def test_kernel_placement_is_a_stable_sort(e_count, n, row0, rows):
    """The replica's placement equals a stable argsort of the CTA's
    in-range keys, and each row's segment holds its edges in increasing
    e: on random destinations with ids outside [0, n) and E not a
    multiple of 32."""
    rng = np.random.default_rng(e_count + n + row0)
    dst = rng.integers(-3, n + 3, size=e_count)
    perm, bounds = _kernel_placement(dst, row0, rows)
    mine = (dst >= row0) & (dst < row0 + rows)
    order = np.argsort(np.where(mine, dst, n + 9), kind="stable")
    total = int(mine.sum())
    assert bounds[-1] == total
    assert (perm[:total] == order[:total]).all() and (perm[total:] == -1).all()
    for r in range(rows):
        seg = perm[bounds[r]:bounds[r + 1]]
        assert (dst[seg] == row0 + r).all() and (np.diff(seg) > 0).all()
        assert len(seg) == int((dst == row0 + r).sum())


@pytest.mark.parametrize("e_count", [33, 1000])
def test_kernel_placement_one_node_takes_every_edge(e_count):
    dst = np.full(e_count, 5)
    perm, bounds = _kernel_placement(dst, 0, 64)
    assert (perm == np.arange(e_count)).all()
    assert bounds[5] == 0 and bounds[6] == e_count and bounds[-1] == e_count


def test_edge_plan_fits_and_tiles():
    """The plan's CTA tile cuts to the graph, keeps cw even where d is,
    stays one CTA per SM at the routes' shapes where a tile allows, and
    every edge count up to ``max_edges`` fits the card's shared memory
    (its message slice staged where it fits)."""
    from repro_torch.kernels import _build
    for bsz, d in [(1, 70), (8, 16), (8, 128), (16, 70), (1, 1), (16, 129)]:
        bm, cw = ea.plan(64, d, bsz)
        assert 1 <= bm <= ea.BM and 1 <= cw <= d and (d % 2 or cw % 2 == 0)
        if bsz <= 8:
            assert -(-d // cw) * -(-64 // bm) * bsz <= ea.FILL_CTAS
    assert ea.plan(64, 70, 1) == (16, 8)
    e_max = ea.max_edges()
    assert ea.smem_bytes(e_max, 8, False) <= _build.SMEM_LIMIT
    assert ea.smem_bytes(e_max + 1, 8, False) > _build.SMEM_LIMIT
    assert ea.staged(256, 8) and not ea.staged(e_max, 8)
