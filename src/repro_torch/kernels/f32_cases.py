"""Inputs that stress the f32 dense and the edge aggregation kernels'
designs, made with numpy from a seed.

``csrc/fused_dense.cu`` tiles its output by the shape's plan
(``kernels/fused_dense.py:plan``), stages K whole up to 256 and walks a
longer K in double-buffered slabs, copies 16, 8 or 4 bytes as the
operands' alignment allows and reads x through a row stride. So the
dense cases span K from 1 past the staging limit, N from 1 to past two
tiles, M from 1 to 4096, row-strided x (a column slice of a wider
matrix, as the executor reads a lane-padded input), with and without
bias, relu and none. ``csrc/edge_aggregate.cu`` counting-sorts each
event's edges by destination in shared memory, 32 edges a warp round,
and stages a column slice of the messages where it fits. So the edge
cases span E from 1 to past 32 edges a warp and past the staged plans,
one node receiving every edge, every edge masked, every destination out
of range, widths 1 to 129 (odd and even), sum and mean over fractional
masks, and 1, 8 and 16 graphs. ``csrc/gravnet_block.cu`` and
``csrc/gravnet_aggregate.cu`` keep a query row's distances in registers,
32 candidates to a round of lanes and 32 feature columns to a register,
up to 512 hits and d_f 128 (past them, the shared-memory cell), break
ties on the distance's bits and tile the block's S/F and output dense by
registers. So the GravNet cases span exact distance ties (duplicated
rows), hit counts from 1 to past 512, fewer valid hits than k, an
all-masked event, k past n, d_s 1 and 9, d_f 1, 33, 128 and 129, and 1
to 64 events. ``csrc/knn_build.cu`` runs the selection half of that
cell over bins of packed events, with a segment predicate where the cell
has its mask, and ``csrc/knn_aggregate.cu`` its accumulation half fed
(idx, d2), the selected rows read from device memory. So the kNN cases
span bins of 1 to 3 events at occupancies 33, 65 and 97, a one-hit
event (every slot spent), events with fewer than k + 1 hits, an
all-padding bin, coincident rows (d2 = 0), exact distance ties, 40 to
600 rows a bin (past the register cell), d_s 3 and 12, d_f 22 and 129,
indices out of range and negative, k past the 32 slots a warp holds at
once, and draws whose k-th and (k+1)-th distances lie far apart. ``tests/test_torch_dense.py``,
``tests/test_torch_edge.py``, ``tests/test_torch_gravnet_f32.py`` and
``tests/test_torch_knn.py`` hold the plain versions and plans on these
inputs on the CPU, and ``chip_smoke.py`` holds the kernels against the
plain versions on the card, bitwise.
"""
from __future__ import annotations

import numpy as np

#: name -> (M, K, N, x's row stride or None for contiguous, activation,
#: bias)
DENSE_CASES = {
    "m1_k1_n1": (1, 1, 1, None, "relu", True),
    "k4_n2_no_bias": (63, 4, 2, None, "none", False),
    "own_k70_of_128": (64, 70, 70, 128, "relu", True),
    "k128_n5": (256, 128, 5, None, "none", True),
    "k256_n7_no_bias": (1024, 256, 7, None, "relu", False),
    "own_k70_of_128_n140": (4096, 70, 140, 128, "relu", True),
    "k300_past_staging": (63, 300, 257, None, "none", True),
    "k512_two_slabs": (256, 512, 70, None, "relu", True),
    "k512_n1_no_bias": (4096, 512, 1, None, "none", False),
    "one_row_k256": (1, 256, 140, None, "relu", True),
    "k4_n257_no_bias": (64, 4, 257, None, "relu", False),
    "k1_n70": (1024, 1, 70, None, "none", True),
    "own_k70_of_128_n2": (256, 70, 2, 128, "none", True),
    "k128_n257": (4096, 128, 257, None, "relu", True),
}

#: name -> (graphs, edges, width, kind): kind "random" has 1 in 16
#: destinations out of range and 1 in 16 masks at 0.5, the rest 0 or 1;
#: "max" is random at the largest edge count a launch takes (filled in
#: by ``edge_inputs``' caller from ``edge_aggregate.max_edges``)
EDGE_CASES = {
    "e1_d1": (1, 1, 1, "random"),
    "e31_d2": (8, 31, 2, "random"),
    "e33_d129": (16, 33, 129, "random"),
    "e256_d16": (8, 256, 16, "random"),
    "e1000_d70": (8, 1000, 70, "random"),
    "e1000_d128": (1, 1000, 128, "random"),
    "one_node_takes_every_edge": (1, 1000, 70, "one_node"),
    "every_edge_masked": (8, 256, 16, "masked"),
    "every_dst_out_of_range": (16, 256, 128, "out_of_range"),
    "largest_e": (1, None, 16, "random"),
    # past two launches' worth of edges (a launch takes 14,399 on the
    # H100): three chunks, each continuing the sums of the one before
    "past_one_launch": (2, 30000, 70, "random"),
}
#: nodes per graph of the edge cases: the serve routes' graphs
EDGE_NODES = 64


def dense_inputs(m, kdim, n, *, ldx=None, bias=True, seed):
    """(x, w, b) for a (m, kdim) -> n dense: x is the first kdim columns
    of an (m, ldx) matrix when ``ldx`` is given (index it ``[:, :kdim]``
    after moving it; returned whole here), w scaled by 1/√K, b None
    without bias. float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, ldx or kdim)).astype(np.float32)
    w = (rng.normal(size=(kdim, n)) / np.sqrt(max(kdim, 1))).astype(
        np.float32)
    b = rng.normal(size=(n,)).astype(np.float32) if bias else None
    return x, w, b


def edge_inputs(bsz, e, d, kind, *, n=EDGE_NODES, seed):
    """(messages (B,E,d) f32, dst (B,E) int32, mask (B,E) f32) of kind
    ``random``, ``one_node`` (every edge into node 5), ``masked`` (every
    mask 0) or ``out_of_range`` (every dst in {-3, -1, n, n + 7})."""
    rng = np.random.default_rng(seed)
    msg = rng.normal(size=(bsz, e, d)).astype(np.float32)
    dst = rng.integers(0, n, size=(bsz, e)).astype(np.int32)
    mask = (rng.uniform(size=(bsz, e)) < 0.7).astype(np.float32)
    dst[:, ::16] = np.array([-1, n, n + 5, -n], np.int32)[
        np.arange(dst[:, ::16].size) % 4].reshape(bsz, -1)
    mask[:, 1::16] = 0.5
    if kind == "one_node":
        dst[:] = 5
    elif kind == "masked":
        mask[:] = 0.0
    elif kind == "out_of_range":
        dst[:] = np.array([-3, -1, n, n + 7], np.int32)[
            rng.integers(0, 4, size=(bsz, e))]
    elif kind != "random":
        raise ValueError(f"edge_inputs: kind {kind!r}")
    return msg, dst, mask


#: name -> (events, hits, d_hidden, d_s, d_f, d_out, k, valid hits or
#: None, duplicated rows, masked event or None): the GravNet edge cases.
#: The block reads all of them; the aggregation reads (events, hits,
#: d_s, d_f, k, valid, duplicates, masked event). The one past 512 hits
#: takes the smoke config's widths (repro/configs/caloclusternet.py),
#: where the block's first design also took it.
GRAVNET_CASES = {
    "n1_k_past_n": (2, 1, 64, 4, 22, 64, 8, None, 0, None),
    "n5_k_past_n": (2, 5, 24, 3, 8, 24, 8, None, 0, None),
    "n17_ties": (2, 17, 64, 4, 22, 64, 8, None, 6, None),
    "n32_b64": (64, 32, 64, 4, 22, 64, 8, 24, 2, None),
    "n50_fewer_valid_than_k": (3, 50, 64, 4, 22, 64, 8, 5, 0, None),
    "n128_all_masked_event": (2, 128, 64, 4, 22, 64, 8, 96, 4, 1),
    "n128_b16": (16, 128, 64, 4, 22, 64, 8, 96, 0, None),
    "n500": (1, 500, 64, 4, 22, 64, 8, 450, 3, None),
    "n512": (1, 512, 32, 4, 22, 32, 8, None, 0, None),
    "n600_past_the_register_cell": (1, 600, 24, 3, 8, 24, 4, 590, 2, None),
    "ds1": (2, 64, 32, 1, 22, 32, 8, None, 4, None),
    "ds9": (2, 64, 32, 9, 22, 32, 8, 60, 0, None),
    "df1": (2, 40, 32, 4, 1, 32, 8, None, 0, None),
    "df33": (2, 64, 32, 4, 33, 32, 8, None, 2, None),
    "df128": (2, 64, 32, 4, 128, 32, 8, None, 0, None),
    "df129_past_the_register_cell": (2, 64, 32, 4, 129, 32, 8, None, 0,
                                     None),
}


def _valid_rows(b, n, n_valid, dup, masked_event):
    """mask (B,n): rows at or past ``n_valid`` are padding, every row of
    ``masked_event`` is masked (its features stay); the number of valid
    rows; and the (source, copy) pairs of ``dup`` duplicated valid rows,
    half spread over the event and half next to their source."""
    nv = n if n_valid is None else n_valid
    mask = np.ones((b, n), np.float32)
    mask[:, nv:] = 0.0
    if masked_event is not None:
        mask[masked_event] = 0.0
    pairs = []
    for d in range(dup):
        src = d % max(nv // 2, 1)
        dst = src + 1 if d % 2 else nv - 1 - d // 2
        if dst < nv and dst != src:
            pairs.append((src, dst))
    return mask, nv, pairs


def block_inputs(b, n, *, dh, ds, df, dout, seed, n_valid=None, dup=0,
                 masked_event=None):
    """Operands of the f32 GravNet block: (x, mask, ws, bs, wf, bf, wo,
    bo), float32 numpy arrays at the model's scales (LeCun-normal
    weights, x a relu output, padding rows zero).

    x, ws and bs lie on dyadic grids (x in steps of 1/4, ws and bs of
    1/16 and 1/64), so S = x @ ws + bs, |s|² and every distance are
    exact in float32 whatever the order of summation: any two
    implementations choose the same neighbours, and exact ties (many, on
    such a grid) go to the lowest column in both. F, the output dense
    and the Gaussian weights round as the implementations do."""
    rng = np.random.default_rng(seed)
    mask, nv, pairs = _valid_rows(b, n, n_valid, dup, masked_event)
    x = np.round(np.maximum(rng.normal(size=(b, n, dh)), 0.0) * 4) / 4
    x[:, nv:] = 0.0
    for src, dst in pairs:
        x[:, dst] = x[:, src]
    ws = np.round(rng.normal(size=(dh, ds)) / np.sqrt(dh) * 16) / 16
    bs = np.round(rng.normal(size=(ds,)) * 0.1 * 64) / 64
    wf = rng.normal(size=(dh, df)) / np.sqrt(dh)
    bf = rng.normal(size=(df,)) * 0.1
    wo = rng.normal(size=(dh + 2 * df, dout)) / np.sqrt(dh + 2 * df)
    bo = rng.normal(size=(dout,)) * 0.1
    return tuple(a.astype(np.float32)
                 for a in (x, mask, ws, bs, wf, bf, wo, bo))


def aggregate_inputs(b, n, *, ds, df, seed, n_valid=None, dup=0,
                     masked_event=None):
    """Operands of the f32 GravNet aggregation: (s (B,n,ds), f (B,n,df),
    mask (B,n)) float32 numpy arrays, s of order 1 as the block's S is.
    s lies on a grid of 1/8, so every distance is exact in float32 (see
    :func:`block_inputs`); duplicated rows repeat s and f bit for
    bit."""
    rng = np.random.default_rng(seed)
    mask, _, pairs = _valid_rows(b, n, n_valid, dup, masked_event)
    s = np.round(rng.normal(size=(b, n, ds)) * 8) / 8
    f = rng.normal(size=(b, n, df))
    for src, dst in pairs:
        s[:, dst] = s[:, src]
        f[:, dst] = f[:, src]
    return s.astype(np.float32), f.astype(np.float32), mask


#: name -> (bins, n, d_s, d_f, k, values, coincident rows per event,
#: corrupted indices): the kNN edge cases. Each bin is a tuple of the
#: sizes of the events packed into it in order, the rest of its n rows
#: padding. ``values``: "grid" puts s on a grid of 1/8 (every distance
#: exact in float32, any order of summation), "coarse" on a grid of 1/2
#: in [-1, 1] (many exact ties), "separated" draws s from a normal
#: distribution until every row's k-th and (k+1)-th distances lie apart
#: by far more than rounding. The aggregation reads the (idx, d2) the
#: plain selection gives, with one slot of every other row moved out of
#: [0, n) (negative or past n) where ``corrupted``.
KNN_CASES = {
    "occupancy_33_65_97": (((33, 65), (97,), (33, 33, 33), (65,), (97, 1),
                            (65, 33, 1)), 128, 4, 22, 8, "grid", 2, False),
    "fewer_hits_than_k_plus_1": (((1, 2, 5, 8, 9, 3), (7,), (1,)), 40, 4,
                                 22, 8, "grid", 0, False),
    "all_padding_bin": (((), (20, 12), ()), 64, 4, 22, 8, "grid", 0,
                        False),
    "coincident_rows": (((64, 64), (33, 65)), 128, 4, 22, 8, "grid", 16,
                        False),
    "exact_ties": (((65, 33, 30), (97,)), 128, 4, 22, 8, "coarse", 0,
                   False),
    "separated": (((33, 65), (97,), (33, 33, 33), (65, 33)), 128, 4, 22, 8,
                  "separated", 0, False),
    "n100": (((40, 33, 27), (99,), (100,)), 100, 4, 22, 8, "grid", 1,
             False),
    "n500": (((250, 249), (500,)), 500, 4, 22, 8, "grid", 3, False),
    "n600_past_the_register_cell": (((300, 290), (600,)), 600, 3, 8, 4,
                                    "grid", 2, False),
    "ds3": (((33, 65), (97, 1)), 128, 3, 8, 4, "grid", 2, False),
    "ds12": (((33, 65), (97, 1)), 128, 12, 22, 8, "grid", 0, False),
    "df129_past_the_register_path": (((33, 65), (97, 1)), 128, 4, 129, 8,
                                     "grid", 0, False),
    "out_of_range_indices": (((33, 65), (97, 1), ()), 128, 4, 22, 8,
                             "grid", 0, True),
    "k40_past_a_warp_of_slots": (((97,), (65, 33)), 128, 4, 22, 40,
                                 "grid", 1, True),
}


def knn_segids(bins, n):
    """segids (B,n) int32 of bins of packed events: each event's rows
    carry its id (counted over all bins), padding rows -1."""
    seg = np.full((len(bins), n), -1, np.int32)
    e = 0
    for b, sizes in enumerate(bins):
        row = 0
        for c in sizes:
            seg[b, row:row + c] = e
            row, e = row + c, e + 1
        if row > n:
            raise ValueError(f"knn_segids: bin {b} holds {row} > {n} rows")
    return seg


def knn_min_gap(s, seg, k):
    """The smallest gap between a row's k-th and (k+1)-th distance to
    the other rows of its event, relative to the (k+1)-th (at least 1),
    over the rows with more than k candidates (inf if none)."""
    s = s.astype(np.float64)
    gap = np.inf
    for b in range(s.shape[0]):
        for i in np.flatnonzero(seg[b] >= 0):
            cand = np.flatnonzero(seg[b] == seg[b, i])
            cand = cand[cand != i]
            if len(cand) <= k:
                continue
            d2 = np.sort(((s[b, cand] - s[b, i]) ** 2).sum(1))
            gap = min(gap, (d2[k] - d2[k - 1]) / max(d2[k], 1.0))
    return gap


def knn_build_inputs(bins, n, ds, k, values, dup, *, seed):
    """Operands of the kNN selection: (s (B,n,ds) f32, segids (B,n)
    int32). Padding rows of s are zero, as the packing leaves them; in
    each event of more than one hit, ``dup`` rows (from its second on)
    repeat its first rows bit for bit, so their distance is exactly 0."""
    seg = knn_segids(bins, n)
    for attempt in range(50):
        rng = np.random.default_rng(seed * 100 + attempt)
        if values == "coarse":
            s = rng.integers(-2, 3, size=(len(bins), n, ds)) / 2.0
        elif values == "grid":
            s = np.round(rng.normal(size=(len(bins), n, ds)) * 8) / 8
        elif values == "separated":
            s = rng.normal(size=(len(bins), n, ds))
        else:
            raise ValueError(f"knn_build_inputs: values {values!r}")
        s[seg < 0] = 0.0
        for b, sizes in enumerate(bins):
            row = 0
            for c in sizes:
                for r in range(min(dup, c // 2)):
                    s[b, row + c - 1 - r] = s[b, row + r]
                row += c
        s = s.astype(np.float32)
        if values != "separated" or knn_min_gap(s, seg, k) > 1e-5:
            return s, seg
    raise ValueError("knn_build_inputs: no well-separated draw in 50")


def knn_aggregate_inputs(idx, n, df, corrupted, *, seed):
    """Features f (B,n,df) f32 for the aggregation over (idx (B,n,k),
    from the plain selection) and that idx, where ``corrupted`` with one
    slot of every other row (slot r mod k of the r-th such row) moved to
    -1, -n, n or n + 5 in turn."""
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(*idx.shape[:2], df)).astype(np.float32)
    idx = np.array(idx, np.int32)
    if corrupted:
        rows = idx.reshape(-1, idx.shape[2])[::2]
        r = np.arange(len(rows))
        rows[r, r % idx.shape[2]] = np.array([-1, -n, n, n + 5],
                                             np.int32)[r % 4]
    return f, idx


#: bins of the ragged path's events (occupancy 33, 65 and 97 of 128
#: rows, first-fit packed: 1 to 3 events a bin), cycled over the bins of
#: the kNN pair's timed launches (``phase_split.py``, ``source_ab.py``)
PATH_BINS = ((33, 65), (97,), (33, 33, 33), (65, 33), (97,), (65, 33),
             (33, 65), (97,))


def knn_path_bins(bsz):
    """The events of bsz bins of the ragged path, :data:`PATH_BINS`
    in turn."""
    return tuple(PATH_BINS[b % len(PATH_BINS)] for b in range(bsz))
