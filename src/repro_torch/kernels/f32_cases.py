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
masks, and 1, 8 and 16 graphs. ``tests/test_torch_dense.py`` and
``tests/test_torch_edge.py`` hold the plain versions and plans on these
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
