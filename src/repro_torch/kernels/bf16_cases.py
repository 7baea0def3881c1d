"""Inputs that stress the kernels' bf16 forms, made with numpy from a
seed.

A bf16 form reads its float operands as bf16 and widens them in the
kernel: ``csrc/dtype_io.cuh`` stages a bf16 operand by ordinary loads of
16, 8, 4 or 2 bytes, the widest that the address, the row stride and the
row length allow, into the f32 shared memory the f32 form stages into,
and rounds the output once where it is bf16. So the dense cases take K
of 4 (8-byte rows), 70 (140-byte rows, 4-byte aligned), 257 (odd: 2-byte
loads, and past the staging limit: slabs) and a row-strided x (a column
slice of a lane-padded matrix, as the executor reads one), and inputs
with subnormal and large bf16 values. The GravNet and kNN cases are
``f32_cases``' shapes past the register cell (600 hits, d_f 129), k 40
and indices out of range; the edge cases 30,000 edges (three launches
whose f32 sums and counts carry from one to the next, the output
rounded once) and subnormal and large messages. Every array is float32
with values on the bf16 grid (:func:`bf16_values`), so moving it to a
``torch.bfloat16`` tensor is exact; a caller moves every float operand
of a form (the mask, the kNN pair's d2 and the int8 block's scales
stay f32). ``chip_smoke.py`` holds each bf16 form against its plain
version on the card, bitwise, with both output dtypes, and
``tests/test_torch_bf16.py`` holds the plain versions against the JAX
package on the CPU.
"""
from __future__ import annotations

import numpy as np

from repro_torch.kernels import f32_cases

#: name -> (M, K, N, x's row stride or None for contiguous, activation,
#: bias, values): "normal" or "extreme" (:func:`with_extremes`)
DENSE_CASES = {
    "k4_n64": (256, 4, 64, None, "relu", True, "normal"),
    "own_k70_of_128": (256, 70, 70, 128, "relu", True, "normal"),
    "k70_n140_no_bias": (512, 70, 140, None, "none", False, "normal"),
    "k257_past_staging": (64, 257, 33, None, "none", True, "normal"),
    "subnormal_and_large": (128, 64, 64, None, "none", True, "extreme"),
}
#: the GravNet cases of ``f32_cases.GRAVNET_CASES`` the bf16 forms take:
#: exact ties, and both past the register cell (the shared-memory cell)
GRAVNET_CASES = ("n17_ties", "n600_past_the_register_cell",
                 "df129_past_the_register_cell")
#: the kNN cases of ``f32_cases.KNN_CASES`` the bf16 forms take
KNN_CASES = ("occupancy_33_65_97", "n600_past_the_register_cell",
             "df129_past_the_register_path", "out_of_range_indices",
             "k40_past_a_warp_of_slots")
#: name -> (graphs, edges, width, kind of ``f32_cases.edge_inputs``,
#: values)
EDGE_CASES = {
    "e1000_d70": (8, 1000, 70, "random", "normal"),
    "e33_d129": (16, 33, 129, "random", "normal"),
    "every_dst_out_of_range": (4, 256, 16, "out_of_range", "normal"),
    # three launches of at most 14,399 edges (the H100's), the f32 sums
    # and counts carried between them
    "past_one_launch": (2, 30000, 70, "random", "normal"),
    "subnormal_and_large": (8, 256, 16, "random", "extreme"),
}
#: the extremes of "extreme" values: a subnormal bf16 magnitude and a
#: large one whose products and sums stay far inside the f32 range
TINY, HUGE = 1e-39, 1e17


def bf16_values(a):
    """a as float32 rounded to the nearest bfloat16, ties to even (the
    rounding of ``Tensor.to(torch.bfloat16)``): every value exact in
    bf16. Finite inputs only."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32).astype(
        np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) >> 16 << 16
    return u.astype(np.uint32).view(np.float32).reshape(np.shape(a))


def with_extremes(a, seed):
    """a with one entry in 8 scaled to a subnormal magnitude (``TINY``)
    and one in 8 to a large one (``HUGE``)."""
    rng = np.random.default_rng(seed)
    a = np.array(a, np.float32)
    pick = rng.integers(0, 8, size=a.shape)
    a[pick == 0] *= np.float32(TINY)
    a[pick == 1] *= np.float32(HUGE)
    return a


def dense_inputs(name, *, seed):
    """(x, w, b, activation) of a dense case on the bf16 grid: x the
    (M, row stride) matrix whose first K columns the dense reads (index
    it ``[:, :K]`` after moving it), b None without bias."""
    m, kdim, n, ldx, act, bias, values = DENSE_CASES[name]
    x, w, b = f32_cases.dense_inputs(m, kdim, n, ldx=ldx, bias=bias,
                                     seed=seed)
    if values == "extreme":
        x, w = with_extremes(x, seed), with_extremes(w, seed + 1)
    return (bf16_values(x), bf16_values(w),
            None if b is None else bf16_values(b), act)


def gravnet_inputs(name, *, seed):
    """(block operands (x, mask, ws, bs, wf, bf, wo, bo), aggregation
    operands (s, f, mask), k) of a GravNet case on the bf16 grid. x, ws,
    bs and s lie on f32_cases' dyadic grids, which bf16 holds exactly,
    so every distance is exact and the selections are those of f32."""
    b, n, dh, ds, df, dout, k, nv, dup, masked = \
        f32_cases.GRAVNET_CASES[name]
    block = f32_cases.block_inputs(b, n, dh=dh, ds=ds, df=df, dout=dout,
                                   seed=seed, n_valid=nv, dup=dup,
                                   masked_event=masked)
    agg = f32_cases.aggregate_inputs(b, n, ds=ds, df=df, seed=seed,
                                     n_valid=nv, dup=dup,
                                     masked_event=masked)
    s, f, mask = agg         # the masks stay f32
    return (tuple(a if i == 1 else bf16_values(a)
                  for i, a in enumerate(block)),
            (bf16_values(s), bf16_values(f), mask), k)


def knn_build_inputs(name, *, seed):
    """(s on the bf16 grid, segids, k) of a kNN case: s on f32_cases'
    grid of 1/8 (exact in bf16)."""
    bins, n, ds, _, k, values, dup, _ = f32_cases.KNN_CASES[name]
    s, seg = f32_cases.knn_build_inputs(bins, n, ds, k, values, dup,
                                        seed=seed)
    return bf16_values(s), seg, k


def knn_aggregate_inputs(name, idx, *, seed, extreme=False):
    """(f on the bf16 grid, idx) for the aggregation over ``idx`` (the
    plain selection's), out-of-range slots where the case has them, f
    with subnormal and large values where ``extreme``."""
    _, n, _, df, _, _, _, corrupted = f32_cases.KNN_CASES[name]
    f, idx = f32_cases.knn_aggregate_inputs(idx, n, df, corrupted,
                                            seed=seed)
    if extreme:
        f = with_extremes(f, seed)
    return bf16_values(f), idx


def edge_inputs(name, *, seed):
    """(messages on the bf16 grid, dst, mask) of an edge case."""
    bsz, e, d, kind, values = EDGE_CASES[name]
    msg, dst, mask = f32_cases.edge_inputs(bsz, e, d, kind, seed=seed)
    if values == "extreme":
        msg = with_extremes(msg, seed)
    return bf16_values(msg), dst, mask
