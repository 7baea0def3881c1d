"""The yardstick's arithmetic: the H100's peaks, the models' FLOPs and the
hand kernels' operations and bytes.

The peaks are NVIDIA's H100 SXM datasheet figures (dense, no sparsity, at
the 700 W limit). The model FLOPs are counted from the layer equations, as
the configuration needs them, and not copied from the program's
``configs/caloclusternet.py:_flops``: that is an implementation count, of
the kNN aggregation as a product with a one-hot selection (2·n²·k·d_flr a
block), 2.5 times the work. The kernels' counts are copies of
``chip_smoke.py``'s ``cost`` (for the kernels the configuration runs),
``_cell_ops`` and ``bound``, taking the peaks from here. A count is of the
work the configuration needs: each input read once, each output written
once, a weight once per count.
"""
from __future__ import annotations

HBM_BYTES_S = 3.35e12
PEAK_F32 = 67e12
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
RATES = {"f32": PEAK_F32, "bf16": PEAK_BF16, "int8": PEAK_INT8}


def bound_s(nbytes: float, ops: dict) -> float:
    """The least time the card could take: the larger of the bytes at HBM
    bandwidth and each kind of operation at its peak."""
    return max(nbytes / HBM_BYTES_S,
               *(n / RATES[kind] for kind, n in ops.items()))


# ------------------------------------------------------------ model FLOPs ----
def ccn_flops_per_event(c: dict) -> float:
    """Forward FLOPs of one event (a multiply-add is 2): the encoder's two
    denses; per GravNet block its S and F denses, the squared distances
    between all hit pairs in S (2·n²·d_s as a product), the k nearest
    neighbours' features weighted and summed (2·n·k·d_flr; the selection,
    the max and the potential count nothing) and its output dense over
    [x, mean, max]; the decoder's two denses and the heads. CPS counts
    nothing."""
    n, d = c["n_hits"], c["d_hidden"]
    heads = 1 + 2 + 1 + c["n_classes"]
    block = (2 * n * d * (c["d_s"] + c["d_flr"])
             + 2 * n * n * c["d_s"]
             + 2 * n * c["k"] * c["d_flr"]
             + 2 * n * (d + 2 * c["d_flr"]) * d)
    return float(2 * n * (c["d_in"] * d + d * d)
                 + c["n_gravnet_blocks"] * block
                 + 2 * n * (d * d + d * c["d_decoder"])
                 + 2 * n * c["d_decoder"] * heads)


# --------------------------------------------------------- kernel counts ----
def _cell_ops(n, ds, df, k):
    """f32 operations of the GravNet cell per query row."""
    return n * (2.0 * ds + 3.0) + k * (n + 1.0 + 3.0 * df)


def fused_dense_int8(m, kd, n, *, out_int8):
    """(bytes, ops) of act(x_q @ w_q) dequantized, over m rows."""
    nbytes = (m + n) * kd + 4.0 * 2 * n + m * n * (1.0 if out_int8 else 4.0)
    return nbytes, {"int8": 2.0 * m * kd * n,
                    "f32": m * n * (3.0 + (2.0 if out_int8 else 0.0)) + n}


def gravnet_block_int8(b, n, dh, ds, df, dout, k):
    """(bytes, ops) of the quantized GravNet block over b events of n hits
    (float32 x and output, int8 weights)."""
    dcat = dh + 2 * df
    nbytes = (4.0 * b * n * dh + 4.0 * b * n + 4.0 * 2 * (ds + df + dout)
              + dh * ds + dh * df + dcat * dout + 4.0 * b * n * dout)
    return nbytes, {
        "int8": b * n * (2.0 * dh * (ds + df) + 2.0 * dcat * dout),
        "f32": b * n * (2.0 * dh + 3.0 * (ds + df) + _cell_ops(n, ds, df, k)
                        + 4.0 * 2 * df + 2.0 * (dcat - 2 * df) + 3.0 * dout)}


def ccn_mixed_bound_s(c: dict, events: int) -> float:
    """Roofline seconds of the mixed deployment's hand-kernel work for
    ``events`` events: five int8 denses and the int8 GravNet blocks."""
    n, dh = c["n_hits"], c["d_hidden"]
    m = events * n
    heads = 1 + 2 + 1 + c["n_classes"]
    t = sum(bound_s(*fused_dense_int8(m, kd, nn, out_int8=o8)) for kd, nn, o8
            in ((c["d_in"], dh, True), (dh, dh, False), (dh, dh, True),
                (dh, c["d_decoder"], True), (c["d_decoder"], heads, False)))
    return t + c["n_gravnet_blocks"] * bound_s(*gravnet_block_int8(
        events, n, dh, c["d_s"], c["d_flr"], dh, c["k"]))
