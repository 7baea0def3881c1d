"""Inputs that stress the int8 kernels' designs, made with numpy from a
seed.

``csrc/gravnet_block_int8.cu`` keeps a query row's distances in
registers, 32 candidates to a round of lanes, and breaks ties on the
distance's bits; ``csrc/fused_dense_int8.cu`` tiles its output 32 × 16
and zero-pads K to the tensor cores' depth of 32. So the cases are:
exact distance ties (rows whose features are duplicated bit for bit),
the current detector's 32 hits and a hit count that is not a multiple
of 32, fewer valid candidates than k, a row count that is not a
multiple of the tile, and the narrow K = 4 and N = 7 of the paths, in
both output forms. ``tests/test_torch_quant.py`` holds the plain
versions against the JAX package on these inputs, and ``chip_smoke.py``
holds the kernels against the plain versions on the card.

The inputs are numpy arrays made from a seed; the weights are quantized
by the deployment flow's own ``quantize_weight`` and the activation
scales by its ``activation_scale`` (``repro_torch/core/quantization.py``),
from the inputs' ranges. ``quotient_edges`` turns a block's inputs into
ones whose quantizations land on the hard cases of the kernels'
division-free quotient (``csrc/int8_quant.cuh``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.quantization import activation_scale, quantize_weight

#: name -> (events, hits, valid hits or None, duplicated rows)
BLOCK_CASES = {
    "ties": (2, 32, None, 6),
    "current_detector": (2, 32, 24, 0),
    "hits_not_a_multiple_of_32": (3, 50, 41, 2),
    "fewer_valid_than_k": (2, 32, 3, 0),
}
#: name -> (M, K, N, activation, int8 output)
DENSE_CASES = {
    "k4_n7_f32": (50, 4, 7, "none", False),
    "k4_n7_int8": (50, 4, 7, "relu", True),
    "rows_not_a_multiple_of_the_tile": (37, 64, 64, "relu", True),
    "k_past_one_slice": (40, 200, 24, "relu", False),
    "odd_k_and_n": (33, 5, 9, "relu", False),
}


def _quantize(w):
    w_q, scale = quantize_weight(torch.from_numpy(w))
    return w_q.numpy(), scale.numpy()


def block_inputs(b, n, *, dh, ds, df, dout, seed, n_valid=None, dup=0):
    """Operands of the quantized GravNet block: (x, mask, ws_q, bs,
    wf_q, bf, wo_q, bo, ws_scale, wf_scale, wo_scale) and the scales
    ``{x_scale, agg_scale, h_scale}``.

    x is a relu output; rows at or past ``n_valid`` are padding (mask 0,
    x 0), as the detector's events pad. ``dup`` valid rows of each event
    repeat earlier valid rows bit for bit, half of them spread over the
    event and half next to their source, so that other rows see exact
    distance ties (the duplicates' S and F rows are equal too). The
    aggregate's scale is calibrated on a bound of it, max |f| (a
    weighted mean or max of f rows with weights at most 1)."""
    rng = np.random.default_rng(seed)
    nv = n if n_valid is None else n_valid
    x = np.maximum(rng.normal(size=(b, n, dh)), 0.0).astype(np.float32)
    mask = np.ones((b, n), np.float32)
    mask[:, nv:] = 0.0
    x[:, nv:] = 0.0
    for d in range(dup):
        src = d % max(nv // 2, 1)
        dst = src + 1 if d % 2 else nv - 1 - d // 2
        if dst < nv:
            x[:, dst] = x[:, src]
    ws = (rng.normal(size=(dh, ds)) / np.sqrt(dh)).astype(np.float32)
    wf = (rng.normal(size=(dh, df)) / np.sqrt(dh)).astype(np.float32)
    wo = (rng.normal(size=(dh + 2 * df, dout))
          / np.sqrt(dh + 2 * df)).astype(np.float32)
    bs = (rng.normal(size=(ds,)) * 0.1).astype(np.float32)
    bf = (rng.normal(size=(df,)) * 0.1).astype(np.float32)
    bo = (rng.normal(size=(dout,)) * 0.1).astype(np.float32)
    (ws_q, ws_s), (wf_q, wf_s), (wo_q, wo_s) = (
        _quantize(w) for w in (ws, wf, wo))
    x_max = float(np.abs(x).max())
    f_max = float(np.abs(x @ wf + bf).max())
    scales = dict(x_scale=activation_scale(x_max),
                  agg_scale=activation_scale(f_max),
                  h_scale=activation_scale(max(x_max, f_max)))
    return (x, mask, ws_q, bs, wf_q, bf, wo_q, bo, ws_s, wf_s, wo_s), scales


def dense_inputs(m, kdim, n, *, seed):
    """Operands of the quantized dense: (x_q, w_q, b, x_scale, w_scale)
    and an output scale for the int8 form."""
    rng = np.random.default_rng(seed)
    x_q = rng.integers(-127, 128, (m, kdim)).astype(np.int8)
    w = (rng.normal(size=(kdim, n)) / np.sqrt(kdim)).astype(np.float32)
    b = (rng.normal(size=(n,)) * 0.1).astype(np.float32)
    w_q, w_scale = _quantize(w)
    x_scale = 0.0123456789
    y_max = float(np.abs((x_q.astype(np.float64) * x_scale)
                         @ (w_q * w_scale[None, :])).max()) + 0.3
    return (x_q, w_q, b, x_scale, w_scale), activation_scale(y_max)


def quotient_values(s, *, seed, n=512):
    """float32 values v whose quotients v / f32(s) are the hard cases of
    a quotient computed other than by the f32 division: half-integers
    (rint's ties) and their neighbours, quotients next to the midpoint
    of two floats, quotients below the normal range (subnormal v), ±0,
    values past the clip at ±127 and ±inf."""
    rng = np.random.default_rng(seed)
    s32 = np.float32(s)
    half = ((np.arange(-128, 128) + 0.5) * np.float64(s32)).astype(
        np.float32)
    q = rng.uniform(0.5, 127.0, n // 4).astype(np.float32)
    ulp = np.spacing(q).astype(np.float64)
    mids = ((q.astype(np.float64) + ulp / 2) * np.float64(s32)).astype(
        np.float32)
    tiny = np.array([1e-45, 1e-42, 1e-40, 1e-38, 2e-38, 1.2e-38],
                    np.float32)
    specials = np.array([0.0, -0.0, np.inf, -np.inf, 1e30, -1e30,
                         3e38, 127.5 * np.float64(s32)], np.float32)
    vals = np.concatenate([half, mids, tiny, -tiny, specials])
    return np.concatenate([vals, np.nextafter(vals, np.float32(np.inf)),
                           np.nextafter(vals, np.float32(-np.inf))])


def quotient_edges(ops, scales, *, seed):
    """The block's operands and scales with x's valid entries taken, in
    turn, from :func:`quotient_values` of x_scale, and h_scale set to
    x_scale, so that the quantizations of x into xq and into h both meet
    them."""
    x, mask = ops[0].copy(), ops[1]
    vals = quotient_values(scales["x_scale"], seed=seed)
    valid = np.broadcast_to(mask[..., None] > 0, x.shape)
    idx = np.flatnonzero(valid)
    x.flat[idx] = np.resize(vals, idx.size)
    return (x, *ops[1:]), dict(scales, h_scale=scales["x_scale"])
