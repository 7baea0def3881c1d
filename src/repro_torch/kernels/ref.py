"""Plain PyTorch versions of the port's kernels.

They are the ground truth the CUDA kernels are held against on the card
(``chip_smoke.py``), and what ``kernels/ops.py`` runs for a tensor that
lies on the CPU. Each one follows its kernel's schedule, including the
order of every f32 sum: products and sums are separate, rounded
operations taken in the kernel's order (the kernels are built with
``-fmad=false``), so on the card a plain version reproduces its kernel's
bits wherever ``exp`` agrees. The sums are written as loops for that
reason; ``torch.matmul`` would leave their order to the library. The
int8 kernels' int32 sums are exact in any order, so their plain
versions take them from a float64 product, which is exact at these
sizes; every f32 step around them (dequantization, requantization by
division, rounding half to even) keeps the kernels' order.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantization import QMAX, f32, quantize_act

BIG = 1e30


def _activate(y, activation):
    if activation in (None, "none", "linear"):
        return y
    if activation == "relu":
        return torch.relu(y)
    raise NotImplementedError(
        f"activation {activation!r}: only 'none' and 'relu' are ported")


def _dot_last(x, w):
    """``x @ w`` over the last axis of x, summed in k order, each product
    and sum rounded on its own (the kernels' order of operations)."""
    acc = torch.zeros((*x.shape[:-1], w.shape[1]), dtype=torch.float32,
                      device=x.device)
    for kk in range(w.shape[0]):
        acc = acc + x[..., kk, None] * w[kk]
    return acc


# ------------------------------------------------------------ fused dense ----
def fused_dense_ref(x, w, b=None, *, activation="relu"):
    """act(x @ w + b) in f32, cast back to x.dtype. x:(..., K) w:(K, N)."""
    y = _dot_last(x.float(), w.float())
    if b is not None:
        y = y + b.float()
    return _activate(y, activation).to(x.dtype)


def _int_dot(xq, wq):
    """int8 x int8 -> exact int32 sums over the last axis of xq. Every
    partial sum is an integer far below 2^53, so a float64 product is
    exact in any order of summation, as the kernels' int32 sums are."""
    return (xq.double() @ wq.double()).to(torch.int32)


def _dequant(acc, b, x_scale, w_scale):
    """``acc·(x_scale·w_scale[c]) + b`` in f32, in the kernels' order."""
    y = acc.float() * (f32(x_scale) * w_scale.float())
    return y if b is None else y + b.float()


def fused_dense_int8_ref(x_q, w_q, b, x_scale, w_scale, *,
                         activation="relu", out_int8=False, out_scale=1.0):
    """Quantized fused dense: int8 x_q:(..., K) by int8 w_q:(K, N) into
    exact int32 sums, then ``y = acc·(x_scale·w_scale[c]) + b``, the
    activation, and for ``out_int8`` a requantization
    ``clip(round(y / out_scale), ±127)`` to int8; else f32.
    ``x_scale`` and ``out_scale`` are Python floats, used as float32."""
    y = _activate(_dequant(_int_dot(x_q, w_q), b, x_scale, w_scale),
                  activation)
    return quantize_act(y, out_scale) if out_int8 else y


# ---------------------------------------------------------------- gravnet ----
def _sqnorm(s):
    acc = torch.zeros(s.shape[:-1], dtype=torch.float32, device=s.device)
    for d in range(s.shape[-1]):
        acc = acc + s[..., d] * s[..., d]
    return acc


def gravnet_cell_ref(s, f, mask, *, k=8, scale=10.0):
    """The GravNet cell of ``repro/kernels/gravnet.py:_gravnet_cell``,
    batched over events: k rounds of row argmin (ties to the lowest
    column), Gaussian weight ``exp(-scale·d²)``, mean/max accumulation,
    knockout of the chosen column. Every row of an event queries every
    other valid row of the same event.

    s:(B,n,ds), f:(B,n,df), mask:(B,n) -> (B, n, 2·df).
    """
    bsz, n, ds = s.shape
    df = f.shape[2]
    dev = s.device
    dot = torch.zeros((bsz, n, n), dtype=torch.float32, device=dev)
    for d in range(ds):
        dot = dot + s[:, :, d, None] * s[:, None, :, d]
    sq = _sqnorm(s)
    d2 = (sq[:, :, None] + sq[:, None, :]) - 2.0 * dot
    idx = torch.arange(n, device=dev)
    invalid = (mask[:, None, :] <= 0) | (idx[None, :] == idx[:, None])
    big = torch.full((), BIG, dtype=torch.float32, device=dev)
    d2 = torch.where(invalid, big, torch.clamp_min(d2, 0.0))

    mean_acc = torch.zeros((bsz, n, df), dtype=torch.float32, device=dev)
    max_acc = torch.full((bsz, n, df), -BIG, dtype=torch.float32,
                         device=dev)
    for _ in range(k):
        amin = torch.argmin(d2, dim=2, keepdim=True)         # first min
        dmin = torch.gather(d2, 2, amin)[..., 0]
        fsel = torch.gather(f, 1, amin.expand(bsz, n, df))
        valid = dmin < BIG * 0.5
        w = torch.where(valid, torch.exp(-scale * dmin), 0.0)
        wf = w[..., None] * fsel
        mean_acc = mean_acc + wf
        max_acc = torch.maximum(
            max_acc, torch.where(valid[..., None], wf, -big))
        d2 = d2.scatter(2, amin, big.expand(bsz, n, 1))
    mean = mean_acc / k
    maxv = torch.where(max_acc <= -BIG * 0.5, 0.0, max_acc)
    return torch.cat([mean, maxv], dim=2)


def gravnet_aggregate_ref(s, f, mask, *, k=8, scale=10.0):
    """The standalone GravNet aggregation over a micro-batch: the cell
    fed S and F from memory. s:(B,n,ds), f:(B,n,df), mask:(B,n) ->
    (B, n, 2·df) f32."""
    return gravnet_cell_ref(s.float(), f.float(), mask.float(), k=k,
                            scale=scale)


# ---------------------------------------------------------- gravnet block ----
def gravnet_block_ref(x, mask, ws, bs, wf, bf, wo, bo, *, k=8, scale=10.0,
                      activation="relu"):
    """The fused GravNet block over a micro-batch: S/F projections -> the
    cell over each whole event -> act(concat(x, agg) @ wo + bo).
    x:(B,N,dh), mask:(B,N) -> (B,N,d_out)."""
    xf = x.float()
    s = fused_dense_ref(xf, ws, bs, activation="none")
    f = fused_dense_ref(xf, wf, bf, activation="none")
    agg = gravnet_cell_ref(s, f, mask.float(), k=k, scale=scale)
    h = torch.cat([xf, agg], dim=-1)
    return fused_dense_ref(h, wo, bo, activation=activation).to(x.dtype)


def gravnet_block_int8_ref(x, mask, ws_q, bs, wf_q, bf, wo_q, bo, ws_scale,
                           wf_scale, wo_scale, *, x_scale, agg_scale,
                           h_scale, k=8, scale=10.0, activation="relu"):
    """The quantized GravNet block over a micro-batch, in the kernel's
    order: quantize x with ``x_scale``; int8 S/F dots dequantized as
    ``acc·(x_scale·w_scale[c]) + b`` (no output snap); the f32 cell;
    snap ``agg`` to the ``agg_scale`` grid; quantize
    ``h = concat(x, agg)`` with ``h_scale``; the int8 output dot with
    dequant, bias and activation. x:(B,N,dh) f32 -> (B,N,d_out) f32."""
    xf = x.float()
    xq = quantize_act(xf, x_scale)
    s = _dequant(_int_dot(xq, ws_q), bs, x_scale, ws_scale)
    f = _dequant(_int_dot(xq, wf_q), bf, x_scale, wf_scale)
    agg = gravnet_cell_ref(s, f, mask.float(), k=k, scale=scale)
    agg = torch.clamp(torch.round(agg / f32(agg_scale)), -QMAX,
                      QMAX) * f32(agg_scale)
    hq = quantize_act(torch.cat([xf, agg], dim=-1), h_scale)
    return fused_dense_int8_ref(hq, wo_q, bo, h_scale, wo_scale,
                                activation=activation)
