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
division, rounding half to even) keeps the kernels' order. The
exception is ``flash_attention``, whose kernel runs on FMAs: its plain
version keeps an order of its own, and the kernel is held to the
float32 row against it. A plain version of a kernel that takes bf16
operands widens them (exactly), computes in f32 and rounds its result
once to ``out_dtype`` (by default the input's dtype), as the kernels'
bf16 forms and the reference's ``out_dtype or x.dtype`` do. The top-k
oracle of the GravNet aggregation
(``knn_topk_ref``, ``gravnet_aggregate_topk_ref``) is no kernel's plain
version: it follows the JAX package's oracle, its distances' dots as one
matrix product.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.quantization import QMAX, div_f32, f32, quantize_act

BIG = 1e30


def _activate(y, activation):
    """The epilogues' activation in f32: gelu in its tanh form
    (``jax.nn.gelu``'s default), silu as x·sigmoid(x). The kernels' gelu
    and silu round as CUDA's tanhf and expf do, so on them a plain
    version holds its kernel to the float32 row, not to its bits."""
    if activation in (None, "none", "linear"):
        return y
    if activation == "relu":
        return torch.relu(y)
    if activation == "gelu":
        return F.gelu(y, approximate="tanh")
    if activation == "silu":
        return y * torch.sigmoid(y)
    raise ValueError(f"unknown activation {activation!r}")


def _dot_last(x, w):
    """``x @ w`` over the last axis of x, summed in k order, each product
    and sum rounded on its own (the kernels' order of operations)."""
    acc = torch.zeros((*x.shape[:-1], w.shape[1]), dtype=torch.float32,
                      device=x.device)
    for kk in range(w.shape[0]):
        acc = acc + x[..., kk, None] * w[kk]
    return acc


# ------------------------------------------------------------ fused dense ----
def fused_dense_ref(x, w, b=None, *, activation="relu", out_dtype=None):
    """act(x @ w + b) in f32, cast to ``out_dtype`` (None: x.dtype).
    x:(..., K) w:(K, N)."""
    y = _dot_last(x.float(), w.float())
    if b is not None:
        y = y + b.float()
    return _activate(y, activation).to(out_dtype or x.dtype)


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
# The GravNet cell in three steps, shared by the fused blocks, the
# standalone aggregation and the ragged kNN pair, as the CUDA kernels
# share csrc/gravnet_cell.cuh.
def _sqnorm(s):
    acc = torch.zeros(s.shape[:-1], dtype=torch.float32, device=s.device)
    for d in range(s.shape[-1]):
        acc = acc + s[..., d] * s[..., d]
    return acc


def _pairwise_d2(s):
    """(|s_i|² + |s_j|²) − 2·s_i·s_j over the rows of each event, the dot
    summed over d in order, clamped at 0. s:(B,n,ds) -> (B,n,n)."""
    bsz, n, ds = s.shape
    dot = torch.zeros((bsz, n, n), dtype=torch.float32, device=s.device)
    for d in range(ds):
        dot = dot + s[:, :, d, None] * s[:, None, :, d]
    sq = _sqnorm(s)
    return torch.clamp_min((sq[:, :, None] + sq[:, None, :]) - 2.0 * dot,
                           0.0)


def _select(d2):
    """One selection round: each row's minimum (ties to the lowest
    column) and its column, which is then knocked out. Returns
    (amin:(B,n,1) int64, dmin:(B,n), d2)."""
    amin = torch.argmin(d2, dim=2, keepdim=True)             # first min
    dmin = torch.gather(d2, 2, amin)[..., 0]
    big = torch.full((), BIG, dtype=torch.float32, device=d2.device)
    return amin, dmin, d2.scatter(2, amin, big.expand(*d2.shape[:2], 1))


def _accumulate(mean_acc, max_acc, dmin, fsel, scale):
    """Adds one neighbour (distance dmin, features fsel) with weight
    exp(−scale·dmin); a slot with dmin >= 0.5e30 weighs 0 and is left
    out of the max."""
    valid = dmin < BIG * 0.5
    w = torch.where(valid, torch.exp(-scale * dmin), 0.0)
    wf = w[..., None] * fsel
    return mean_acc + wf, torch.maximum(
        max_acc, torch.where(valid[..., None], wf, -BIG))


def _aggregate(f, rounds, k, scale, n):
    """mean/max for n query rows over ``rounds`` (k pairs of
    (amin:(B,n,1), dmin:(B,n))) of the rows of f:(B,m,df) ->
    (B, n, 2·df)."""
    bsz, _, df = f.shape
    mean_acc = torch.zeros((bsz, n, df), dtype=torch.float32,
                           device=f.device)
    max_acc = torch.full((bsz, n, df), -BIG, dtype=torch.float32,
                         device=f.device)
    for amin, dmin in rounds:
        fsel = torch.gather(f, 1, amin.expand(bsz, n, df))
        mean_acc, max_acc = _accumulate(mean_acc, max_acc, dmin, fsel,
                                        scale)
    mean = div_f32(mean_acc, k)
    maxv = torch.where(max_acc <= -BIG * 0.5, 0.0, max_acc)
    return torch.cat([mean, maxv], dim=2)


def gravnet_cell_ref(s, f, mask, *, k=8, scale=10.0):
    """The GravNet cell of ``repro/kernels/gravnet.py:_gravnet_cell``,
    batched over events: k rounds of row argmin (ties to the lowest
    column), Gaussian weight ``exp(-scale·d²)``, mean/max accumulation,
    knockout of the chosen column. Every row of an event queries every
    other valid row of the same event.

    s:(B,n,ds), f:(B,n,df), mask:(B,n) -> (B, n, 2·df).
    """
    n = s.shape[1]
    idx = torch.arange(n, device=s.device)
    invalid = (mask[:, None, :] <= 0) | (idx[None, :] == idx[:, None])
    d2 = torch.where(invalid, BIG, _pairwise_d2(s))

    def rounds(d2):
        for _ in range(k):
            amin, dmin, d2 = _select(d2)
            yield amin, dmin
    return _aggregate(f, rounds(d2), k, scale, n)


def gravnet_aggregate_ref(s, f, mask, *, k=8, scale=10.0, out_dtype=None):
    """The standalone GravNet aggregation over a micro-batch: the cell
    fed S and F from memory, in f32. s:(B,n,ds), f:(B,n,df), mask:(B,n)
    -> (B, n, 2·df) of ``out_dtype`` (None: f's dtype)."""
    return gravnet_cell_ref(s.float(), f.float(), mask.float(), k=k,
                            scale=scale).to(out_dtype or f.dtype)


def knn_d2_ref(s, mask):
    """The distances the top-k oracle selects from: ``|s_i|² + |s_j|² −
    2·s_i·s_j`` over the rows of each event, the dots as one batched
    matrix product (the JAX oracle's ``sf @ sf.T``), clamped at 0; self
    and masked columns at 1e30. s:(B,n,ds), mask:(B,n) -> (B,n,n) f32."""
    sf = s.float()
    sq = (sf * sf).sum(dim=-1)
    d2 = torch.clamp_min(sq[:, :, None] + sq[:, None, :]
                         - 2.0 * torch.bmm(sf, sf.transpose(1, 2)), 0.0)
    eye = torch.eye(sf.shape[1], dtype=torch.bool, device=s.device)
    return torch.where((mask[:, None, :] <= 0) | eye, BIG, d2)


def knn_topk_ref(s, mask, *, k=8):
    """The k nearest valid rows of each row of its own event, by top-k
    over :func:`knn_d2_ref`, ties to the lowest column as
    ``lax.top_k``'s. An event of fewer than k rows pads its slots with
    d2 = 1e30 and index 0. s:(B,n,ds), mask:(B,n) -> (d2:(B,n,k) f32,
    idx:(B,n,k) int64)."""
    from repro_torch.nn.layers import top_k
    n = s.shape[1]
    neg, idx = top_k(-knn_d2_ref(s, mask), min(k, n))
    d2k = -neg
    if k > n:
        d2k = F.pad(d2k, (0, k - n), value=BIG)
        idx = F.pad(idx, (0, k - n))
    return d2k, idx


def gravnet_aggregate_topk_ref(s, f, mask, *, k=8, scale=10.0):
    """The JAX package's top-k + gather oracle of the GravNet aggregation
    (``repro/kernels/ref.py:gravnet_aggregate_ref``), batched over
    events: the neighbours of :func:`knn_topk_ref`, weights
    ``exp(−scale·d²)`` on the valid slots, mean over k and max (0 where
    no slot is valid). Differentiable; cast to f's dtype, as the
    reference's is. s:(B,n,ds), f:(B,n,df), mask:(B,n) ->
    (B, n, 2·df)."""
    d2k, idx = knn_topk_ref(s, mask, k=k)
    ff = f.float()
    bsz, n, df = ff.shape
    valid = d2k < BIG * 0.5
    w = torch.where(valid, torch.exp(-scale * d2k), 0.0)
    fk = torch.gather(ff, 1, idx.reshape(bsz, -1, 1).expand(-1, -1, df))
    wf = w[..., None] * fk.reshape(bsz, n, k, df)
    mean = torch.where(valid[..., None], wf, 0.0).sum(dim=2) / k
    mx = torch.where(valid[..., None], wf, -BIG).amax(dim=2)
    mx = torch.where(mx <= -BIG * 0.5, 0.0, mx)
    return torch.cat([mean, mx], dim=-1).to(f.dtype)


# ------------------------------------------------------------- ragged kNN ----
def knn_build_ref(s, segids, *, k=8):
    """Segment-masked neighbour selection over bin-packed events (the
    selection half of the cell). A candidate j is valid for row i iff
    ``seg[j] == seg[i]``, ``j != i`` and ``seg[j] >= 0``; k rounds of row
    argmin with knockout, ties to the lowest column. A slot with no
    candidate left has d2 = 1e30 and idx = 0 (the argmin of an all-1e30
    row). s:(B,n,ds) f32, segids:(B,n) int -> (idx:(B,n,k) int32,
    d2:(B,n,k) f32)."""
    seg = segids.to(torch.int32)
    n = s.shape[1]
    col = torch.arange(n, device=s.device)
    invalid = ((seg[:, None, :] != seg[:, :, None])
               | (col[None, :] == col[:, None]) | (seg[:, None, :] < 0))
    d2 = torch.where(invalid, BIG, _pairwise_d2(s.float()))
    idx_cols, d2_cols = [], []
    for _ in range(k):
        amin, dmin, d2 = _select(d2)
        idx_cols.append(amin[..., 0].to(torch.int32))
        d2_cols.append(dmin)
    return torch.stack(idx_cols, dim=2), torch.stack(d2_cols, dim=2)


def knn_aggregate_ref(f, idx, d2, *, scale=10.0, out_dtype=None):
    """Gaussian-potential mean/max over prebuilt neighbours (the
    accumulation half of the cell), in slot order, in f32. f:(B,n,df),
    idx/d2:(B,n,k) -> (B, n, 2·df) of ``out_dtype`` (None: f's dtype); a
    slot with d2 >= 0.5e30 weighs 0 and is left out of the max; a max
    that stays at −1e30 becomes 0; an index outside [0, n) selects a row
    of zeros."""
    bsz, n, k = idx.shape
    # an index outside [0, n) selects a row of zeros (the TPU kernel's
    # one-hot product): row n of the padded features
    fz = torch.cat([f.float(), f.new_zeros((bsz, 1, f.shape[2]),
                                           dtype=torch.float32)], dim=1)
    idx = torch.where((idx >= 0) & (idx < n), idx, n).long()
    rounds = ((idx[..., t, None], d2[..., t].float()) for t in range(k))
    return _aggregate(fz, rounds, k, scale, n).to(out_dtype or f.dtype)


# ---------------------------------------------------------- gravnet block ----
def gravnet_block_ref(x, mask, ws, bs, wf, bf, wo, bo, *, k=8, scale=10.0,
                      activation="relu", concat_x=True, out_dtype=None):
    """The fused GravNet block over a micro-batch, in f32: S/F
    projections -> the cell over each whole event -> act(concat(x, agg)
    @ wo + bo), or act(agg @ wo + bo) without ``concat_x`` (wo (2·df,
    d_out)). x:(B,N,dh), mask:(B,N) -> (B,N,d_out) of ``out_dtype``
    (None: x's dtype)."""
    xf = x.float()
    s = fused_dense_ref(xf, ws, bs, activation="none")
    f = fused_dense_ref(xf, wf, bf, activation="none")
    agg = gravnet_cell_ref(s, f, mask.float(), k=k, scale=scale)
    h = torch.cat([xf, agg], dim=-1) if concat_x else agg
    return fused_dense_ref(h, wo, bo, activation=activation,
                           out_dtype=out_dtype or x.dtype)


def gravnet_block_int8_ref(x, mask, ws_q, bs, wf_q, bf, wo_q, bo, ws_scale,
                           wf_scale, wo_scale, *, x_scale, agg_scale,
                           h_scale, k=8, scale=10.0, activation="relu",
                           concat_x=True, out_int8=False, out_scale=1.0):
    """The quantized GravNet block over a micro-batch, in the kernel's
    order: quantize x (f32, or bf16 widened) with ``x_scale``; int8
    S/F dots dequantized as ``acc·(x_scale·w_scale[c]) + b`` (no output
    snap); the f32 cell; snap ``agg`` to the ``agg_scale`` grid; quantize
    ``h = concat(x, agg)`` (``agg`` alone without ``concat_x``) with
    ``h_scale``; the int8 output dot with dequant, bias and activation.
    x:(B,N,dh) f32 or bf16 -> (B,N,d_out) f32, or int8 ``clip(round(y /
    out_scale), ±127)`` when ``out_int8``."""
    xf = x.float()
    xq = quantize_act(xf, x_scale)
    s = _dequant(_int_dot(xq, ws_q), bs, x_scale, ws_scale)
    f = _dequant(_int_dot(xq, wf_q), bf, x_scale, wf_scale)
    agg = gravnet_cell_ref(s, f, mask.float(), k=k, scale=scale)
    agg = torch.clamp(torch.round(div_f32(agg, agg_scale)), -QMAX,
                      QMAX) * f32(agg_scale)
    hq = quantize_act(torch.cat([xf, agg], dim=-1) if concat_x else agg,
                      h_scale)
    return fused_dense_int8_ref(hq, wo_q, bo, h_scale, wo_scale,
                                activation=activation, out_int8=out_int8,
                                out_scale=out_scale)


# --------------------------------------------------------- edge aggregate ----
def edge_aggregate_ref(messages, dst, mask, *, n_nodes, reduce="sum",
                       out_dtype=None):
    """Masked segment sum / mean of per-edge messages into their
    destination nodes, in the kernel's order, in f32. messages:(B,E,d),
    dst:(B,E) int, mask:(B,E) f32 -> (B, n_nodes, d) of ``out_dtype``
    (None: the messages' dtype), rounded once at the end.

    Each node sums ``mask[e]·msg[e]`` over its edges in increasing e,
    each product and sum rounded on its own; ``mean`` divides by
    ``max(Σ mask[e], 1)``, summed in the same order. An edge whose dst
    lies outside [0, n_nodes) contributes nothing. A stable sort by dst
    lays the edges out in per-node segments, padded with zeros to the
    largest in-degree (adding +0.0 leaves a sum unchanged), and the sums
    run over the segments' slots: no scatter (``index_add_`` sums in no
    fixed order on the card)."""
    if reduce not in ("sum", "mean"):
        raise ValueError(f"reduce must be 'sum' or 'mean', got {reduce!r}")
    bsz, e, d = messages.shape
    dev = messages.device
    key = dst.long()
    # out-of-range destinations go to an extra segment n_nodes, never read
    key = torch.where((key >= 0) & (key < n_nodes), key, n_nodes)
    skey, perm = torch.sort(key, dim=1, stable=True)
    nodes = torch.arange(n_nodes, device=dev).expand(bsz, n_nodes)
    start = torch.searchsorted(skey, nodes.contiguous())
    deg = torch.searchsorted(skey, nodes.contiguous(), right=True) - start
    mask = mask.float()
    w = mask[..., None] * messages.float()
    acc = torch.zeros((bsz, n_nodes, d), dtype=torch.float32, device=dev)
    cnt = torch.zeros((bsz, n_nodes), dtype=torch.float32, device=dev)
    for j in range(int(deg.max()) if deg.numel() else 0):
        valid = deg > j
        edge = torch.gather(perm, 1, torch.where(valid, start + j, 0))
        wj = torch.gather(w, 1, edge[..., None].expand(bsz, n_nodes, d))
        acc = acc + torch.where(valid[..., None], wj, 0.0)
        cnt = cnt + torch.where(valid, torch.gather(mask, 1, edge), 0.0)
    if reduce == "mean":
        acc = acc / torch.clamp_min(cnt, 1.0)[..., None]
    return acc.to(out_dtype or messages.dtype)


# -------------------------------------------------------- flash attention ----
def flash_attention_ref(q, k, v, *, causal=True):
    """Plain softmax attention over the whole score matrix, the
    reference's oracle. q:(BH,S,D), k/v:(BH,T,D) -> (BH,S,D); under
    ``causal`` key t joins row s when t <= s (top-left aligned), a masked
    score is -1e30."""
    d = q.shape[-1]
    s = torch.einsum("bsd,btd->bst", q.float(), k.float()) / torch.sqrt(
        torch.tensor(d, dtype=torch.float32))
    if causal:
        sq, t = q.shape[1], k.shape[1]
        mask = (torch.arange(t, device=q.device)[None, :]
                <= torch.arange(sq, device=q.device)[:, None])
        s = torch.where(mask[None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bst,btd->bsd", p, v.float()).to(q.dtype)


def _lane_butterfly(x):
    """The warp's xor butterfly (16, 8, 4, 2, 1) over the last axis of 32
    lane partials: each step adds a lane and its partner, which both
    then hold the same sum."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def flash_attention_blocked_ref(q, k, v, *, causal=True, bq=128, bk=128):
    """Blockwise attention, the plain version of ``csrc/
    flash_attention.cu``. q:(BH,S,D), k/v:(BH,T,D) f32 or bf16 with
    S % bq == 0 and T % bk == 0 -> (BH,S,D) of q's dtype, computed in f32.

    Its order of operations is its own; the kernel takes another, with
    FMAs, and is held to the float32 row against it. Per q block, the kv
    blocks of bk keys in increasing order, skipping under ``causal``
    those with ki*bk > qi*bq + bq - 1, carrying the running max m (from
    -1e30), the denominator l and the accumulator: scores as d-ordered
    sums of separately rounded products, times f32(1/√D), the causal
    fill -1e30; m_new = max(m, rowmax); p = exp(s - m_new);
    l = l·exp(m - m_new) + Σp, where Σp sums the keys c, c + 32, ... of
    each of 32 lanes in order and then the lanes by an xor butterfly;
    acc = acc·exp(m - m_new) + Σ_c p_c v_c in c order;
    out = acc / max(l, 1e-30). The q blocks that a kv block reaches are
    a suffix of the rows, so each kv block updates that suffix at once.
    The blocks change the rounding, so they are arguments."""
    out_dtype = q.dtype
    bh, s_len, d = q.shape
    t_len = k.shape[1]
    if s_len % bq or t_len % bk:
        raise ValueError(f"S={s_len}, T={t_len} are not multiples of "
                         f"bq={bq}, bk={bk}")
    dev = q.device
    q, k, v = q.float(), k.float(), v.float()
    scale = torch.tensor(1.0 / d ** 0.5, dtype=torch.float32, device=dev)
    lanes = -(-bk // 32) * 32
    m = torch.full((bh, s_len), -1e30, dtype=torch.float32, device=dev)
    den = torch.zeros((bh, s_len), dtype=torch.float32, device=dev)
    acc = torch.zeros((bh, s_len, d), dtype=torch.float32, device=dev)
    rows = torch.arange(s_len, device=dev)
    for ki in range(t_len // bk):
        col0 = ki * bk
        # the first q block that reaches this kv block
        r0 = (max(0, -(-(col0 - bq + 1) // bq)) * bq) if causal else 0
        if r0 >= s_len:
            break
        qa = q[:, r0:]
        kt, vt = k[:, col0:col0 + bk], v[:, col0:col0 + bk]
        sc = torch.zeros((bh, s_len - r0, bk), dtype=torch.float32,
                         device=dev)
        for dd in range(d):
            sc = sc + qa[:, :, dd, None] * kt[:, None, :, dd]
        sc = sc * scale
        if causal:
            cols = torch.arange(col0, col0 + bk, device=dev)
            sc = torch.where(cols[None, :] <= rows[r0:, None], sc, -1e30)
        m_prev = m[:, r0:]
        m_new = torch.maximum(m_prev, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        alpha = torch.exp(m_prev - m_new)
        pp = F.pad(p, (0, lanes - bk)).reshape(bh, s_len - r0, -1, 32)
        part = torch.zeros((bh, s_len - r0, 32), dtype=torch.float32,
                           device=dev)
        for j in range(pp.shape[2]):
            part = part + pp[:, :, j]
        psum = _lane_butterfly(part)
        pv = torch.zeros((bh, s_len - r0, d), dtype=torch.float32,
                         device=dev)
        for c in range(bk):
            pv = pv + p[:, :, c, None] * vt[:, None, c, :]
        acc[:, r0:] = acc[:, r0:] * alpha[..., None] + pv
        den[:, r0:] = den[:, r0:] * alpha + psum
        m[:, r0:] = m_new
    return (acc / torch.clamp_min(den, 1e-30)[..., None]).to(out_dtype)
