"""Decoder-only transformer family covering the five assigned LM archs.

Counterpart of ``repro/models/transformer.py``: GQA/MQA + RoPE, RMSNorm
or OLMo-style non-parametric LayerNorm, gated or plain MLP, GShard-style
top-k MoE (einsum dispatch, or scatter dispatch), blockwise causal
attention (``full``, ``scan`` over q chunks, ``unrolled_tri``), KV-cache
decode (bf16, or int8 with per-token scales), remat.

Parameters are the reference's tree: per-layer leaves stacked on a
leading ``(L, ...)`` axis, dense weights ``(d_in, d_out)``, so that
``convert.from_jax_lm_params`` copies them leaf for leaf. The layer scan
is a Python loop over the stacked leaves; ``remat`` is
``torch.utils.checkpoint`` (non-reentrant). The functions are plain
functions on tensors; nothing here launches a kernel of the port (the
attention is an einsum softmax, as in the reference).

Sharding: ``PARAM_RULES`` and :func:`cache_specs` are the reference's
logical specs. With a ``mesh`` (a ``DeviceMesh``, the arguments DTensors
placed on it) the reference's ``with_sharding_constraint`` points
become ``redistribute`` (:func:`_cst`), including its attention policy
by the model axis' extent and ``seq_parallel``; the einsums, the
embedding lookup and the loss's pick of the labels' logits (the
vocabulary split) run on local shards (``dist.sharding``), and so does
the decode's cache write (:func:`_update`). With plain tensors none of
this runs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.dist.sharding import (DP, TP, P, axis_sizes, constrain,
                                       einsum, embedding, is_distributed,
                                       reshape, shard_index)
from repro_torch.nn.init import truncated_normal
from repro_torch.nn.layers import (nonparametric_layernorm, rmsnorm_apply,
                                   top_k)

@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    group_size: int = 512
    dispatch: str = "einsum"       # 'einsum' (GShard) | 'scatter'
    shared_experts: int = 0
    vmap_groups: bool = False      # the reference's lowering option;
                                   # groups run batched here either way


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                 # 0 -> d_model // n_heads
    norm: str = "rmsnorm"           # 'rmsnorm' | 'nonparametric'
    gated_mlp: bool = True
    activation: str = "silu"
    moe: MoEConfig | None = None
    rope_theta: float = 500000.0
    block_q: int = 512              # attention q-chunk
    attn_mode: str = "scan"         # 'full' | 'scan' | 'unrolled_tri'
    remat: bool = True
    remat_policy: str = "full"      # 'full' | 'dots' (save the matrix
                                    # products, recompute the rest)
    seq_parallel: bool = False      # shard the residual stream's seq dim
                                    # over tp between blocks
    unroll_layers: bool = False     # the reference's lowering option;
                                    # the layers are a Python loop here
    loss_chunk: int = 1024          # CE computed in seq chunks
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    kv_cache_int8: bool = False     # int8 KV cache w/ per-token scales

    @property
    def dh(self) -> int:
        return self.d_head or self.d_model // self.n_heads


# ------------------------------------------------------------------ params ----
def _layer_shapes(cfg: TransformerConfig):
    d, dh = cfg.d_model, cfg.dh
    s = {
        "wq": (d, cfg.n_heads * dh),
        "wk": (d, cfg.n_kv_heads * dh),
        "wv": (d, cfg.n_kv_heads * dh),
        "wo": (cfg.n_heads * dh, d),
    }
    if cfg.norm == "rmsnorm":
        s["attn_norm"] = (d,)
        s["ffn_norm"] = (d,)
    if cfg.moe is None:
        s["w_up"] = (d, cfg.d_ff)
        s["w_down"] = (cfg.d_ff, d)
        if cfg.gated_mlp:
            s["w_gate"] = (d, cfg.d_ff)
    else:
        e = cfg.moe.n_experts
        s["router"] = (d, e)
        s["moe_up"] = (e, d, cfg.d_ff)
        s["moe_down"] = (e, cfg.d_ff, d)
        if cfg.gated_mlp:
            s["moe_gate"] = (e, d, cfg.d_ff)
        if cfg.moe.shared_experts:
            f_sh = cfg.d_ff * cfg.moe.shared_experts
            s["sh_up"] = (d, f_sh)
            s["sh_down"] = (f_sh, d)
            if cfg.gated_mlp:
                s["sh_gate"] = (d, f_sh)
    return s


def abstract_params(cfg: TransformerConfig) -> dict:
    """The parameter tree's shapes (tuples), the layers' stacked."""
    L = cfg.n_layers
    return {
        "embed": (cfg.vocab, cfg.d_model),
        "layers": {k: (L, *v) for k, v in _layer_shapes(cfg).items()},
        "final_norm": (cfg.d_model,),
        "lm_head": (cfg.d_model, cfg.vocab),
    }


def init_params(gen: torch.Generator, cfg: TransformerConfig) -> dict:
    """Random weights (``param_dtype``) on the generator's device: norms
    ones, every other leaf a normal truncated at ±2 of std
    1/sqrt(fan_in), fan_in the second-to-last axis."""
    def mk(shape):
        if len(shape) == 1:
            return torch.ones(shape, dtype=cfg.param_dtype,
                              device=gen.device)
        return truncated_normal(gen, shape, std=1.0 / math.sqrt(shape[-2]),
                                dtype=cfg.param_dtype)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(tree[k]) for k in sorted(tree)}
        return mk(tree)
    return walk(abstract_params(cfg))


PARAM_RULES = [
    (r"embed", P(TP, DP)),
    (r"lm_head", P(DP, TP)),
    (r"final_norm", P()),
    (r"(attn|ffn)_norm", P(None)),
    (r"layers/w[qkv]$", P(None, DP, TP)),
    (r"layers/wo", P(None, TP, DP)),
    (r"layers/w_(gate|up)", P(None, DP, TP)),
    (r"layers/w_down", P(None, TP, DP)),
    (r"layers/router", P(None, DP, None)),
    (r"layers/moe_(gate|up)", P(None, TP, DP, None)),
    (r"layers/moe_down", P(None, TP, None, DP)),
    (r"layers/sh_(gate|up)", P(None, DP, TP)),
    (r"layers/sh_down", P(None, TP, DP)),
]


def _cst(x, mesh, *axes):
    """``with_sharding_constraint`` with logical axis names."""
    return constrain(x, mesh, *axes)


# --------------------------------------------------------------- attention ----
def _rope(x, positions, theta):
    """x: (..., S, H, Dh); positions: (..., S)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device)
                      * (math.log(theta) / half))
    ang = positions[..., None].to(torch.float32) * freqs    # (..., S, half)
    ang = ang[..., None, :]                                  # (..., S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


def _attn_chunk(q, k, v, q_off, *, causal, lengths=None):
    """q: (B,Bq,Kv,G,Dh)  k,v: (B,T,Kv,Dh) -> (B,Bq,Kv,G,Dh).

    Grouped-query attention without repeating the KV heads. The scores
    are f32 (the reference's ``preferred_element_type``: q and k are
    upcast, since a bf16 einsum here would round its output to bf16);
    the probabilities go back to q's dtype for the product with v.
    ``q_off`` is the absolute position of q[0] (causal masking);
    ``lengths`` (B,) masks a KV cache during decode."""
    dh = q.shape[-1]
    scores = einsum("bqkgd,btkd->bkgqt", q.to(torch.float32),
                    k.to(torch.float32))
    scores = scores / math.sqrt(dh)
    t_idx = torch.arange(k.shape[1], device=q.device)
    if causal:
        q_idx = q_off + torch.arange(q.shape[1], device=q.device)
        mask = t_idx[None, :] <= q_idx[:, None]              # (Bq, T)
        scores = torch.where(mask[None, None, None], scores, -1e30)
    if lengths is not None:
        lm = t_idx[None, :] < lengths[:, None]               # (B, T)
        scores = torch.where(lm[:, None, None, None], scores, -1e30)
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    return einsum("bkgqt,btkd->bqkgd", p, v)


def attention(q, k, v, cfg: TransformerConfig, *, causal=True, q_off=0,
              lengths=None, mode=None):
    """q: (B,S,Kv,G,Dh), k/v: (B,T,Kv,Dh)."""
    mode = mode or cfg.attn_mode
    b, s = q.shape[:2]
    bq = min(cfg.block_q, s)
    if mode == "full" or s <= bq:
        return _attn_chunk(q, k, v, q_off, causal=causal, lengths=lengths)
    assert s % bq == 0, (s, bq)
    nq = s // bq
    if mode == "unrolled_tri":
        # exact triangular FLOPs: kv sliced per chunk
        outs = []
        for i in range(nq):
            hi = (i + 1) * bq
            outs.append(_attn_chunk(q[:, i * bq:hi], k[:, :hi], v[:, :hi],
                                    q_off + i * bq, causal=causal,
                                    lengths=lengths))
        return torch.cat(outs, dim=1)
    assert mode == "scan", mode
    outs = [_attn_chunk(q[:, i * bq:(i + 1) * bq], k, v, q_off + i * bq,
                        causal=causal, lengths=lengths) for i in range(nq)]
    return torch.cat(outs, dim=1)


# --------------------------------------------------------------------- MoE ----
def _one_hot(idx, n, dtype=torch.float32):
    """``jax.nn.one_hot``: an index outside [0, n) gives a row of
    zeros."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _route(x, lp, k):
    """Router probabilities (f32) and the top-k experts of each token,
    their weights normalised to sum 1."""
    logits = x.to(torch.float32) @ lp["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = top_k(probs, k)
    topv = topv / torch.clamp_min(topv.sum(-1, keepdim=True), 1e-9)
    return probs, topv, topi


def _capacity(mo: MoEConfig, tokens: int) -> int:
    """Slots per expert for ``tokens`` routed together."""
    return max(4, int(math.ceil(mo.top_k * tokens * mo.capacity_factor
                                / mo.n_experts)))


def _einsum_slots(topi, e, cap):
    """The einsum dispatch's queues, per group: the one-hot experts
    (G,gs,k,E) f32, each (token, slot)'s rank in its expert's queue
    (token-major, slot-major within a token; f32 cumsum as the
    reference) and whether it fits the capacity (f32)."""
    ng, gs, k = topi.shape
    oh = _one_hot(topi, e)
    flat = oh.reshape(ng, gs * k, e)
    pos = torch.cumsum(flat, dim=1) - flat                    # rank in queue
    pos = (pos * flat).sum(-1).reshape(ng, gs, k).to(torch.int32)
    return oh, pos, (pos < cap).to(torch.float32)


def _scatter_slots(topi, e, cap):
    """The scatter dispatch's queue over all tokens: the flat experts
    (T*k,), each slot's rank in its expert's queue (int32 cumsum) and
    whether it fits the capacity (bool)."""
    fe = topi.reshape(-1)
    oh = _one_hot(fe, e, torch.int32)
    pos = torch.cumsum(oh, dim=0, dtype=torch.int32) - oh
    pos = (pos * oh).sum(-1)
    return fe, pos, pos < cap


def moe_dropped(x, lp, cfg: TransformerConfig) -> torch.Tensor:
    """How many (token, slot) assignments of the MoE input ``x`` (T, D)
    the config's dispatch drops for want of capacity (a 0-dim int64
    tensor), counted by that dispatch's own queue."""
    mo = cfg.moe
    lp = {n: a.to(cfg.compute_dtype) for n, a in lp.items()}
    x = x.to(cfg.compute_dtype)
    if mo.dispatch == "scatter":
        _, _, topi = _route(x, lp, mo.top_k)
        _, _, keep = _scatter_slots(topi, mo.n_experts,
                                    _capacity(mo, x.shape[0]))
        return (~keep).sum()
    gs = min(mo.group_size, x.shape[0])
    _, _, topi = _route(x.reshape(-1, gs, x.shape[1]), lp, mo.top_k)
    _, _, keep = _einsum_slots(topi, mo.n_experts, _capacity(mo, gs))
    return (keep == 0).sum()


def _shared(x, lp, cfg):
    up = x @ lp["sh_up"]
    h = (_act(cfg)(x @ lp["sh_gate"]) * up if cfg.gated_mlp
         else _act(cfg)(up))
    return h @ lp["sh_down"]


def _experts(xe, lp, cfg):
    """The experts' MLPs over their buffers (..., E, C, D)."""
    up = einsum("...ecd,edf->...ecf", xe, lp["moe_up"])
    if cfg.gated_mlp:
        gate = einsum("...ecd,edf->...ecf", xe, lp["moe_gate"])
        h = _act(cfg)(gate) * up
    else:
        h = _act(cfg)(up)
    return einsum("...ecf,efd->...ecd", h, lp["moe_down"])


def _moe_einsum(x, lp, cfg: TransformerConfig, mesh=None):
    """GShard-style einsum dispatch. x: (T, D) -> (T, D), aux. The
    reference maps its group function over the groups; here the groups
    are a leading batch axis (the same math per group). The dispatch and
    combine tensors hold 0/1 and one weight a slot, so their products are
    exact in any order."""
    mo = cfg.moe
    t, d = x.shape
    gs = min(mo.group_size, t)
    ng = t // gs
    xg = x.reshape(ng, gs, d)
    e, k = mo.n_experts, mo.top_k
    cap = _capacity(mo, gs)
    probs, topv, topi = _route(xg, lp, k)                     # (G, gs, ·)
    oh, pos, keep = _einsum_slots(topi, e, cap)
    posh = _one_hot(pos, cap)                                 # (G,gs,k,C)
    disp = einsum("gske,gskc->gsec", oh, posh * keep[..., None])
    comb = disp * einsum("gsk,gske->gse", topv * keep, oh)[..., None]
    xe = einsum("gsec,gsd->gecd", disp.to(cfg.compute_dtype), xg)
    ye = _experts(xe, lp, cfg)                                # (G,E,C,D)
    out = einsum("gsec,gecd->gsd", comb.to(cfg.compute_dtype), ye)
    # aux load-balancing loss (Switch): mean(prob_e * frac_e) * E
    frac = oh.sum(2).mean(1)                                  # (G, E)
    aux = ((probs.mean(1) * frac).sum(-1) * e).mean()
    y = out.reshape(t, d)
    if mo.shared_experts:
        y = y + _shared(x, lp, cfg)
    return y, aux


def _moe_scatter(x, lp, cfg: TransformerConfig, mesh=None):
    """Sort/scatter dispatch: O(T·k·D) data movement, no dispatch
    einsum FLOPs. A token beyond an expert's capacity adds zeros to the
    last slot of the last expert (``index_put_`` accumulating), as the
    reference's ``.at[].add`` does; the combine is ``index_add_``."""
    mo = cfg.moe
    t, d = x.shape
    e, k = mo.n_experts, mo.top_k
    cap = _capacity(mo, t)
    probs, topv, topi = _route(x, lp, k)
    fe, pos, keep = _scatter_slots(topi, e, cap)
    fw = topv.reshape(-1)
    ft = torch.arange(t, device=x.device).repeat_interleave(k)
    buf = torch.zeros((e, cap, d), dtype=cfg.compute_dtype, device=x.device)
    buf = buf.index_put(
        (torch.where(keep, fe, e - 1), torch.where(keep, pos, cap - 1)),
        x[ft] * keep[:, None].to(cfg.compute_dtype), accumulate=True)
    ye = _experts(buf, lp, cfg)                               # (E,C,D)
    gathered = ye[torch.where(keep, fe, 0), torch.where(keep, pos, 0)]
    contrib = gathered * (fw * keep)[:, None].to(cfg.compute_dtype)
    y = torch.zeros((t, d), dtype=contrib.dtype, device=x.device
                    ).index_add(0, ft, contrib)
    frac = _one_hot(topi, e).sum(1).mean(0)
    aux = (probs.mean(0) * frac).sum() * e
    if mo.shared_experts:
        y = y + _shared(x, lp, cfg)
    return y, aux


# ------------------------------------------------------------------- layer ----
def _act(cfg):
    # jax.nn.gelu is the tanh approximation by default
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[cfg.activation]


def _norm(lp, name, x, cfg):
    if cfg.norm == "nonparametric":
        return nonparametric_layernorm(x)
    return rmsnorm_apply({"scale": lp[f"{name}_norm"]}, x)


def quantize_kv(u):
    """(int8 values, f32 scales) of k or v (B,s,Kv,Dh): one scale per
    token and head, max|u|/127 (at least 1e-8), values rounded half to
    even and clipped to ±127, as the reference's decode quantizes
    them. The divisors are tensors, so that the card divides (a Python
    scalar divisor is a product with its reciprocal there)."""
    amax = torch.amax(torch.abs(u), dim=-1, keepdim=True)
    sc = amax / torch.full((), 127.0, dtype=amax.dtype, device=u.device)
    sc = torch.clamp_min(sc, 1e-8)
    qv = torch.clamp(torch.round(u / sc), -127, 127).to(torch.int8)
    return qv, sc[..., 0].to(torch.float32)


def _update(c, u, p, in_place):
    """``jax.lax.dynamic_update_slice`` of ``u`` (B,s,...) into ``c``
    (B,T,...) at row ``p`` (B,) of each batch entry, the start clamped
    to [0, T - s] so that the update fits. ``p`` stays on the device
    (no host sync). A copy of ``c`` unless ``in_place``. A DTensor
    cache is written on each shard (:func:`_update_sharded`)."""
    if is_distributed(c):
        return _update_sharded(c, u, p, in_place)
    b, s = u.shape[:2]
    start = torch.clamp(p, 0, c.shape[1] - s).to(torch.long)
    rows = start[:, None] + torch.arange(s, device=c.device)
    bidx = torch.arange(b, device=c.device)[:, None]
    out = c if in_place else c.clone()
    out[bidx, rows] = u.to(c.dtype)
    return out


def _update_sharded(c, u, p, in_place):
    """:func:`_update` on the local shards of a DTensor cache ``c``
    (B,T,...): the update and positions follow its batch sharding; where
    T is sharded (``seq_shard``), each shard writes the rows it holds
    (its offset from the mesh coordinate) and no others."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = c.device_mesh
    cpl = tuple(c.placements)
    upl = tuple(Replicate() if pl == Shard(1) else pl for pl in cpl)
    ppl = tuple(pl if pl == Shard(0) else Replicate() for pl in cpl)
    t_dims = [m for m, pl in enumerate(cpl) if pl == Shard(1)]

    def local(cl, ul, pl_):
        if not t_dims:
            return _update(cl, ul, pl_, in_place)
        shard = shard_index(mesh, t_dims)
        t_loc = cl.shape[1]
        b, s = ul.shape[:2]
        start = torch.clamp(pl_, 0, t_loc * math.prod(mesh.size(m) for m in
                                                      t_dims) - s)
        rows = (start[:, None] + torch.arange(s, device=cl.device)
                - shard * t_loc).to(torch.long)
        held = (rows >= 0) & (rows < t_loc)
        rows = torch.clamp(rows, 0, t_loc - 1)
        bidx = torch.arange(b, device=cl.device)[:, None]
        out = cl if in_place else cl.clone()
        held = held.reshape(*held.shape, *([1] * (ul.ndim - 2)))
        out[bidx, rows] = torch.where(held, ul.to(cl.dtype), out[bidx, rows])
        return out

    return local_map(local, out_placements=(cpl,),
                     in_placements=(cpl, upl, ppl), device_mesh=mesh,
                     redistribute_inputs=True)(c, u, p)


def layer_fwd(lp, x, cfg: TransformerConfig, mesh=None, *, positions=None,
              cache=None, attn_mode=None, return_kv=False,
              cache_in_place=False):
    """One transformer layer. x: (B,S,D). cache: None or dict with
    k/v (B,T,Kv,Dh) (+ k_scale/v_scale (B,T,Kv) for the int8 cache) +
    'pos' (B,) for decode. Returns (y, aux, new_cache); with
    ``cache_in_place`` the update is written into the cache's tensors
    (``decode_step`` hands it fresh copies)."""
    b, s, d = x.shape
    kv, dh = cfg.n_kv_heads, cfg.dh
    g = cfg.n_heads // kv
    lp = {n: a.to(cfg.compute_dtype) if a.dtype != torch.int8 else a
          for n, a in lp.items()}
    xc = x.to(cfg.compute_dtype)
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None, :]

    h = _norm(lp, "attn", xc, cfg)
    q = reshape(h @ lp["wq"], b, s, kv, g, dh)
    k = reshape(h @ lp["wk"], b, s, kv, dh)
    v = reshape(h @ lp["wv"], b, s, kv, dh)
    # Attention-internal sharding policy (the reference's):
    #   decode (s==1): shard d_head — consistent with the cache specs.
    #   prefill/train: kv-shard if divisible; else group-shard; else
    #     repeat kv to flat heads (H=kv·g) when that divides; else
    #     replicate attention internals over tp.
    tp_n = max(axis_sizes(mesh).get("model", 1)
               if mesh is not None else 1, 1)
    flat_g = None
    if cache is not None or s == 1:
        q = _cst(q, mesh, DP, None, None, None, TP)
        k = _cst(k, mesh, DP, None, None, TP)
        v = _cst(v, mesh, DP, None, None, TP)
    elif kv % tp_n == 0:
        q = _cst(q, mesh, DP, None, TP, None, None)
        k = _cst(k, mesh, DP, None, TP, None)
        v = _cst(v, mesh, DP, None, TP, None)
    elif g % tp_n == 0:
        q = _cst(q, mesh, DP, None, None, TP, None)
        k = _cst(k, mesh, DP, None, None, None)
        v = _cst(v, mesh, DP, None, None, None)
    elif (kv * g) % tp_n == 0:
        # flat-head form: repeat kv, attend as MHA sharded on H
        flat_g = g
        k = torch.repeat_interleave(k, g, dim=2)
        v = torch.repeat_interleave(v, g, dim=2)
        q = q.reshape(b, s, kv * g, 1, dh)
        kv, g = kv * g, 1
        q = _cst(q, mesh, DP, None, TP, None, None)
        k = _cst(k, mesh, DP, None, TP, None)
        v = _cst(v, mesh, DP, None, TP, None)
    else:
        q = _cst(q, mesh, DP, None, None, None, None)
        k = _cst(k, mesh, DP, None, None, None)
        v = _cst(v, mesh, DP, None, None, None)
    q = reshape(_rope(reshape(q, b, s, kv * g, dh), positions,
                       cfg.rope_theta), b, s, kv, g, dh)
    k = _rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None:
        # decode: append into the cache at pos, attend with length mask
        pos = cache["pos"]                                    # (B,)
        if cfg.kv_cache_int8:
            kq, ks_ = quantize_kv(k)
            vq, vs_ = quantize_kv(v)
            ck_q = _update(cache["k"], kq, pos, cache_in_place)
            cv_q = _update(cache["v"], vq, pos, cache_in_place)
            cks = _update(cache["k_scale"], ks_, pos, cache_in_place)
            cvs = _update(cache["v_scale"], vs_, pos, cache_in_place)
            ck = (ck_q.to(cfg.compute_dtype)
                  * cks[..., None].to(cfg.compute_dtype))
            cv = (cv_q.to(cfg.compute_dtype)
                  * cvs[..., None].to(cfg.compute_dtype))
            new_cache = {"k": ck_q, "v": cv_q, "k_scale": cks,
                         "v_scale": cvs, "pos": pos + s}
        else:
            ck = _update(cache["k"], k, pos, cache_in_place)
            cv = _update(cache["v"], v, pos, cache_in_place)
            new_cache = {"k": ck, "v": cv, "pos": pos + s}
        o = _attn_chunk(q, ck, cv, 0, causal=False, lengths=pos + s)
    else:
        o = attention(q, k, v, cfg, causal=True, mode=attn_mode)
        if return_kv:
            # post-RoPE k/v, the decode convention; under the flat-head
            # repeat, the unrepeated kv heads (every flat_g-th)
            new_cache = ((k[:, :, ::flat_g], v[:, :, ::flat_g]) if flat_g
                         else (k, v))
    o = reshape(o, b, s, kv * g * dh)
    xc = xc + (o @ lp["wo"])
    xc = _cst(xc, mesh, DP, TP if cfg.seq_parallel and s > 1 else None,
              None)

    h = _norm(lp, "ffn", xc, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.moe is None:
        up = h @ lp["w_up"]
        if cfg.gated_mlp:
            ff = _act(cfg)(h @ lp["w_gate"]) * up
        else:
            ff = _act(cfg)(up)
        ff = _cst(ff, mesh, DP, None, TP)
        y = ff @ lp["w_down"]
    else:
        fn = _moe_scatter if cfg.moe.dispatch == "scatter" else _moe_einsum
        y2d, aux = fn(h.reshape(b * s, d), lp, cfg, mesh)
        y = y2d.reshape(b, s, d)
    xc = xc + y
    xc = _cst(xc, mesh, DP, TP if cfg.seq_parallel and s > 1 else None,
              None)
    return xc.to(x.dtype), aux, new_cache


# -------------------------------------------------------------- full model ----
def _layers(params, n_layers):
    """Each layer's leaves, sliced from the stacked (L, ...) ones by one
    ``unbind`` a leaf: its gradient is one stack, where indexing each
    layer out of a leaf would add L full-size gradients."""
    cols = {n: torch.unbind(a, 0) for n, a in params["layers"].items()}
    return [{n: c[i] for n, c in cols.items()} for i in range(n_layers)]


def _final_norm(params, x, cfg):
    if cfg.norm == "nonparametric":
        return nonparametric_layernorm(x)
    return rmsnorm_apply({"scale": params["final_norm"].to(
        cfg.compute_dtype)}, x)


def _embed(params, tokens, cfg):
    # F.embedding: its gradient sums each row's tokens in a fixed order
    # (an indexing's accumulating backward on the CPU does not)
    return embedding(params["embed"], tokens).to(cfg.compute_dtype)


def _remat_context(cfg):
    """'dots': keep the matrix products, recompute the rest (the
    reference's ``dots_with_no_batch_dims_saveable``); 'full': keep
    nothing."""
    if cfg.remat_policy != "dots":
        return {}
    ops = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]
    return {"context_fn": lambda: create_selective_checkpoint_contexts(ops)}


def forward(params, tokens, cfg: TransformerConfig, mesh=None):
    """tokens: (B,S) -> final hidden states (B,S,D) + aux loss."""
    x = _embed(params, tokens, cfg)
    x = _cst(x, mesh, DP, TP if cfg.seq_parallel else None, None)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    ctx = _remat_context(cfg)

    def body(lp, x):
        y, a, _ = layer_fwd(lp, x, cfg, mesh)
        return y, a

    for lp in _layers(params, cfg.n_layers):
        if remat:
            # no RNG in a layer: nothing to preserve (and a CUDA graph
            # capture cannot read the generator's state)
            x, a = checkpoint(body, lp, x, use_reentrant=False,
                              preserve_rng_state=False, **ctx)
        else:
            x, a = body(lp, x)
        aux = aux + a
    return _final_norm(params, x, cfg), aux / cfg.n_layers


def loss_fn(params, batch, cfg: TransformerConfig, mesh=None):
    """Chunked cross-entropy (+ 0.01·aux); batch: {'tokens','labels'}
    (B,S). Returns (loss, {'ce', 'aux'})."""
    x, aux = forward(params, batch["tokens"], cfg, mesh)
    head = params["lm_head"].to(cfg.compute_dtype)
    b, s, d = x.shape
    ck = min(cfg.loss_chunk, s)
    nc = s // ck
    labels = batch["labels"].to(torch.long)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(nc):
        xb = x[:, c * ck:(c + 1) * ck]
        yb = labels[:, c * ck:(c + 1) * ck]
        logits = (xb @ head).to(torch.float32)
        logits = _cst(logits, mesh, DP, None, TP)
        logz = torch.logsumexp(logits, dim=-1)
        gold = _gold(logits, yb)
        tot = tot + (logz - gold).sum()
    ce = tot / (b * s)
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


def _gold(logits, labels):
    """``logits`` (B,c,V) at ``labels`` (B,c). A DTensor sharded on V
    is picked on each shard (the label's row where the shard holds it,
    zero elsewhere: a ``Partial`` sum over those mesh dims)."""
    if not is_distributed(logits):
        return torch.gather(logits, -1, labels[..., None])[..., 0]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = logits.device_mesh
    lpl = tuple(logits.placements)
    v_dims = [m for m, pl in enumerate(lpl) if pl == Shard(2)]
    ypl = tuple(pl if pl in (Shard(0), Shard(1)) else Replicate()
                for pl in lpl)
    opl = tuple(Partial() if m in v_dims else ypl[m]
                for m in range(len(lpl)))

    def local(lg, y):
        y = y - shard_index(mesh, v_dims) * lg.shape[-1]
        held = (y >= 0) & (y < lg.shape[-1])
        picked = torch.gather(lg, -1, torch.clamp(y, 0, lg.shape[-1] - 1
                                                  )[..., None])[..., 0]
        return torch.where(held, picked, torch.zeros_like(picked))

    return local_map(local, out_placements=(opl,), in_placements=(lpl, ypl),
                     device_mesh=mesh, redistribute_inputs=True)(
        logits, labels)


def prefill(params, tokens, cfg: TransformerConfig, mesh=None):
    """Process a full prompt: returns (last-position logits (B,V) f32,
    cache), the cache's k/v stacked over layers, (L, B, S, Kv, Dh) in
    the compute dtype, ready for ``decode_step``."""
    b, s = tokens.shape
    x = _embed(params, tokens, cfg)
    x = _cst(x, mesh, DP, None, None)
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :]
    ks, vs = [], []
    for lp in _layers(params, cfg.n_layers):
        x, _, (k, v) = layer_fwd(lp, x, cfg, mesh, positions=positions,
                                 return_kv=True)
        ks.append(k)
        vs.append(v)
    x = _final_norm(params, x, cfg)
    logits = x[:, -1] @ params["lm_head"].to(cfg.compute_dtype)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs),
             "pos": torch.full((cfg.n_layers, b), s, dtype=torch.int32,
                               device=x.device)}
    return logits.to(torch.float32), cache


# ------------------------------------------------------------------ decode ----
def cache_specs(cfg: TransformerConfig, *, seq_shard: bool = False):
    """Specs for the KV cache. ``seq_shard=True`` shards the sequence
    axis over dp (flash-decoding style; for long_500k batch=1)."""
    if seq_shard:
        kvspec = P(None, None, DP, TP, None)
    else:
        kvspec = P(None, DP, None, TP, None)
    return {"k": kvspec, "v": kvspec, "pos": P(None, None)}


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               dtype=None, device=None):
    """An empty cache on ``device`` (None: the card; ``"cpu"`` asks for
    the CPU): k/v in ``dtype`` (default the compute dtype), or int8 with
    f32 per-token scales under ``kv_cache_int8``; 'pos' (L, B) int32."""
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    dtype = dtype or cfg.compute_dtype
    kv, dh, L = cfg.n_kv_heads, cfg.dh, cfg.n_layers

    def z(shape, dt):
        return torch.zeros(shape, dtype=dt, device=dev)
    if cfg.kv_cache_int8:
        return {
            "k": z((L, batch, max_len, kv, dh), torch.int8),
            "v": z((L, batch, max_len, kv, dh), torch.int8),
            "k_scale": z((L, batch, max_len, kv), torch.float32),
            "v_scale": z((L, batch, max_len, kv), torch.float32),
            "pos": z((L, batch), torch.int32),
        }
    return {
        "k": z((L, batch, max_len, kv, dh), dtype),
        "v": z((L, batch, max_len, kv, dh), dtype),
        "pos": z((L, batch), torch.int32),
    }


def decode_step(params, cache, tokens, cfg: TransformerConfig, mesh=None):
    """tokens: (B, 1) -> (logits (B,V) f32, new_cache). The cache given
    is left as it is: its k/v (and scales) are copied once and each
    layer writes its token into its slice of the copy
    (:func:`decode_step_in_place` writes into the cache given)."""
    new = {n: t.clone() for n, t in cache.items() if n != "pos"}
    new["pos"] = cache["pos"]
    logits, new["pos"] = _decode(params, new, tokens, cfg, mesh)
    return logits, new


def decode_step_in_place(params, cache, tokens, cfg: TransformerConfig):
    """:func:`decode_step` with the cache updated in place (its k/v and
    scales written, its 'pos' tensor advanced): the captured decode
    cell's step, which keeps the cache as its static buffer. Returns the
    logits (B,V) f32."""
    logits, pos = _decode(params, cache, tokens, cfg, None)
    cache["pos"].copy_(pos)
    return logits


def _decode(params, cache, tokens, cfg, mesh):
    """The decode's layers, each writing its token into ``cache``'s k/v
    in place: (logits, the advanced 'pos')."""
    x = _embed(params, tokens, cfg)                   # (B,1,D)
    positions = cache["pos"][0][:, None]              # (B,1) absolute pos
    for i, lp in enumerate(_layers(params, cfg.n_layers)):
        ci = {n: t[i] for n, t in cache.items() if n != "pos"}
        ci["pos"] = cache["pos"][i]
        x, _, _ = layer_fwd(lp, x, cfg, mesh, positions=positions,
                            cache=ci, cache_in_place=True)
    new_pos = cache["pos"] + tokens.shape[1]
    x = _final_norm(params, x, cfg)
    logits = x[:, 0] @ params["lm_head"].to(cfg.compute_dtype)
    return logits.to(torch.float32), new_pos


def layer_decode(lp, x, cache_l, cfg: TransformerConfig, mesh=None):
    """One layer's decode (the roofline composition's unit)."""
    positions = cache_l["pos"][:, None]
    return layer_fwd(lp, x, cfg, mesh, positions=positions, cache=cache_l)


def model_flops(cfg: TransformerConfig, batch: int, seq: int,
                *, training: bool, decode: bool = False,
                kv_len: int = 0) -> float:
    """Analytic MODEL_FLOPS: 6·N·D (dense) / 6·N_active·D (MoE) style,
    attention added explicitly."""
    d, dh = cfg.d_model, cfg.dh
    tok = batch * seq
    per_layer = 2 * d * (cfg.n_heads + 2 * cfg.n_kv_heads) * dh \
        + 2 * cfg.n_heads * dh * d
    if cfg.moe is None:
        per_layer += 2 * d * cfg.d_ff * (3 if cfg.gated_mlp else 2)
    else:
        per_layer += 2 * d * cfg.d_ff * (3 if cfg.gated_mlp else 2) \
            * (cfg.moe.top_k + cfg.moe.shared_experts)
        per_layer += 2 * d * cfg.moe.n_experts  # router
    attn_ctx = kv_len if decode else seq / 2  # causal average
    attn = 2 * 2 * cfg.n_heads * dh * attn_ctx
    embed_head = 2 * d * cfg.vocab  # lm head matmul (embed is gather)
    fwd = tok * (cfg.n_layers * (per_layer + attn) + embed_head)
    return fwd * (3.0 if training else 1.0)
