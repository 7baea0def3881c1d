"""DimeNet (Gasteiger et al., arXiv:2003.03123): directional message
passing with radial-Bessel (n_radial=6) and spherical-Fourier-Bessel
(n_spherical=7 × n_radial) bases, bilinear interaction (n_bilinear=8),
n_blocks=6, d_hidden=128.

Counterpart of ``repro/models/gnn/dimenet.py`` (config, init, apply,
loss; its ``batched_loss_fn``, which nothing calls, is the mean that
``gnn_common.train_step`` takes of a batch's losses). Messages live on
edges m_{ji}; each interaction block aggregates over triplets
(k→j→i):

    m'_{ji} = f_upd( m_{ji},  Σ_{k∈N(j)\\{i}}  f_int(m_{kj}, rbf_{ji},
                                                sbf_{kji}) )

Triplets are index pairs into the edge list (``triplets`` (2, T):
kj edge, ji edge), padded to a static budget with ``triplet_mask``.
Every array may carry a leading batch axis (a stack of graphs of one
shape): the gathers take each graph's own rows, and each edge-to-node
sum is one ``edge_aggregate`` launch for the whole batch.

Where the time goes at full width: the bilinear
``einsum("tb,th,bhg->tg")`` runs as one matmul of the (T, b·h) outer
product of the basis projection and the gathered messages with
``w_bil`` as (b·h, g), which keeps the largest intermediate at T·b·h
floats (268 MB at 65,536 triplets, h 128); the triplet-to-edge sum is
``index_add`` (T rows, past what one ``edge_aggregate`` launch takes;
the reference's is ``segment_sum``, outside any Pallas kernel), whose
atomics on the card sum in no fixed order.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import DP, TP, P, reshape
from repro_torch.models.gnn import common as C
from repro_torch.nn.init import normal_init
from repro_torch.nn.layers import (dense_apply, dense_init, dense_shape,
                                   mlp_apply, mlp_init)


@dataclasses.dataclass(frozen=True)
class DimeNetConfig:
    name: str = "dimenet"
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    cutoff: float = 5.0
    d_in: int = 0            # 0 -> one-hot species embedding
    n_species: int = 16


def param_shapes(cfg: DimeNetConfig) -> dict:
    """The reference's parameter tree, each leaf its array's shape."""
    h = cfg.d_hidden
    nsr = cfg.n_spherical * cfg.n_radial
    return {
        "embed_z": dense_shape(cfg.n_species if cfg.d_in == 0 else cfg.d_in,
                               h),
        "embed_rbf": dense_shape(cfg.n_radial, h),
        "embed_msg": dense_shape(3 * h, h),
        "out_rbf": dense_shape(cfg.n_radial, h, bias=False),
        "out_mlp": [dense_shape(h, h), dense_shape(h, 1)],
        "blocks": [{
            "w_kj": dense_shape(h, h), "w_ji": dense_shape(h, h),
            "w_rbf": dense_shape(cfg.n_radial, h, bias=False),
            "w_sbf": dense_shape(nsr, cfg.n_bilinear, bias=False),
            "w_bil": (cfg.n_bilinear, h, h),
            "w_out1": dense_shape(h, h), "w_out2": dense_shape(h, h),
        } for _ in range(cfg.n_blocks)],
    }


def init(gen: torch.Generator, cfg: DimeNetConfig) -> dict:
    """Random weights of the reference's distributions (LeCun-normal
    denses, zero biases, ``w_bil`` normal × 0.05) from ``gen``."""
    h = cfg.d_hidden
    nsr = cfg.n_spherical * cfg.n_radial
    p = {
        "embed_z": dense_init(gen, cfg.n_species if cfg.d_in == 0
                              else cfg.d_in, h),
        "embed_rbf": dense_init(gen, cfg.n_radial, h),
        "embed_msg": dense_init(gen, 3 * h, h),
        "out_rbf": dense_init(gen, cfg.n_radial, h, bias=False),
        "out_mlp": mlp_init(gen, [h, h, 1]),
        "blocks": [],
    }
    for _ in range(cfg.n_blocks):
        p["blocks"].append({
            "w_kj": dense_init(gen, h, h),
            "w_ji": dense_init(gen, h, h),
            "w_rbf": dense_init(gen, cfg.n_radial, h, bias=False),
            "w_sbf": dense_init(gen, nsr, cfg.n_bilinear, bias=False),
            "w_bil": normal_init(gen, (cfg.n_bilinear, h, h), std=0.05),
            "w_out1": dense_init(gen, h, h),
            "w_out2": dense_init(gen, h, h),
        })
    return p


def _sbf(d, angle, cfg: DimeNetConfig):
    """Spherical Fourier-Bessel-style 2D basis (n_spherical × n_radial):
    Chebyshev angular polynomials cos(l·θ) × radial Bessel — the
    reference's (documented) simplification of the exact spherical
    Bessel roots. d, angle:(..., T) -> (..., T, S·R)."""
    rbf = C.bessel_rbf(d, n_rbf=cfg.n_radial, cutoff=cfg.cutoff)
    ls = torch.arange(cfg.n_spherical, dtype=d.dtype, device=d.device)
    ang = torch.cos(angle[..., None] * ls + 0.0)                # (..,T,S)
    out = ang[..., :, None] * rbf[..., None, :]                 # (..,T,S,R)
    return out.reshape(*d.shape, cfg.n_spherical * cfg.n_radial)


def _segment_sum(x, idx, n: int):
    """``jax.ops.segment_sum`` of the rows of x:(..., T, d) into n rows
    by idx:(..., T), per graph of the leading axes: ``index_add`` (its
    backward is a gather)."""
    lead = x.shape[:-2]
    idx = idx.long()
    b = 1
    for s in lead:
        b *= s
    if lead:
        off = torch.arange(b, device=x.device).reshape(*lead, 1) * n
        idx = idx + off
    out = x.new_zeros((b * n, x.shape[-1])).index_add(
        0, idx.reshape(-1), x.reshape(-1, x.shape[-1]))
    return out.reshape(*lead, n, x.shape[-1])


# logical sharding specs of the parameters (``dist/sharding.py``)
PARAM_RULES = [
    (r"blocks/.*/w", P(DP, TP)),
    (r"embed_", P(DP, TP)),
    (r"out_", P(DP, None)),
]


def apply(params, graph, cfg: DimeNetConfig):
    """graph: ``species`` (N,) int (or ``nodes`` (N, d_in)),
    ``positions`` (N, 3), ``edge_index`` (2, E), ``triplets`` (2, T)
    [kj edge, ji edge], ``node_mask``, ``edge_mask``, ``triplet_mask``;
    each may carry a leading batch axis. Returns (energy, per-node
    energies): (...,) and (..., N)."""
    ei = graph["edge_index"]
    em = graph["edge_mask"]
    nm = graph["node_mask"]
    tm = graph["triplet_mask"]
    trip = graph["triplets"]
    n = nm.shape[-1]
    act = F.silu

    _, d, unit = C.edge_vectors(graph["positions"], ei)
    rbf = C.bessel_rbf(d, n_rbf=cfg.n_radial, cutoff=cfg.cutoff) \
        * em[..., None]

    # triplet angle between edges (k->j) and (j->i)
    t_kj, t_ji = trip[..., 0, :], trip[..., 1, :]
    u_kj = C._gather(unit, t_kj)
    u_ji = C._gather(unit, t_ji)
    cosang = C._clip((-u_kj * u_ji).sum(-1), -1.0, 1.0)
    angle = torch.arccos(cosang)
    sbf = _sbf(C._gather(d, t_kj), angle, cfg) * tm[..., None]  # (.., T, SR)

    if cfg.d_in == 0:
        z = C.one_hot(graph["species"], cfg.n_species, d.dtype)
    else:
        z = graph["nodes"]
    hz = act(dense_apply(params["embed_z"], z))                # (.., N, H)
    hrbf = act(dense_apply(params["embed_rbf"], rbf))
    m = act(dense_apply(params["embed_msg"], torch.cat(
        [C.gather_src(hz, ei), C.gather_dst(hz, ei), hrbf], -1)))
    m = m * em[..., None]                                      # (.., E, H)

    n_edges = m.shape[-2]
    energy_n = torch.zeros_like(nm, dtype=m.dtype)
    for bp in params["blocks"]:
        x_kj = act(dense_apply(bp["w_kj"], m))
        g_rbf = dense_apply(bp["w_rbf"], rbf)                  # (.., E, H)
        x_ji = act(dense_apply(bp["w_ji"], m)) * g_rbf
        # triplet interaction: gather kj messages, bilinear with sbf as
        # one matmul of the (T, b·h) outer product with w_bil (b·h, g)
        tk = C._gather(x_kj, t_kj)                             # (.., T, H)
        s8 = dense_apply(bp["w_sbf"], sbf)                     # (.., T, b)
        w_bil = bp["w_bil"]
        outer = s8[..., :, None] * tk[..., None, :]
        outer = reshape(outer, *outer.shape[:-2], -1)
        inter = outer @ reshape(w_bil, -1, w_bil.shape[-1])
        inter = inter * tm[..., None]
        agg = _segment_sum(inter, t_ji, n_edges)               # (.., E, H)
        m = m + act(dense_apply(bp["w_out1"], x_ji + agg))
        m = (m + act(dense_apply(bp["w_out2"], m))) * em[..., None]
        # output block: edge -> node with rbf gate
        contrib = C.scatter_sum(g_rbf * m, ei, n, em)
        energy_n = energy_n + mlp_apply(params["out_mlp"],
                                        act(contrib))[..., 0]
    energy_n = energy_n * nm
    return energy_n.sum(-1), energy_n


def loss_fn(params, graph, cfg: DimeNetConfig):
    """(loss, {"loss", "energy"}): the squared error of the energy, per
    graph of a batch."""
    e, _ = apply(params, graph, cfg)
    loss = (e - graph["energy"]) ** 2
    return loss, {"loss": loss, "energy": e}

