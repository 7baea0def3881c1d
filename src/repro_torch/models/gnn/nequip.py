"""NequIP (Batzner et al., arXiv:2101.03164): E(3)-equivariant interatomic
potential. Config: 5 layers, 32 channels, l_max=2, n_rbf=8, cutoff=5 Å.

Counterpart of ``repro/models/gnn/nequip.py`` (irreps, config, paths,
init, apply, the loss with its optional force term, forces). Features
are direct sums of irreps (l, parity) with equal multiplicity: hidden =
32×(0,+) ⊕ 32×(1,−) ⊕ 32×(2,+). An interaction layer computes, per
edge, the tensor product of source features with spherical harmonics of
the edge direction (filter parity (−1)^l2), weighted channel-wise by an
MLP of the radial basis ("uvu" connectivity), sums the messages into the
destination nodes, then applies a linear self-interaction per irrep and
a gate nonlinearity (scalars: SiLU; l>0: sigmoid-gated by dedicated
scalar channels). Energies are the sum of per-atom scalar readouts;
forces are −∂E/∂positions by autograd.

Each path's node sum is one ``edge_aggregate`` launch: its (E, m, 2·l3+1)
contribution flattened to (E, m·(2·l3+1)), no mask (the radial weight
carries ``edge_mask`` through the cutoff envelope), 11 launches a layer
at l_max 2. The kernel's autograd function has a gather for its
backward, itself differentiable, so the force term's second-order
gradient passes through it. Every array may carry a leading batch axis
(a stack of graphs of one shape); a scatter is then one launch for the
whole batch.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import DP, TP, P, einsum, reshape
from repro_torch.models.gnn import common as C
from repro_torch.models.gnn.sph import intertwiner, intertwiner_tensor, \
    real_sph
from repro_torch.nn.layers import (dense_apply, dense_init, dense_shape,
                                   mlp_apply, mlp_init)

# hidden irreps: (l, parity)
IRREPS = ((0, 1), (1, -1), (2, 1))


@dataclasses.dataclass(frozen=True)
class NequIPConfig:
    name: str = "nequip"
    n_layers: int = 5
    mult: int = 32              # channels per irrep ("d_hidden=32")
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    n_species: int = 16
    radial_hidden: int = 64


def _paths(cfg: NequIPConfig):
    """The hidden irreps and the allowed (l1,p1) ⊗ Y_l2 -> (l3,p3)
    tensor-product paths, in the reference's order."""
    irreps = [ir for ir in IRREPS if ir[0] <= cfg.l_max]
    paths = []
    for (l1, p1) in irreps:
        for l2 in range(cfg.l_max + 1):
            p2 = (-1) ** l2
            for (l3, p3) in irreps:
                if p1 * p2 != p3 or not abs(l1 - l2) <= l3 <= l1 + l2:
                    continue
                if intertwiner(l1, l2, l3) is None:
                    continue
                paths.append((l1, p1, l2, l3, p3))
    return irreps, paths


def param_shapes(cfg: NequIPConfig) -> dict:
    """The reference's parameter tree, each leaf its array's shape."""
    irreps, paths = _paths(cfg)
    m = cfg.mult
    n_gates = m * sum(1 for (l, _) in irreps if l > 0)
    return {
        "embed_z": dense_shape(cfg.n_species, m, bias=False),
        "readout1": dense_shape(m, m),
        "readout2": [dense_shape(m, m), dense_shape(m, 1)],
        "layers": [{
            "radial": [dense_shape(cfg.n_rbf, cfg.radial_hidden),
                       dense_shape(cfg.radial_hidden, len(paths) * m)],
            "self": {f"l{l}p{pr}": dense_shape(m, m, bias=(l == 0))
                     for (l, pr) in irreps},
            "gate": dense_shape(m, n_gates),
            "skip": {f"l{l}p{pr}": dense_shape(m, m, bias=False)
                     for (l, pr) in irreps},
        } for _ in range(cfg.n_layers)],
    }


def init(gen: torch.Generator, cfg: NequIPConfig) -> dict:
    """Random weights of the reference's distributions (LeCun-normal
    denses, zero biases) from ``gen``."""
    irreps, paths = _paths(cfg)
    m = cfg.mult
    n_gates = m * sum(1 for (l, _) in irreps if l > 0)
    p = {"embed_z": dense_init(gen, cfg.n_species, m, bias=False),
         "readout1": dense_init(gen, m, m),
         "readout2": mlp_init(gen, [m, m, 1]),
         "layers": []}
    for _ in range(cfg.n_layers):
        p["layers"].append({
            # radial MLP -> per-path per-channel weights
            "radial": mlp_init(gen, [cfg.n_rbf, cfg.radial_hidden,
                                     len(paths) * m]),
            # self-interaction: channel mixing per target irrep
            "self": {f"l{l}p{pr}": dense_init(gen, m, m, bias=(l == 0))
                     for (l, pr) in irreps},
            # gate scalars for l>0 irreps from the scalar channels
            "gate": dense_init(gen, m, n_gates),
            "skip": {f"l{l}p{pr}": dense_init(gen, m, m, bias=False)
                     for (l, pr) in irreps},
        })
    return p


def _mix(x, w):
    """``einsum("nmi,mk->nki", x, w)``: channel mixing of x:(..., N, m,
    2l+1) by w:(m, k), one matmul (on the shards of DTensors)."""
    return einsum("mk,...mi->...ki", w, x,
                  local=lambda w_, x_: torch.matmul(w_.t(), x_))


# logical sharding specs of the parameters (``dist/sharding.py``)
PARAM_RULES = [
    (r"layers/.*/w", P(DP, TP)),
    (r"readout", P(DP, None)),
    (r"embed_z/w", P(DP, TP)),
]


def apply(params, graph, cfg: NequIPConfig):
    """graph: ``species`` (N,), ``positions`` (N, 3), ``edge_index``
    (2, E), ``node_mask``, ``edge_mask``; each may carry a leading batch
    axis. Returns (total energy, per-atom energies): (...,), (..., N)."""
    irreps, paths = _paths(cfg)
    ei = graph["edge_index"]
    nm, em = graph["node_mask"], graph["edge_mask"]
    n = nm.shape[-1]
    m = cfg.mult

    _, d, unit = C.edge_vectors(graph["positions"], ei)
    dt, dev = d.dtype, d.device
    rbf = C.bessel_rbf(d, n_rbf=cfg.n_rbf, cutoff=cfg.cutoff)
    env = C.cosine_cutoff(d, cfg.cutoff) * em                  # (.., E)
    ylm = {l2: real_sph(l2, unit) for l2 in range(cfg.l_max + 1)}

    z = C.one_hot(graph["species"], cfg.n_species, dt)
    lead = nm.shape[:-1]
    h = {f"l{l}p{p}": d.new_zeros((*lead, n, m, 2 * l + 1))
         for (l, p) in irreps}
    h["l0p1"] = dense_apply(params["embed_z"], z)[..., None]   # (.,N,m,1)

    n_edges = d.shape[-1]
    for lp in params["layers"]:
        w_all = mlp_apply(lp["radial"], rbf, activation=F.silu)
        w_all = reshape(w_all, *lead, n_edges, len(paths), m) \
            * env[..., None, None]
        msg = {}
        for pi, (l1, p1, l2, l3, p3) in enumerate(paths):
            w = w_all[..., pi, :]                              # (.., E, m)
            x = h[f"l{l1}p{p1}"]
            src = C.gather_src(x.flatten(-2), ei).unflatten(
                -1, x.shape[-2:])                              # (.,E,m,i)
            cg = intertwiner_tensor(l1, l2, l3, dev, dt)       # (i, j, k)
            # einsum("emi,ej,ijk->emk"): Y·CG per edge first, (i, k),
            # then one small matmul per edge
            yc = torch.einsum("...j,ijk->...ik", ylm[l2], cg)
            contrib = torch.matmul(src, yc) * w[..., None]     # (.,E,m,k)
            s = C.scatter_sum(contrib.flatten(-2), ei, n).unflatten(
                -1, contrib.shape[-2:])
            key = f"l{l3}p{p3}"
            msg[key] = s if key not in msg else msg[key] + s
        for k, v in h.items():
            msg.setdefault(k, torch.zeros_like(v))
        # self-interaction + skip + gate
        new_h = {}
        scal = msg["l0p1"][..., 0]
        gates = torch.sigmoid(dense_apply(lp["gate"], scal))   # (.,N,gates)
        gi = 0
        for (l, pr) in irreps:
            key = f"l{l}p{pr}"
            mixed = _mix(msg[key], lp["self"][key]["w"])
            if l == 0 and "b" in lp["self"][key]:
                mixed = mixed + lp["self"][key]["b"][:, None]
            skip = _mix(h[key], lp["skip"][key]["w"])
            if l == 0:
                new_h[key] = skip + F.silu(mixed)
            else:
                g = gates[..., gi * m:(gi + 1) * m]
                new_h[key] = skip + mixed * g[..., None]
                gi += 1
        h = {k: v * nm[..., None, None] for k, v in new_h.items()}

    atom_scal = F.silu(dense_apply(params["readout1"], h["l0p1"][..., 0]))
    e_atom = mlp_apply(params["readout2"], atom_scal,
                       activation=F.silu)[..., 0] * nm
    return e_atom.sum(-1), e_atom


def _energy_and_grad(params, graph, cfg, *, create_graph):
    """(energy, ∂E/∂positions): the gradient by autograd of the energies
    summed (each graph of a batch its own), kept differentiable where
    ``create_graph``."""
    with torch.enable_grad():
        pos = graph["positions"]
        if not pos.requires_grad:
            pos = pos.detach().requires_grad_(True)
        e, _ = apply(params, {**graph, "positions": pos}, cfg)
        (g,) = torch.autograd.grad(e.sum(), pos, create_graph=create_graph)
    return e, g


def loss_fn(params, graph, cfg: NequIPConfig, *, force_weight=0.0):
    """(loss, {"loss", "energy"}): the squared error of the energy, plus
    ``force_weight`` times the mean over valid atoms of the squared
    force error where ``force_weight > 0`` and the graph carries
    ``forces`` (N, 3). The force term's gradient is second order:
    autograd through the forces' own backward."""
    if force_weight > 0 and "forces" in graph:
        e, forces_neg = _energy_and_grad(params, graph, cfg,
                                         create_graph=True)
        nm = graph["node_mask"]
        fmse = (((-forces_neg - graph["forces"]) ** 2)
                * nm[..., None]).sum((-2, -1)) / C._maximum(nm.sum(-1), 1.0)
        loss = (e - graph["energy"]) ** 2 + force_weight * fmse
        return loss, {"loss": loss, "energy": e}
    e, _ = apply(params, graph, cfg)
    loss = (e - graph["energy"]) ** 2
    return loss, {"loss": loss, "energy": e}


def forces(params, graph, cfg: NequIPConfig):
    """−∂E/∂positions: (..., N, 3)."""
    return -_energy_and_grad(params, graph, cfg, create_graph=False)[1]
