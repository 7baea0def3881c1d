"""CaloClusterNet — the dynamic GNN of the paper, in PyTorch.

Counterpart of ``repro/core/caloclusternet.py``:

  encoder Dense×2 → [GravNet block]×2 → decoder Dense×2 →
  per-hit heads: β, cluster coords (2), energy, class logits (3)
  → CPS (condensation point selection) → ≤ k_max clusters + trigger bit.

- ``init`` / ``apply`` / ``CaloClusterNet``: the parameters (a dict of
  ``{"w", "b"}`` dense params, ``w`` in the ``(d_in, d_out)`` layout),
  the eager forward as a function of them, and the module around it.
  ``CCNConfig.gravnet_impl`` picks its GravNet aggregation: ``"topk"``
  (the default, the reference's top-k + gather oracle,
  ``kernels/ref.py:gravnet_aggregate_topk_ref``) or ``"onehot"`` (the
  kernels' own cell schedule, ``gravnet_cell_ref``);
  ``compute_dtype="bf16"`` runs the forward on bf16 feats and
  parameters (the reference's bf16 serving activations).
- ``cps``: condensation point selection, exact to the reference's
  sequential greedy loop but vectorized over events and over hits.
- ``to_graph``: the dataflow-IR export the deployment flow consumes.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.core.graph_ir import Graph, Operator, register_exporter
from repro_torch.kernels.ref import (gravnet_aggregate_ref,
                                     gravnet_aggregate_topk_ref)
from repro_torch.nn.layers import Dense, dense_apply, dense_init


@dataclasses.dataclass(frozen=True)
class CCNConfig:
    n_hits: int = 128           # max nonzero inputs per event (upgrade)
    n_crystals: int = 8736
    d_in: int = 4               # (E, theta, phi, t)
    d_hidden: int = 64
    n_gravnet_blocks: int = 2
    d_s: int = 4                # learned spatial dims
    d_flr: int = 22             # learned feature dims
    k: int = 8                  # neighbors
    potential_scale: float = 10.0
    d_decoder: int = 32
    n_classes: int = 3          # photon / hadron / beam-background
    k_max: int = 8              # max condensation points per event
    t_beta: float = 0.3
    t_dist: float = 0.5         # min distance between condensation points
    e_trigger: float = 0.1      # GeV threshold on cluster energy
    gravnet_impl: str = "topk"  # 'topk' (gather) | 'onehot' (the cell)
    compute_dtype: str = "f32"  # 'f32' | 'bf16' (serving activations)

    @property
    def head_dims(self):
        # beta, coords(2), energy, class logits
        return {"beta": 1, "coords": 2, "energy": 1,
                "cls": self.n_classes}


def current_detector_config() -> CCNConfig:
    return dataclasses.replace(CCNConfig(), n_hits=32, n_crystals=576)


def param_shapes(cfg: CCNConfig) -> dict[str, tuple[int, int]]:
    """{layer name: (d_in, d_out)} of every dense, in the reference's
    naming."""
    shapes = {"enc1": (cfg.d_in, cfg.d_hidden),
              "enc2": (cfg.d_hidden, cfg.d_hidden)}
    for i in range(cfg.n_gravnet_blocks):
        shapes[f"gn{i}_s"] = (cfg.d_hidden, cfg.d_s)
        shapes[f"gn{i}_flr"] = (cfg.d_hidden, cfg.d_flr)
        shapes[f"gn{i}_out"] = (cfg.d_hidden + 2 * cfg.d_flr, cfg.d_hidden)
    shapes["dec1"] = (cfg.d_hidden, cfg.d_hidden)
    shapes["dec2"] = (cfg.d_hidden, cfg.d_decoder)
    for h, d in cfg.head_dims.items():
        shapes[f"head_{h}"] = (cfg.d_decoder, d)
    return shapes


def init(gen: torch.Generator, cfg: CCNConfig) -> dict:
    """Random parameters (LeCun-normal weights, zero biases) drawn from
    ``gen``, on the CPU."""
    return {name: dense_init(gen, a, b)
            for name, (a, b) in param_shapes(cfg).items()}


# ----------------------------------------------------------------- model ----
class CaloClusterNet(nn.Module):
    """The eager forward (:func:`apply`): feats (B,N,d_in), mask (B,N)
    -> {beta_logit (B,N), coords (B,N,2), energy (B,N),
    cls_logits (B,N,n_classes)}."""

    def __init__(self, params: dict, cfg: CCNConfig):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleDict(
            {name: Dense(p["w"], p.get("b")) for name, p in params.items()})

    def forward(self, feats, mask):
        # the Parameters themselves (not .data), so that a caller that
        # sets requires_grad gets gradients through the layers
        return apply({name: dict(layer.named_parameters())
                      for name, layer in self.layers.items()},
                     feats, mask, self.cfg)


def aggregate(s, f, mask, cfg: CCNConfig):
    """The GravNet aggregation of ``cfg.gravnet_impl``, in f32 and cast
    to f's dtype: ``"topk"`` the reference's top-k + gather oracle,
    ``"onehot"`` the kernels' cell (iterated argmin with knockout)."""
    if cfg.gravnet_impl == "topk":
        return gravnet_aggregate_topk_ref(s, f, mask, k=cfg.k,
                                          scale=cfg.potential_scale)
    if cfg.gravnet_impl == "onehot":
        return gravnet_aggregate_ref(s, f, mask, k=cfg.k,
                                     scale=cfg.potential_scale)
    raise ValueError(f"gravnet_impl {cfg.gravnet_impl!r}: 'topk' or "
                     "'onehot'")


def apply(params, feats, mask, cfg: CCNConfig):
    """The forward as a function of the parameter dict (the reference's
    ``apply``), differentiable in every leaf of ``params``. Under
    ``compute_dtype="bf16"`` the feats and every parameter are cast to
    bf16 and the denses run in bf16 (the mask and the aggregation's
    arithmetic stay f32)."""
    if cfg.compute_dtype == "bf16":
        feats = feats.to(torch.bfloat16)
        params = {name: {k: t.to(torch.bfloat16) for k, t in p.items()}
                  for name, p in params.items()}
    elif cfg.compute_dtype != "f32":
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r}: 'f32' or "
                         "'bf16'")

    def dense(name, x):
        return dense_apply(params[name], x)
    x = torch.relu(dense("enc1", feats))
    x = torch.relu(dense("enc2", x))
    for i in range(cfg.n_gravnet_blocks):
        s = dense(f"gn{i}_s", x)
        flr = dense(f"gn{i}_flr", x)
        agg = aggregate(s, flr, mask, cfg)
        x = torch.relu(dense(f"gn{i}_out", torch.cat([x, agg], dim=-1)))
    x = torch.relu(dense("dec1", x))
    x = torch.relu(dense("dec2", x))
    out = {h: dense(f"head_{h}", x) for h in cfg.head_dims}
    return {
        "beta_logit": out["beta"][..., 0],
        "coords": out["coords"],
        "energy": out["energy"][..., 0],
        "cls_logits": out["cls"],
    }


# ------------------------------------------------------------------- CPS ----
def cps(outputs, mask, cfg: CCNConfig):
    """Condensation Point Selection, batched over events.

    The reference walks the hits of an event in decreasing β and takes a
    hit when β > t_beta, it lies more than t_dist (in cluster-coordinate
    space) from every point taken so far, and fewer than k_max are
    taken. Here the loop runs over the k_max slots instead: slot s takes
    the first hit, after slot s-1's, in β order that passes both tests
    against the points already taken. Since the set of taken points only
    grows, a hit the reference rejects stays rejected, and the two pick
    the same hits in the same order — k_max steps over all events at
    once instead of n_hits steps per event.
    """
    beta_logit = outputs["beta_logit"].float()
    coords = outputs["coords"].float()
    energy = outputs["energy"].float()
    bsz, n = beta_logit.shape
    dev = beta_logit.device
    beta = torch.sigmoid(beta_logit) * mask.float()
    order = torch.argsort(-beta, dim=1, stable=True)
    b_sorted = torch.gather(beta, 1, order)
    c_sorted = torch.gather(coords, 1, order[..., None].expand(bsz, n, 2))
    e_sorted = torch.gather(energy, 1, order)

    def f32(v):     # thresholds compare in f32, as the reference's do
        return torch.tensor(v, dtype=torch.float32)     # a 0-dim scalar

    eligible = b_sorted > f32(cfg.t_beta)
    blocked = torch.zeros((bsz, n), dtype=torch.bool, device=dev)
    last = torch.full((bsz,), -1, dtype=torch.long, device=dev)
    pos = torch.arange(n, device=dev)
    rows = torch.arange(bsz, device=dev)
    thr = f32(cfg.t_dist ** 2)
    picks, founds = [], []
    for _ in range(cfg.k_max):
        cand = eligible & ~blocked & (pos[None, :] > last[:, None])
        found, q = torch.max(cand.to(torch.int32), dim=1)  # first hit
        found = found.bool()
        d2 = ((c_sorted[rows, q][:, None, :] - c_sorted) ** 2).sum(dim=2)
        blocked = blocked | (found[:, None] & (d2 <= thr))
        last = torch.where(found, q, last)
        picks.append(q)
        founds.append(found)
    q = torch.stack(picks, dim=1)                       # (B, k_max)
    valid = torch.stack(founds, dim=1)   # a miss ends the selection
    sel_xy = torch.where(valid[..., None], torch.gather(
        c_sorted, 1, q[..., None].expand(bsz, cfg.k_max, 2)), 0.0)
    sel_e = torch.where(valid, torch.gather(e_sorted, 1, q), 0.0)
    sel_b = torch.where(valid, torch.gather(b_sorted, 1, q), 0.0)
    count = valid.sum(dim=1, dtype=torch.int32)
    trigger = (valid & (sel_e > f32(cfg.e_trigger))).any(dim=1)
    return {"cluster_xy": sel_xy, "cluster_e": sel_e,
            "cluster_beta": sel_b, "cluster_valid": valid,
            "n_clusters": count, "trigger": trigger}


# -------------------------------------------------------------- IR export ----
def to_graph(params, cfg: CCNConfig) -> Graph:
    """Export as a dataflow graph for the deployment flow: every layer
    is one operator; GravNet blocks expand to (linear_s ∥ linear_flr) →
    gravnet_aggregate → concat → linear → relu."""
    g = Graph()

    def lin(name, inp, d_out):
        g.add(Operator(name=name, op_type="linear", inputs=[inp],
                       params=dict(params[name]), out_dim=d_out))
        return name

    def relu(name, inp, d):
        g.add(Operator(name=name, op_type="relu", inputs=[inp], out_dim=d))
        return name

    g.add(Operator(name="hits", op_type="input", out_dim=cfg.d_in,
                   attrs={"feature": "hits"}))
    g.add(Operator(name="mask", op_type="input", out_dim=1,
                   attrs={"feature": "mask"}))
    x = relu("enc1_relu", lin("enc1", "hits", cfg.d_hidden), cfg.d_hidden)
    x = relu("enc2_relu", lin("enc2", x, cfg.d_hidden), cfg.d_hidden)
    for i in range(cfg.n_gravnet_blocks):
        s = lin(f"gn{i}_s", x, cfg.d_s)
        f = lin(f"gn{i}_flr", x, cfg.d_flr)
        agg = f"gn{i}_agg"
        g.add(Operator(name=agg, op_type="gravnet_aggregate",
                       inputs=[s, f, "mask"],
                       attrs={"k": cfg.k, "scale": cfg.potential_scale,
                              "d_s": cfg.d_s, "d_f": cfg.d_flr},
                       out_dim=2 * cfg.d_flr))
        cat = f"gn{i}_cat"
        g.add(Operator(name=cat, op_type="concat", inputs=[x, agg],
                       out_dim=cfg.d_hidden + 2 * cfg.d_flr))
        x = relu(f"gn{i}_out_relu", lin(f"gn{i}_out", cat, cfg.d_hidden),
                 cfg.d_hidden)
    x = relu("dec1_relu", lin("dec1", x, cfg.d_hidden), cfg.d_hidden)
    x = relu("dec2_relu", lin("dec2", x, cfg.d_decoder), cfg.d_decoder)
    heads = []
    for h, d in cfg.head_dims.items():
        heads.append(lin(f"head_{h}", x, d))
    g.add(Operator(name="cps", op_type="cps",
                   inputs=heads + ["mask"],
                   attrs={"k_max": cfg.k_max, "t_beta": cfg.t_beta,
                          "t_dist": cfg.t_dist, "e_trigger": cfg.e_trigger,
                          "head_names": list(cfg.head_dims)},
                   out_dim=cfg.k_max))
    g.add(Operator(name="out", op_type="output",
                   inputs=heads + ["cps"],
                   attrs={"head_names": list(cfg.head_dims)},
                   out_dim=sum(cfg.head_dims.values())))
    g.validate()
    g.meta["config"] = cfg
    return g


register_exporter("caloclusternet", to_graph)
