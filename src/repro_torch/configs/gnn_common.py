"""Shared train steps of the GNN architectures.

Counterpart of ``repro/configs/gnn_common.py``: its shape table, the
sampler grouping, the optimizer, the body of ``make_train_cell``'s step
(:func:`train_step`) and of ``make_batched_train_cell``'s
(:func:`batched_train_step`, the ``molecule`` shape's), with no mesh,
and the molecule shape's data (:func:`molecule_graphs`). The cells and
their sharding specs wait for ``ROADMAP.md`` queue 1 item 7.

The reference batches the molecule shape with ``jax.vmap``; the port's
models take the leading batch axis themselves (each graph's gathers
from its own rows, each node sum one ``edge_aggregate`` launch for the
whole batch: ``torch.func.vmap`` cannot batch the kernel's autograd
function, a ctypes call).

Geometric archs (dimenet, nequip) receive synthetic 3D positions and
species on every shape (``data/graphs.py``). DimeNet triplet budgets:
~4×E (capped at 2×E for ogb_products).

Shapes (assigned):
  full_graph_sm  N=2,708  E=10,556  d_feat=1,433   (full-batch train)
  minibatch_lg   N=232,965 graph; batch_nodes=1,024 fanout 15-10
                 (sampled training — graphsage uses the layered
                 GraphSAGE sampler)
  ogb_products   N=2,449,029 E=61,859,140 d_feat=100 (full-batch-large)
  molecule       n=30 e=64 batch=128 (batched small graphs)
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.optim import AdamWConfig, adamw_update, cosine_warmup
from repro_torch.optim.step import value_and_grad

GROUPS = 32          # minibatch_lg sampler groups
SEEDS_PER_GROUP = 32  # GROUPS × SEEDS = batch_nodes = 1024

SHAPES = {
    "full_graph_sm": {"kind": "train", "n": 2708, "e": 10556,
                      "d_feat": 1433, "classes": 7, "trip": 65536},
    "minibatch_lg": {"kind": "train", "n": 169984, "e": 168960,
                     "d_feat": 602, "classes": 41, "trip": 2097152,
                     "fanout": (15, 10)},
    "ogb_products": {"kind": "train", "n": 2449029, "e": 61859140,
                     "d_feat": 100, "classes": 47, "trip": 123718280},
    "molecule": {"kind": "train", "n": 30, "e": 64, "batch": 128,
                 "d_feat": 16, "classes": 1, "trip": 256},
}

OCFG = AdamWConfig(weight_decay=0.0)
LR = cosine_warmup(peak_lr=1e-3, warmup_steps=50, total_steps=5000)


def train_step(model, cfg, **loss_kw):
    """The generic GNN step ``step(params, opt_state, graph) -> (new
    params, new state, metrics)``: ``model.loss_fn`` -> gradients ->
    AdamW at ``LR(step)``. A loss with a leading (group) axis is
    averaged over it, metrics too. Functional; ``optim.step.CompiledStep``
    captures it on the card."""
    def lf(p, graph):
        loss, metrics = model.loss_fn(p, graph, cfg, **loss_kw)
        return loss.mean(), {k: v.mean() for k, v in metrics.items()}

    def step(params, opt_state, graph):
        (loss, metrics), grads = value_and_grad(lambda p: lf(p, graph),
                                                params)
        new_p, new_s, aux = adamw_update(
            grads, opt_state, params, lr=LR(opt_state["step"]), cfg=OCFG)
        return new_p, new_s, {**metrics, **aux}
    return step


# The ``molecule`` step ``step(params, opt_state, graphs)`` is the same
# function: the models take the batch's leading axis themselves, so the
# loss of every graph (or node, for GatedGCN's graph readout on per-node
# labels) averaged over it is what the reference's vmapped mean computes;
# called with no loss options, as the reference calls ``model.loss_fn``.
batched_train_step = train_step


def molecule_graphs(arch_id: str, *, seed: int, batch=None,
                    device=None) -> dict:
    """The ``molecule`` shape's batch (n 30, e 64, ``batch`` graphs,
    128 by default) for ``arch_id`` as tensors on ``device``: for
    dimenet and nequip ``data/graphs.molecule_batch`` over their
    configs' 16 species (DimeNet's with its triplets, budget 256), for
    gatedgcn and graphsage-reddit a stack
    of power-law graphs of 16 features and 2 classes (graph i of seed
    ``seed * 10007 + i``), labels per node as the reference's
    ``graph_sds`` gives them."""
    from repro_torch.data.graphs import molecule_batch, powerlaw_graph
    from repro_torch.device import resolve_device
    meta = SHAPES["molecule"]
    b = meta["batch"] if batch is None else batch
    if arch_id in ("dimenet", "nequip"):
        g = molecule_batch(b, n_nodes=meta["n"], max_edges=meta["e"],
                           max_triplets=meta["trip"], n_species=16,
                           seed=seed, with_triplets=arch_id == "dimenet")
    elif arch_id in ("gatedgcn", "graphsage-reddit"):
        gs = [powerlaw_graph(meta["n"], meta["e"], d_feat=meta["d_feat"],
                             n_classes=max(meta["classes"], 2),
                             seed=seed * 10007 + i) for i in range(b)]
        g = {k: np.stack([x[k] for x in gs]) for k in gs[0]}
    else:
        raise ValueError(f"no molecule batch for {arch_id!r}")
    dev = resolve_device(device)
    return {k: torch.from_numpy(v).to(dev) for k, v in g.items()}
