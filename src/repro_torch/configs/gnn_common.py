"""Shared train steps of the GNN architectures.

Counterpart of ``repro/configs/gnn_common.py``: its shape table, the
sampler grouping, the optimizer, the abstract graphs and their specs
(edge-sharded: 1D partitioning, or batch-sharded), the cells
(:func:`make_train_cell`, :func:`make_batched_train_cell`), their steps
(:func:`train_step`, :func:`batched_train_step`, the ``molecule``
shape's) and the molecule shape's data (:func:`molecule_graphs`).

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

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.configs.base import Cell, eval_shape, sds, shapes_of
from repro_torch.dist.sharding import DP, P, specs_from_rules
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_warmup)
from repro_torch.optim.adamw import opt_state_specs
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


def graph_sds(meta, *, geometric: bool, triplets: bool, batch=None):
    n, e = meta["n"], meta["e"]
    lead = () if batch is None else (batch,)
    g = {
        "edge_index": sds((*lead, 2, e), torch.int32),
        "node_mask": sds((*lead, n), torch.float32),
        "edge_mask": sds((*lead, e), torch.float32),
    }
    if geometric:
        g["positions"] = sds((*lead, n, 3), torch.float32)
        g["species"] = sds((*lead, n), torch.int32)
        g["energy"] = sds(lead, torch.float32)
    else:
        g["nodes"] = sds((*lead, n, meta["d_feat"]), torch.float32)
        g["labels"] = sds((*lead, n), torch.int32)
    if triplets:
        g["triplets"] = sds((*lead, 2, meta["trip"]), torch.int32)
        g["triplet_mask"] = sds((*lead, meta["trip"]), torch.float32)
    return g


def graph_specs(g, *, edge_dp=True, batch=False):
    """Edge-sharded (1D partitioning) or batch-sharded specs."""
    specs = {}
    for k, v in g.items():
        if batch:
            specs[k] = P(DP, *([None] * (len(v.shape) - 1)))
        elif not edge_dp:
            specs[k] = P(*([None] * len(v.shape)))
        elif k in ("edge_index", "triplets"):
            specs[k] = P(None, DP)
        elif k in ("edge_mask", "triplet_mask"):
            specs[k] = P(DP)
        else:
            specs[k] = P(*([None] * len(v.shape)))
    return specs


def abstract_params(model, cfg):
    return shapes_of(model.init(torch.Generator().manual_seed(0), cfg))


@functools.cache
def state_trees(model, cfg):
    """(params, AdamW state, their specs) of ``model`` at ``cfg`` as
    abstract trees; made once a (model, config)."""
    params = abstract_params(model, cfg)
    opt = eval_shape(lambda p: adamw_init(p, OCFG), params)
    pspecs = specs_from_rules(params, model.PARAM_RULES)
    return params, opt, pspecs, opt_state_specs(pspecs, OCFG)


def make_train_cell(arch, shape, model, cfg, abstract_graph, gspecs,
                    loss_kw=None, model_flops=0.0):
    """Generic GNN train cell: loss -> grads -> AdamW
    (:func:`train_step`)."""
    loss_kw = loss_kw or {}

    def make_step(mesh):
        return train_step(model, cfg, **loss_kw)

    def abstract_args():
        params, opt, _, _ = state_trees(model, cfg)
        return (params, opt, abstract_graph)

    def spec_args():
        _, _, pspecs, ospecs = state_trees(model, cfg)
        return (pspecs, ospecs, gspecs)

    return Cell(arch=arch, shape=shape, kind="train", make_step=make_step,
                abstract_args=abstract_args, spec_args=spec_args,
                model_flops=model_flops)


def make_batched_train_cell(arch, model, cfg, abstract_graphs, gspecs,
                            model_flops=0.0):
    """molecule shape: a batch of small graphs on a leading axis
    (:func:`batched_train_step`)."""
    cell = make_train_cell(arch, "molecule", model, cfg, abstract_graphs,
                           gspecs, model_flops=model_flops)
    return dataclasses.replace(
        cell, make_step=lambda mesh: batched_train_step(model, cfg))


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
