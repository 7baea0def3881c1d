"""Shared train step of the GNN architectures.

Counterpart of ``repro/configs/gnn_common.py``: its shape table, the
sampler grouping, the optimizer and the body of ``make_train_cell``'s
step (:func:`train_step`), with no mesh. The cells and their sharding
specs wait for ``ROADMAP.md`` queue 1 item 7; the vmapped ``molecule``
step waits for the molecule generator (item 6).

Shapes (assigned):
  full_graph_sm  N=2,708  E=10,556  d_feat=1,433   (full-batch train)
  minibatch_lg   N=232,965 graph; batch_nodes=1,024 fanout 15-10
                 (sampled training — graphsage uses the layered
                 GraphSAGE sampler)
  ogb_products   N=2,449,029 E=61,859,140 d_feat=100 (full-batch-large)
  molecule       n=30 e=64 batch=128 (batched small graphs)
"""
from __future__ import annotations

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
