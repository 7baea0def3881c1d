"""mind [recsys]: embed_dim=64 n_interests=4 capsule_iters=3
interaction=multi-interest [arXiv:1904.08030; unverified].

Counterpart of ``repro/configs/mind.py``.

Shapes: train_batch B=65,536 (in-batch sampled softmax), serve_p99 B=512
(online re-rank, 1,024 candidates each), serve_bulk B=262,144 (offline
scoring, 128 candidates each), retrieval_cand B=1 vs 1,000,000 candidates
(single batched matmul + top-k, never a loop)."""
import functools

import torch

from repro_torch.configs.base import Cell, eval_shape, sds
from repro_torch.dist.sharding import DP, P, map_leaves, specs_from_rules
from repro_torch.models import recsys as model
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_warmup)
from repro_torch.optim.adamw import opt_state_specs
from repro_torch.optim.step import value_and_grad

ARCH_ID = "mind"
FAMILY = "recsys"
SHAPES = ["train_batch", "serve_p99", "serve_bulk", "retrieval_cand"]

_META = {
    "train_batch": {"kind": "train", "batch": 65536},
    "serve_p99": {"kind": "serve", "batch": 512, "cands": 1024},
    "serve_bulk": {"kind": "serve", "batch": 262144, "cands": 128},
    "retrieval_cand": {"kind": "serve", "batch": 1, "cands": 1_000_000,
                       "shared_cands": True, "topk": 100},
}

OCFG = AdamWConfig(weight_decay=0.0)
LR = cosine_warmup(peak_lr=1e-3, warmup_steps=100, total_steps=20000)


def full_config():
    return model.MINDConfig(n_items=1_000_000, n_user_tags=100_000,
                            embed_dim=64, n_interests=4, capsule_iters=3,
                            hist_len=50, tag_bag=16)


def smoke_config():
    return model.MINDConfig(n_items=300, n_user_tags=60, embed_dim=16,
                            n_interests=4, capsule_iters=3, hist_len=8,
                            tag_bag=4)


def _train_flops(cfg, b):
    d, k, h = cfg.embed_dim, cfg.n_interests, cfg.hist_len
    routing = b * (2 * h * d * d + cfg.capsule_iters * 4 * k * h * d)
    proj = b * k * 2 * 2 * d * d
    logits = 2.0 * b * b * d
    return 3.0 * (routing + proj + logits)


def _serve_flops(cfg, b, c):
    """The reference's serve cells' MODEL_FLOPS: the user tower and the
    candidates' products."""
    d, k, h = cfg.embed_dim, cfg.n_interests, cfg.hist_len
    user_tower = b * (2 * h * d * d
                      + cfg.capsule_iters * 4 * k * h * d
                      + k * 2 * 2 * d * d)
    return 2.0 * b * k * c * d + user_tower


def _user_feed(cfg, b):
    return {
        "behav_ids": sds((b, cfg.hist_len), torch.int32),
        "behav_mask": sds((b, cfg.hist_len), torch.float32),
        "tag_ids": sds((b, cfg.tag_bag), torch.int32),
    }


def _user_specs(cfg, b):
    bp = P(DP, None) if b > 1 else P(None, None)
    return {"behav_ids": bp, "behav_mask": bp, "tag_ids": bp}


@functools.cache
def abstract_params(cfg):
    """The parameter tree as :class:`sds` records (f32)."""
    return map_leaves(lambda shape: sds(shape, torch.float32),
                      model.param_shapes(cfg),
                      is_leaf=lambda x: isinstance(x, tuple))


@functools.cache
def _opt_tree(cfg):
    return eval_shape(lambda p: adamw_init(p, OCFG), abstract_params(cfg))


def cell(shape):
    cfg = full_config()
    meta = _META[shape]
    b = meta["batch"]
    if shape == "train_batch":
        return _train_cell(cfg, b)
    return _serve_cell(cfg, shape, meta)


def train_step(cfg):
    """``step(params, opt_state, batch)``: the in-batch softmax loss ->
    gradients -> AdamW at ``LR(step)``."""
    def step(params, opt_state, batch):
        (loss, metrics), grads = value_and_grad(
            lambda p: model.loss_fn(p, batch, cfg), params)
        new_p, new_s, aux = adamw_update(
            grads, opt_state, params, lr=LR(opt_state["step"]), cfg=OCFG)
        return new_p, new_s, {**metrics, **aux}
    return step


def _train_cell(cfg, b):
    def abstract_args():
        params = abstract_params(cfg)
        opt = _opt_tree(cfg)
        batch = dict(_user_feed(cfg, b), target=sds((b,), torch.int32))
        return (params, opt, batch)

    def spec_args():
        pspecs = specs_from_rules(abstract_params(cfg), model.PARAM_RULES)
        ospecs = opt_state_specs(pspecs, OCFG)
        bspecs = dict(_user_specs(cfg, b), target=P(DP))
        return (pspecs, ospecs, bspecs)

    return Cell(arch=ARCH_ID, shape="train_batch", kind="train",
                make_step=lambda mesh: train_step(cfg),
                abstract_args=abstract_args, spec_args=spec_args,
                model_flops=_train_flops(cfg, b))


def _serve_cell(cfg, shape, meta):
    b, c = meta["batch"], meta["cands"]
    shared = meta.get("shared_cands", False)
    topk = meta.get("topk")

    def make_step(mesh):
        def step(params, batch):
            if topk:
                # int32 indices, as ``lax.top_k``'s
                vals, idx = model.serve_topk(params, batch, cfg, k=topk)
                return vals, idx.to(torch.int32)
            return model.score_candidates(params, batch, cfg)
        return step

    def abstract_args():
        batch = _user_feed(cfg, b)
        batch["cand_ids"] = sds((c,) if shared else (b, c), torch.int32)
        return (abstract_params(cfg), batch)

    def spec_args():
        pspecs = specs_from_rules(abstract_params(cfg), model.PARAM_RULES)
        bspecs = _user_specs(cfg, b)
        bspecs["cand_ids"] = P(DP) if shared else (
            P(DP, None) if b > 1 else P(None, None))
        return (pspecs, bspecs)

    return Cell(arch=ARCH_ID, shape=shape, kind="serve",
                make_step=make_step, abstract_args=abstract_args,
                spec_args=spec_args, model_flops=_serve_flops(cfg, b, c))


def smoke_run(seed=0, device=None):
    """The smoke config's loss on 16 users and every item's score,
    random weights from ``torch.Generator`` seed ``seed``, on ``device``
    (None: the card)."""
    from repro_torch.data.recsys import mind_batch
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    cfg = smoke_config()
    p = model.init(torch.Generator().manual_seed(seed), cfg)
    p = {k: ({n: t.to(dev) for n, t in v.items()} if isinstance(v, dict)
             else v.to(dev)) for k, v in p.items()}
    batch = {k: torch.from_numpy(v).to(dev) for k, v in mind_batch(
        n_items=cfg.n_items, n_user_tags=cfg.n_user_tags,
        hist_len=cfg.hist_len, tag_bag=cfg.tag_bag, batch=16,
        seed=seed, step=0).items()}
    loss, m = model.loss_fn(p, batch, cfg)
    batch["cand_ids"] = torch.arange(cfg.n_items, dtype=torch.int32,
                                     device=dev)
    scores = model.score_candidates(p, batch, cfg)
    return {"loss": loss, "scores": scores, "metrics": m}
