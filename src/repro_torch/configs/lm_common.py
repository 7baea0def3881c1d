"""Shared pieces of the five LM architectures.

Counterpart of ``repro/configs/lm_common.py``: the shape table, the
optimizer config, the cells (``train_cell``, ``prefill_cell``,
``decode_cell``, ``cells_for``, the reduced-L ``cost_cells``) and
``smoke_lm``. :class:`CapturedDecode` is the decode cell's step on one
card as ``jax.jit`` runs it: one CUDA graph a step, the cache its static
buffer written in place (the counterpart of donating it).

Shapes (assigned): train_4k (train, S=4096 B=256), prefill_32k
(inference prefill, S=32768 B=32), decode_32k (one token against a 32k KV
cache, B=128), long_500k (one token against a 524288 KV cache, B=1,
sequence-sharded cache).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import Cell, eval_shape, sds
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import DP, TP, P, map_leaves, specs_from_rules
from repro_torch.models import transformer as tr
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_warmup)
from repro_torch.optim.adamw import opt_state_specs, tree_leaves, tree_map
from repro_torch.optim.step import value_and_grad

SHAPES = {
    "train_4k": {"kind": "train", "seq": 4096, "batch": 256},
    "prefill_32k": {"kind": "prefill", "seq": 32768, "batch": 32},
    "decode_32k": {"kind": "decode", "seq": 32768, "batch": 128},
    "long_500k": {"kind": "decode", "seq": 524288, "batch": 1,
                  "seq_shard": True},
}

def opt_config(cfg: tr.TransformerConfig, *, quantize: bool):
    return AdamWConfig(quantize_states=quantize)


def abstract_params(cfg: tr.TransformerConfig):
    """The parameter tree as :class:`sds` records (``param_dtype``)."""
    return map_leaves(lambda shape: sds(shape, cfg.param_dtype),
                      tr.abstract_params(cfg),
                      is_leaf=lambda x: isinstance(x, tuple))


@functools.cache
def _param_trees(cfg):
    params = abstract_params(cfg)
    return params, specs_from_rules(params, tr.PARAM_RULES)


@functools.cache
def abstract_cache(cfg: tr.TransformerConfig, batch: int, max_len: int):
    return eval_shape(lambda: tr.init_cache(cfg, batch, max_len,
                                            device="cpu"))


@functools.cache
def _opt_tree(cfg, quantize):
    return eval_shape(lambda p: adamw_init(p, opt_config(
        cfg, quantize=quantize)), _param_trees(cfg)[0])


def train_cell(arch: str, cfg: tr.TransformerConfig, *, quantize_opt=False,
               batch=None, seq=None, grad_accum: int = 1,
               shape_name: str = "train_4k"):
    meta = SHAPES["train_4k"]
    b = batch or meta["batch"]
    s = seq or meta["seq"]
    ocfg = opt_config(cfg, quantize=quantize_opt)
    lr = cosine_warmup(peak_lr=3e-4, warmup_steps=100, total_steps=10000)

    def make_step(mesh):
        def grads_of(params, batch_):
            return value_and_grad(
                lambda p: tr.loss_fn(p, batch_, cfg, mesh), params)

        def step(params, opt_state, batch_):
            if grad_accum > 1:
                # the reference's scan over micro-batches: gradients
                # summed / grad_accum in order, loss and metrics averaged
                mb = b // grad_accum
                grads, losses, ms = None, [], []
                for i in range(grad_accum):
                    mbatch = {k: v[i * mb:(i + 1) * mb]
                              for k, v in batch_.items()}
                    (loss, metrics), g = grads_of(params, mbatch)
                    g = tree_map(lambda x: x / grad_accum, g)
                    grads = g if grads is None else tree_map(
                        lambda a, x: a + x, grads, g)
                    losses.append(loss)
                    ms.append(metrics)
                loss = torch.stack(losses).mean()
                metrics = {k: torch.stack([m[k] for m in ms]).mean()
                           for k in ms[0]}
            else:
                (loss, metrics), grads = grads_of(params, batch_)
            new_p, new_s, aux = adamw_update(
                grads, opt_state, params,
                lr=lr(opt_state["step"]), cfg=ocfg)
            return new_p, new_s, {**metrics, **aux, "loss": loss}
        return step

    def abstract_args():
        params, _ = _param_trees(cfg)
        opt = _opt_tree(cfg, quantize_opt)
        batch_ = {"tokens": sds((b, s), torch.int32),
                  "labels": sds((b, s), torch.int32)}
        return (params, opt, batch_)

    def spec_args():
        _, pspecs = _param_trees(cfg)
        ospecs = opt_state_specs(pspecs, ocfg)
        bspecs = {"tokens": P(DP, None), "labels": P(DP, None)}
        return (pspecs, ospecs, bspecs)

    return Cell(arch=arch, shape=shape_name, kind="train",
                make_step=make_step, abstract_args=abstract_args,
                spec_args=spec_args,
                model_flops=tr.model_flops(cfg, b, s, training=True))


def _serving_specs(pspecs):
    """Inference param layout: TP-only (dp replicated)."""
    def drop_dp(spec):
        return P(*[None if e == DP
                   else (tuple(x for x in e if x != DP) or None
                         if isinstance(e, tuple) else e)
                   for e in spec])
    return map_leaves(drop_dp, pspecs)


def prefill_cell(arch: str, cfg: tr.TransformerConfig, *,
                 serving_shardings: bool = False, batch=None, seq=None):
    meta = SHAPES["prefill_32k"]
    b, s = batch or meta["batch"], seq or meta["seq"]

    def make_step(mesh):
        def step(params, tokens):
            return tr.prefill(params, tokens, cfg, mesh)
        return step

    def abstract_args():
        params, _ = _param_trees(cfg)
        return (params, sds((b, s), torch.int32))

    def spec_args():
        _, pspecs = _param_trees(cfg)
        if serving_shardings:
            pspecs = _serving_specs(pspecs)
        return (pspecs, P(DP, None))

    return Cell(arch=arch, shape="prefill_32k", kind="prefill",
                make_step=make_step, abstract_args=abstract_args,
                spec_args=spec_args,
                model_flops=tr.model_flops(cfg, b, s, training=False))


def decode_cell(arch: str, cfg: tr.TransformerConfig, shape: str, *,
                serving_shardings: bool = False, batch=None, seq=None):
    meta = SHAPES[shape]
    b, s = batch or meta["batch"], seq or meta["seq"]
    seq_shard = meta.get("seq_shard", False)

    def make_step(mesh):
        def step(params, cache, tokens):
            return tr.decode_step(params, cache, tokens, cfg, mesh)
        return step

    def abstract_args():
        params, _ = _param_trees(cfg)
        return (params, abstract_cache(cfg, b, s),
                sds((b, 1), torch.int32))

    def spec_args():
        _, pspecs = _param_trees(cfg)
        if serving_shardings:
            pspecs = _serving_specs(pspecs)
        # kv-head counts are rarely divisible by tp=16; shard d_head
        kvspec = (P(None, None, DP, None, TP) if seq_shard
                  else P(None, DP, None, None, TP))
        scspec = (P(None, None, DP, None) if seq_shard
                  else P(None, DP, None, None))

        def cspec(leaf):
            if leaf.ndim == 5:
                return kvspec
            if leaf.ndim == 4:
                return scspec
            return P(None, None)

        cspecs = map_leaves(cspec, abstract_cache(cfg, b, s))
        tokspec = P() if b == 1 else P(DP, None)
        return (pspecs, cspecs, tokspec)

    # decode: one token, attention reads the full cache
    mf = tr.model_flops(cfg, b, 1, training=False, decode=True, kv_len=s)
    return Cell(arch=arch, shape=shape, kind="decode",
                make_step=make_step, abstract_args=abstract_args,
                spec_args=spec_args, model_flops=mf)


class CapturedDecode:
    """The decode cell's step as ``jax.jit`` runs it, on one card: one
    CUDA graph a step. ``cache`` is the graph's static buffer: each step
    writes its token into it in place and advances its 'pos' (the
    counterpart of donating the cache), where ``decode_step`` copies the
    whole cache each step. ``params`` are read where they lie. Calling it
    with tokens (B, 1) returns the logits (B, V) f32: the graph's static
    output, overwritten by the next call.

    The first call warms the step up on a side stream and puts 'pos'
    back (the token row it wrote is written again by the real step
    before anything reads it), captures it, puts 'pos' back again (a
    stand-in backend runs what it captures) and replays. ``backend`` is
    ``core/pipeline._CudaGraphs`` on the cache's card unless one is given
    (a test injects a stand-in on the CPU)."""

    def __init__(self, params, cache, cfg: tr.TransformerConfig, *,
                 backend=None):
        self.params, self.cache, self.cfg = params, cache, cfg
        if backend is None:
            from repro_torch.core.pipeline import _CudaGraphs
            backend = _CudaGraphs(cache["pos"].device)
        self.backend = backend
        self._graph = None
        self.tokens = None
        self.logits = None

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def _body(self):
        return tr.decode_step_in_place(self.params, self.cache, self.tokens,
                                       self.cfg)

    def __call__(self, tokens):
        if self._graph is None:
            self.tokens = tokens.clone()
            pos = self.cache["pos"].clone()
            self.backend.warmup(self._body)
            self.cache["pos"].copy_(pos)
            self._graph, self.logits = self.backend.capture(self._body)
            self.cache["pos"].copy_(pos)
        else:
            self.tokens.copy_(tokens)
        self.backend.replay(self._graph)
        return self.logits


def cells_for(arch: str, cfg: tr.TransformerConfig, *, quantize_opt=False,
              serving_shardings=False, grad_accum=1):
    return {
        "train_4k": lambda: train_cell(arch, cfg,
                                       quantize_opt=quantize_opt,
                                       grad_accum=grad_accum),
        "prefill_32k": lambda: prefill_cell(
            arch, cfg, serving_shardings=serving_shardings),
        "decode_32k": lambda: decode_cell(
            arch, cfg, "decode_32k", serving_shardings=serving_shardings),
        "long_500k": lambda: decode_cell(
            arch, cfg, "long_500k", serving_shardings=serving_shardings),
    }


# ------------------------------------------------- cost (roofline) cells ----
def _cost_cfg(cfg: tr.TransformerConfig, n_layers: int):
    """The reference's scan-free-cost variant at ``n_layers`` ∈ {2, 4}:
    attention 'full', no loss chunking, MoE groups vmapped, layers
    unrolled (the port's layers are a loop either way, so its costs
    count exactly at full L; the variants give the reference's affine
    composition to hold against)."""
    kw = dict(cfg.__dict__)
    kw.update(n_layers=n_layers, attn_mode="full", loss_chunk=1 << 30,
              unroll_layers=True)
    if cfg.moe is not None:
        mkw = dict(cfg.moe.__dict__)
        mkw.update(vmap_groups=True)
        kw["moe"] = tr.MoEConfig(**mkw)
    return tr.TransformerConfig(**kw)


def cost_cells(arch: str, cfg: tr.TransformerConfig, shape: str, *,
               quantize_opt=False, **cell_kwargs):
    """Two reduced-L cells + the true L, for affine FLOP extrapolation."""
    out = {}
    for lred in (2, 4):
        c2 = _cost_cfg(cfg, lred)
        builder = cells_for(arch, c2, quantize_opt=quantize_opt,
                            **cell_kwargs)[shape]
        out[lred] = builder()
    return out, cfg.n_layers


def smoke_lm(cfg_small: tr.TransformerConfig, seed=0, device=None, *,
             params=None, tokens=None):
    """One real train step + one decode step at reduced scale, on
    ``device`` (None: the card). ``params`` and ``tokens`` (2, 16) are
    drawn from ``torch.Generator`` seed ``seed`` unless given (a test
    passes the reference's, converted)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    if params is None:
        params = tree_map(lambda t: t.to(dev), tr.init_params(gen, cfg_small))
    if tokens is None:
        tokens = torch.randint(0, cfg_small.vocab, (2, 16), generator=gen,
                               dtype=torch.int32)
    toks = tokens.to(dev)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    ocfg = AdamWConfig()
    opt = adamw_init(params, ocfg)
    (loss, metrics), grads = value_and_grad(
        lambda p: tr.loss_fn(p, batch, cfg_small, None), params)
    params2, opt2, _ = adamw_update(grads, opt, params, lr=1e-3, cfg=ocfg)
    cache = tr.init_cache(cfg_small, 2, 24, dtype=torch.float32, device=dev)
    logits, cache = tr.decode_step(params2, cache, toks[:, :1], cfg_small)
    delta = sum(float(torch.sum(torch.abs(a - b)))
                for a, b in zip(tree_leaves(params2), tree_leaves(params)))
    return {"loss": loss, "logits": logits, "params_delta": delta}
