"""Shared pieces of the five LM architectures.

Counterpart of ``repro/configs/lm_common.py``: the shape table, the
optimizer config and ``smoke_lm``. The reference's mesh cells
(``train_cell``, ``prefill_cell``, ``decode_cell``, ``cells_for``,
``cost_cells``) wait for the multi-device tools (``ROADMAP.md`` queue 1
item 7) and raise naming it.

Shapes (assigned): train_4k (train, S=4096 B=256), prefill_32k
(inference prefill, S=32768 B=32), decode_32k (one token against a 32k KV
cache, B=128), long_500k (one token against a 524288 KV cache, B=1,
sequence-sharded cache).
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as tr
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.optim.step import value_and_grad

SHAPES = {
    "train_4k": {"kind": "train", "seq": 4096, "batch": 256},
    "prefill_32k": {"kind": "prefill", "seq": 32768, "batch": 32},
    "decode_32k": {"kind": "decode", "seq": 32768, "batch": 128},
    "long_500k": {"kind": "decode", "seq": 524288, "batch": 1,
                  "seq_shard": True},
}

_NO_CELLS = ("the LM cells are mesh sharding specs for the multi-device "
             "tools: ROADMAP.md queue 1 item 7")


def opt_config(cfg: tr.TransformerConfig, *, quantize: bool):
    return AdamWConfig(quantize_states=quantize)


def _cells_wait(*_, **__):
    raise NotImplementedError(_NO_CELLS)


train_cell = prefill_cell = decode_cell = cells_for = cost_cells = \
    _cells_wait


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
