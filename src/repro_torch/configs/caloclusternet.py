"""caloclusternet [trigger] — the paper's own architecture.

Counterpart of ``repro/configs/caloclusternet.py``. Variants: 'upgrade'
(128 of 8736 inputs — the paper's target) and 'current' (32 of 576 — the
deployed detector). Shapes: trigger_serve (streaming inference, the
hardware-trigger path incl. CPS) and condensation_train
(object-condensation training)."""
import functools

import torch

from repro_torch.configs.base import Cell, eval_shape, sds, shapes_of
from repro_torch.core import caloclusternet as ccn
from repro_torch.core.condensation import condensation_loss
from repro_torch.dist.sharding import DP, P, specs_from_rules
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_warmup)
from repro_torch.optim.adamw import opt_state_specs
from repro_torch.optim.step import value_and_grad

ARCH_ID = "caloclusternet"
FAMILY = "trigger"
SHAPES = ["trigger_serve", "trigger_serve_current", "condensation_train"]

_META = {
    "trigger_serve": {"kind": "serve", "batch": 4096, "variant": "upgrade"},
    "trigger_serve_current": {"kind": "serve", "batch": 4096,
                              "variant": "current"},
    "condensation_train": {"kind": "train", "batch": 1024,
                           "variant": "upgrade"},
}

PARAM_RULES = [(r".*/w", P(DP, None))]
OCFG = AdamWConfig(weight_decay=0.01)
LR = cosine_warmup(peak_lr=1e-3, warmup_steps=200, total_steps=20000)


def full_config(variant="upgrade"):
    if variant == "current":
        return ccn.current_detector_config()
    return ccn.CCNConfig()


def smoke_config():
    return ccn.CCNConfig(n_hits=16, n_crystals=576, d_hidden=24,
                         d_flr=8, d_s=3, k=4, d_decoder=12)


def _flops(cfg, b):
    n, d = cfg.n_hits, cfg.d_hidden
    per_ev = (2 * n * (cfg.d_in * d + d * d)               # encoder
              + cfg.n_gravnet_blocks * (
                  2 * n * d * (cfg.d_s + cfg.d_flr)
                  + 2 * n * n * (cfg.d_s + cfg.k * cfg.d_flr)
                  + 2 * n * (d + 2 * cfg.d_flr) * d)
              + 2 * n * (d * d + d * cfg.d_decoder)
              + 2 * n * cfg.d_decoder * sum(cfg.head_dims.values()))
    return per_ev * b


def cell(shape):
    meta = _META[shape]
    cfg = full_config(meta["variant"])
    b = meta["batch"]
    if meta["kind"] == "serve":
        return _serve_cell(cfg, shape, b)
    return _train_cell(cfg, shape, b)


def _feeds(cfg, b, train=False):
    f = {"feats": sds((b, cfg.n_hits, cfg.d_in), torch.float32),
         "mask": sds((b, cfg.n_hits), torch.float32)}
    if train:
        f["object_id"] = sds((b, cfg.n_hits), torch.int32)
        f["energy"] = sds((b, cfg.n_hits), torch.float32)
        f["cls"] = sds((b, cfg.n_hits), torch.int32)
    return f


def _feed_specs(fd):
    return {k: P(DP, *([None] * (len(v.shape) - 1)))
            for k, v in fd.items()}


@functools.cache
def _params(cfg):
    return shapes_of(ccn.init(torch.Generator().manual_seed(0), cfg))


@functools.cache
def _opt_tree(cfg):
    return eval_shape(lambda p: adamw_init(p, OCFG), _params(cfg))


def serve_step(cfg):
    """``step(params, batch) -> CPS``: the model then condensation-point
    selection (the trigger path), plain PyTorch (the trigger's deployed
    kernels run in ``core/pipeline.py``)."""
    def step(params, batch):
        out = ccn.apply(params, batch["feats"], batch["mask"], cfg)
        return ccn.cps(out, batch["mask"], cfg)
    return step


def train_step(cfg):
    """``step(params, opt_state, batch)``: the condensation loss ->
    gradients -> AdamW at ``LR(step)``."""
    def step(params, opt_state, batch):
        def lf(p):
            out = ccn.apply(p, batch["feats"], batch["mask"], cfg)
            labels = {"object_id": batch["object_id"],
                      "energy": batch["energy"], "cls": batch["cls"]}
            return condensation_loss(out, labels, batch["mask"],
                                     k_max=cfg.k_max)
        (loss, metrics), grads = value_and_grad(lf, params)
        new_p, new_s, aux = adamw_update(
            grads, opt_state, params, lr=LR(opt_state["step"]), cfg=OCFG)
        return new_p, new_s, {**metrics, **aux}
    return step


def _serve_cell(cfg, shape, b):
    def spec_args():
        return (specs_from_rules(_params(cfg), PARAM_RULES),
                _feed_specs(_feeds(cfg, b)))

    return Cell(arch=ARCH_ID, shape=shape, kind="serve",
                make_step=lambda mesh: serve_step(cfg),
                abstract_args=lambda: (_params(cfg), _feeds(cfg, b)),
                spec_args=spec_args, model_flops=_flops(cfg, b))


def _train_cell(cfg, shape, b):
    def abstract_args():
        params = _params(cfg)
        opt = _opt_tree(cfg)
        return (params, opt, _feeds(cfg, b, train=True))

    def spec_args():
        pspecs = specs_from_rules(_params(cfg), PARAM_RULES)
        return (pspecs, opt_state_specs(pspecs, OCFG),
                _feed_specs(_feeds(cfg, b, train=True)))

    return Cell(arch=ARCH_ID, shape=shape, kind="train",
                make_step=lambda mesh: train_step(cfg),
                abstract_args=abstract_args, spec_args=spec_args,
                model_flops=_flops(cfg, b) * 3)


def smoke_run(seed=0, device=None):
    """The smoke config's forward, loss and CPS on 8 generated events
    (random weights from ``torch.Generator`` seed ``seed``)."""
    from repro_torch.data.belle2 import Belle2Config, generate
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    cfg = smoke_config()
    gen = Belle2Config(n_crystals=576, grid=(24, 24), n_hits=cfg.n_hits,
                       noise_rate=4.0)
    b = {k: torch.from_numpy(v).to(dev)
         for k, v in generate(gen, 8, seed=seed).items()}
    params = {n: {k: t.to(dev) for k, t in p.items()} for n, p in
              ccn.init(torch.Generator().manual_seed(seed), cfg).items()}
    out = ccn.apply(params, b["feats"], b["mask"], cfg)
    labels = {k: b[k] for k in ("object_id", "energy", "cls")}
    loss, m = condensation_loss(out, labels, b["mask"], k_max=cfg.k_max)
    res = ccn.cps(out, b["mask"], cfg)
    return {"loss": loss, "cps": res, "out": out, "metrics": m}
