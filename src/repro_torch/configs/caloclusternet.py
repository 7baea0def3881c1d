"""caloclusternet [trigger] — the paper's own architecture.

Counterpart of ``repro/configs/caloclusternet.py`` without its cells
(``ROADMAP.md`` queue 1 item 7). Variants: 'upgrade' (128 of 8736
inputs — the paper's target) and 'current' (32 of 576 — the deployed
detector). Shapes: trigger_serve (streaming inference, the
hardware-trigger path incl. CPS) and condensation_train
(object-condensation training)."""
import torch

from repro_torch.core import caloclusternet as ccn
from repro_torch.core.condensation import condensation_loss
from repro_torch.optim import AdamWConfig, cosine_warmup

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
