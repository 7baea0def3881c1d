"""Optimizers and schedules; counterpart of ``repro/optim`` (gradient
compression in ``optim/compress.py``)."""
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.schedule import cosine_warmup

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_warmup"]
