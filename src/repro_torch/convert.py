"""Weights from the JAX package into the port.

The JAX package keeps CaloClusterNet's parameters as a dict of dense
params ``{name: {"w": (d_in, d_out), "b": (d_out,)}}``; the port keeps
the same dict with torch tensors in the same layout. ``params_np`` is
that dict with numpy leaves, as
``jax.tree_util.tree_map(np.asarray, params)`` gives it — numpy is the
hand-off, so this module imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.caloclusternet import CCNConfig, param_shapes
from repro_torch.device import resolve_device


def from_jax_params(params_np: dict, cfg: CCNConfig, device=None) -> dict:
    """The port's parameter dict for ``cfg`` from the JAX package's,
    on ``device``. Raises on a missing, extra or misshapen array."""
    dev = resolve_device(device)
    want = param_shapes(cfg)
    if set(params_np) != set(want):
        raise ValueError(f"layers {sorted(set(params_np) ^ set(want))} "
                         "are missing or unexpected")
    out = {}
    for name, (d_in, d_out) in want.items():
        p = params_np[name]
        if set(p) != {"w", "b"}:
            raise ValueError(f"{name}: params {sorted(p)}, want ['b', 'w']")
        shapes = {"w": (d_in, d_out), "b": (d_out,)}
        out[name] = {}
        for key, shape in shapes.items():
            a = np.asarray(p[key])
            if a.shape != shape:
                raise ValueError(f"{name}/{key}: shape {a.shape}, "
                                 f"want {shape}")
            out[name][key] = torch.from_numpy(
                np.array(a, dtype=np.float32)).to(dev)   # a writable copy
    return out
