"""Weights from the JAX package into the port.

The JAX package keeps CaloClusterNet's parameters as a dict of dense
params ``{name: {"w": (d_in, d_out), "b": (d_out,)}}``; the port keeps
the same dict with torch tensors in the same layout. ``params_np`` is
that dict with numpy leaves, as
``jax.tree_util.tree_map(np.asarray, params)`` gives it — numpy is the
hand-off, so this module imports no JAX. The edge-based GNNs' nested
trees (lists of layers of dense params) convert the same way
(:func:`from_jax_gnn_params`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.caloclusternet import CCNConfig, param_shapes
from repro_torch.device import resolve_device
from repro_torch.models.gnn import gatedgcn, graphsage


def _dense(p, d_in, d_out, path, dev) -> dict:
    """One dense's ``{"w": (d_in, d_out), "b": (d_out,)}`` as tensors
    on ``dev``."""
    if not isinstance(p, dict) or set(p) != {"w", "b"}:
        got = sorted(p) if isinstance(p, dict) else type(p).__name__
        raise ValueError(f"{path}: params {got}, want ['b', 'w']")
    out = {}
    for key, shape in (("w", (d_in, d_out)), ("b", (d_out,))):
        a = np.asarray(p[key])
        if a.shape != shape:
            raise ValueError(f"{path}/{key}: shape {a.shape}, want {shape}")
        out[key] = torch.from_numpy(
            np.array(a, dtype=np.float32)).to(dev)   # a writable copy
    return out


def from_jax_params(params_np: dict, cfg: CCNConfig, device=None) -> dict:
    """The port's parameter dict for ``cfg`` from the JAX package's,
    on ``device``. Raises on a missing, extra or misshapen array."""
    dev = resolve_device(device)
    want = param_shapes(cfg)
    if set(params_np) != set(want):
        raise ValueError(f"layers {sorted(set(params_np) ^ set(want))} "
                         "are missing or unexpected")
    return {name: _dense(params_np[name], *shape, name, dev)
            for name, shape in want.items()}


def _dense_tree(tree, shapes, path, dev):
    """Walk ``shapes`` (dicts and lists whose leaves are (d_in, d_out))
    and ``tree`` (the same structure, each leaf a dense's params)
    together; raise where they differ."""
    if isinstance(shapes, tuple):
        return _dense(tree, *shapes, path, dev)
    if isinstance(shapes, list):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(shapes):
            raise ValueError(f"{path}: want a list of {len(shapes)}")
        return [_dense_tree(t, s, f"{path}/{i}", dev)
                for i, (t, s) in enumerate(zip(tree, shapes))]
    if not isinstance(tree, dict) or set(tree) != set(shapes):
        got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
        raise ValueError(f"{path or 'params'}: keys {got}, want "
                         f"{sorted(shapes)}")
    return {k: _dense_tree(tree[k], s, f"{path}/{k}".lstrip("/"), dev)
            for k, s in shapes.items()}


def from_jax_gnn_params(params_np: dict, cfg, device=None) -> dict:
    """The port's parameter tree of a GatedGCN or GraphSAGE for ``cfg``
    from the JAX package's (numpy leaves), on ``device``: GatedGCN's
    ``embed_h``, ``embed_e``, ``head`` and ``layers[i].{A,B,Ce,U,V}``,
    GraphSAGE's ``layers[i].w`` and ``head``, each dense
    ``{"w": (d_in, d_out), "b": (d_out,)}``. Raises on a missing, extra
    or misshapen array."""
    models = {gatedgcn.GatedGCNConfig: gatedgcn,
              graphsage.GraphSAGEConfig: graphsage}
    if type(cfg) not in models:
        raise TypeError(f"no GNN parameter layout for {type(cfg).__name__}")
    return _dense_tree(params_np, models[type(cfg)].param_shapes(cfg), "",
                       resolve_device(device))
