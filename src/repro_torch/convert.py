"""Weights from the JAX package into the port.

The JAX package keeps CaloClusterNet's parameters as a dict of dense
params ``{name: {"w": (d_in, d_out), "b": (d_out,)}}``; the port keeps
the same dict with torch tensors in the same layout. ``params_np`` is
that dict with numpy leaves, as
``jax.tree_util.tree_map(np.asarray, params)`` gives it — numpy is the
hand-off, so this module imports no JAX. The edge-based GNNs' nested
trees (lists of layers of dense params) convert the same way
(:func:`from_jax_gnn_params`), and so does the reference's AdamW state
for CaloClusterNet, plain or q8-packed (:func:`from_jax_adamw_state`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.caloclusternet import CCNConfig, param_shapes
from repro_torch.device import resolve_device
from repro_torch.models.gnn import gatedgcn, graphsage
from repro_torch.optim.adamw import BLOCK


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


def _q8_state(p, n, path, dev) -> dict:
    """One q8-packed moment ``{"q": int8 (nb*256,), "scale": f32 (nb,)}``
    of a parameter with ``n`` values."""
    if not isinstance(p, dict) or set(p) != {"q", "scale"}:
        got = sorted(p) if isinstance(p, dict) else type(p).__name__
        raise ValueError(f"{path}: state {got}, want ['q', 'scale']")
    nb = -(-n // BLOCK)
    q, scale = np.asarray(p["q"]), np.asarray(p["scale"])
    if q.shape != (nb * BLOCK,) or scale.shape != (nb,):
        raise ValueError(f"{path}: q {q.shape}, scale {scale.shape}, want "
                         f"{(nb * BLOCK,)}, {(nb,)}")
    return {"q": torch.from_numpy(np.array(q, dtype=np.int8)).to(dev),
            "scale": torch.from_numpy(
                np.array(scale, dtype=np.float32)).to(dev)}


def from_jax_adamw_state(state_np: dict, cfg: CCNConfig,
                         device=None) -> dict:
    """The port's AdamW state (``repro_torch.optim.adamw``) for
    CaloClusterNet ``cfg`` from the JAX package's, as numpy: ``m`` and
    ``v`` shaped like the params (f32) or, for ``quantize_states``,
    q8-packed per parameter (``{"q", "scale"}``), and ``step``. Raises
    on a missing, extra or misshapen array."""
    dev = resolve_device(device)
    want = param_shapes(cfg)
    if set(state_np) != {"m", "v", "step"}:
        raise ValueError(f"state keys {sorted(state_np)}, want "
                         "['m', 'step', 'v']")
    out = {"step": torch.tensor(int(np.asarray(state_np["step"])),
                                dtype=torch.int32, device=dev)}
    for mom in ("m", "v"):
        tree = state_np[mom]
        if set(tree) != set(want):
            raise ValueError(f"{mom}: layers {sorted(set(tree) ^ set(want))}"
                             " are missing or unexpected")
        out[mom] = {}
        for name, (d_in, d_out) in want.items():
            leaf = tree[name]
            first = leaf.get("w") if isinstance(leaf, dict) else None
            if isinstance(first, dict):          # q8-packed moments
                out[mom][name] = {
                    key: _q8_state(leaf.get(key), n, f"{mom}/{name}/{key}",
                                   dev)
                    for key, n in (("w", d_in * d_out), ("b", d_out))}
            else:
                out[mom][name] = _dense(leaf, d_in, d_out, f"{mom}/{name}",
                                        dev)
    return out


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
