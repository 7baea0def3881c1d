"""Weights from the JAX package into the port.

The JAX package keeps CaloClusterNet's parameters as a dict of dense
params ``{name: {"w": (d_in, d_out), "b": (d_out,)}}``; the port keeps
the same dict with torch tensors in the same layout. ``params_np`` is
that dict with numpy leaves, as
``jax.tree_util.tree_map(np.asarray, params)`` gives it — numpy is the
hand-off, so this module imports no JAX. The edge-based GNNs' nested
trees (lists of layers of dense params) convert the same way
(:func:`from_jax_gnn_params`; DimeNet's and NequIP's too), and so does
the reference's AdamW state,
plain or q8-packed (:func:`from_jax_adamw_state`). The LM transformer's
tree (:func:`from_jax_lm_params`: per-layer leaves stacked on a leading
axis), its KV cache (:func:`from_jax_kv_cache`) and MIND's tree
(:func:`from_jax_mind_params`) are copied leaf for leaf; a bfloat16 array
(``ml_dtypes``, as ``np.asarray`` gives a JAX bf16 array) keeps its bits.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.caloclusternet import CCNConfig, param_shapes
from repro_torch.device import resolve_device
from repro_torch.models import recsys, transformer
from repro_torch.models.gnn import dimenet, gatedgcn, graphsage, nequip
from repro_torch.optim.adamw import BLOCK


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


def _tensor(a, dtype, dev) -> torch.Tensor:
    """A writable tensor copy of array ``a`` on ``dev``, in ``dtype``
    (None: the array's own); a bfloat16 array keeps its bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a.view(np.int16))).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(dev, dtype) if dtype is not None else t.to(dev)


def _array_tree(tree, shapes, path, dev, dtype, moments=False):
    """Walk ``shapes`` (dicts and lists whose leaves are shape tuples)
    and ``tree`` (the same structure, arrays at the leaves, or for
    ``moments`` also q8-packed ``{"q", "scale"}`` leaves) together;
    raise where they differ."""
    if isinstance(shapes, tuple):
        if moments and isinstance(tree, dict):
            return _q8_state(tree, int(np.prod(shapes)), path, dev)
        a = np.asarray(tree)
        if a.shape != shapes:
            raise ValueError(f"{path}: shape {a.shape}, want {shapes}")
        return _tensor(a, dtype, dev)
    if isinstance(shapes, list):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(shapes):
            raise ValueError(f"{path}: want a list of {len(shapes)}")
        return [_array_tree(t, s, f"{path}/{i}", dev, dtype, moments)
                for i, (t, s) in enumerate(zip(tree, shapes))]
    if not isinstance(tree, dict) or set(tree) != set(shapes):
        got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
        raise ValueError(f"{path or 'top level'}: params keys {got}, want "
                         f"{sorted(shapes)}")
    return {k: _array_tree(tree[k], s, f"{path}/{k}".lstrip("/"), dev,
                           dtype, moments)
            for k, s in shapes.items()}


def _dense_shapes(shapes):
    """A tree of denses' (d_in, d_out) (dicts and lists) as the shapes
    of their arrays: each leaf becomes ``{"w": (d_in, d_out), "b":
    (d_out,)}``."""
    if isinstance(shapes, tuple):
        return {"w": shapes, "b": shapes[1:]}
    if isinstance(shapes, list):
        return [_dense_shapes(s) for s in shapes]
    return {k: _dense_shapes(s) for k, s in shapes.items()}


_GNNS = {gatedgcn.GatedGCNConfig: gatedgcn,
         graphsage.GraphSAGEConfig: graphsage}
#: the geometric GNNs, whose trees mix denses with and without a bias
#: and raw arrays: their ``param_shapes`` give every array's shape
_GEOMETRIC = {dimenet.DimeNetConfig: dimenet, nequip.NequIPConfig: nequip}


def _tree_shapes(cfg) -> dict:
    """The shapes of ``cfg``'s parameter tree, as :func:`_array_tree`
    walks them."""
    if isinstance(cfg, CCNConfig):
        return _dense_shapes(param_shapes(cfg))
    if type(cfg) in _GNNS:
        return _dense_shapes(_GNNS[type(cfg)].param_shapes(cfg))
    if type(cfg) in _GEOMETRIC:
        return _GEOMETRIC[type(cfg)].param_shapes(cfg)
    if isinstance(cfg, transformer.TransformerConfig):
        return transformer.abstract_params(cfg)
    if isinstance(cfg, recsys.MINDConfig):
        return recsys.param_shapes(cfg)
    raise TypeError(f"no parameter layout for {type(cfg).__name__}")


def from_jax_params(params_np: dict, cfg: CCNConfig, device=None) -> dict:
    """The port's parameter dict for ``cfg`` from the JAX package's,
    f32 on ``device``. Raises on a missing, extra or misshapen array."""
    return _array_tree(params_np, _dense_shapes(param_shapes(cfg)), "",
                       resolve_device(device), torch.float32)


def from_jax_adamw_state(state_np: dict, cfg, device=None) -> dict:
    """The port's AdamW state (``repro_torch.optim.adamw``) for ``cfg``
    (CaloClusterNet, a GNN, a transformer or MIND) from the JAX
    package's, as numpy: ``m`` and ``v`` shaped like the params (f32)
    or, for ``quantize_states``, q8-packed per parameter (``{"q",
    "scale"}``), and ``step``. Raises on a missing, extra or misshapen
    array."""
    dev = resolve_device(device)
    if set(state_np) != {"m", "v", "step"}:
        raise ValueError(f"state keys {sorted(state_np)}, want "
                         "['m', 'step', 'v']")
    shapes = _tree_shapes(cfg)
    out = {mom: _array_tree(state_np[mom], shapes, mom, dev, torch.float32,
                            moments=True) for mom in ("m", "v")}
    out["step"] = torch.tensor(int(np.asarray(state_np["step"])),
                               dtype=torch.int32, device=dev)
    return out


def from_jax_gnn_params(params_np: dict, cfg, device=None) -> dict:
    """The port's parameter tree of a GatedGCN, GraphSAGE, DimeNet or
    NequIP for ``cfg`` from the JAX package's (numpy leaves), on
    ``device``: GatedGCN's ``embed_h``, ``embed_e``, ``head`` and
    ``layers[i].{A,B,Ce,U,V}``, GraphSAGE's ``layers[i].w`` and
    ``head``, each dense ``{"w": (d_in, d_out), "b": (d_out,)}``;
    DimeNet's and NequIP's trees as their ``param_shapes`` give them
    (DimeNet's raw ``w_bil``, NequIP's ``self``/``skip`` dicts keyed
    ``l{l}p{parity}``, denses with no ``b`` where the reference's have
    none). Raises on a missing, extra or misshapen array."""
    if type(cfg) not in _GNNS and type(cfg) not in _GEOMETRIC:
        raise TypeError(f"no GNN parameter layout for {type(cfg).__name__}")
    return _array_tree(params_np, _tree_shapes(cfg), "",
                       resolve_device(device), torch.float32)


def from_jax_lm_params(params_np: dict, cfg, device=None) -> dict:
    """The port's transformer parameters for ``cfg`` from the JAX
    package's (numpy leaves), in ``cfg.param_dtype`` on ``device``:
    ``embed``, ``final_norm``, ``lm_head`` and ``layers/<name>`` stacked
    (L, ...). Raises on a missing, extra or misshapen array."""
    return _array_tree(params_np, transformer.abstract_params(cfg), "",
                       resolve_device(device), cfg.param_dtype)


def from_jax_kv_cache(cache_np: dict, cfg, device=None) -> dict:
    """A KV cache of ``transformer.init_cache``/``prefill``/
    ``decode_step`` from the JAX package's (numpy leaves), each leaf in
    its own dtype (bf16 or f32 k/v, or int8 with f32 scales; int32
    'pos') on ``device``. Raises on missing, extra or misshaped
    leaves."""
    dev = resolve_device(device)
    k = np.asarray(cache_np.get("k"))
    if k.ndim != 5 or k.shape[0] != cfg.n_layers or \
            k.shape[3:] != (cfg.n_kv_heads, cfg.dh):
        raise ValueError(f"k: shape {k.shape}, want (L={cfg.n_layers}, B, "
                         f"T, {cfg.n_kv_heads}, {cfg.dh})")
    L, b, t = k.shape[:3]
    shapes = {"k": k.shape, "v": k.shape, "pos": (L, b)}
    if cfg.kv_cache_int8 or "k_scale" in cache_np:
        shapes.update(k_scale=(L, b, t, cfg.n_kv_heads),
                      v_scale=(L, b, t, cfg.n_kv_heads))
    return _array_tree(cache_np, shapes, "cache", dev, None)


def from_jax_mind_params(params_np: dict, cfg, device=None) -> dict:
    """The port's MIND parameters for ``cfg`` from the JAX package's
    (numpy leaves), f32 on ``device``: ``item_emb``, ``tag_emb``,
    ``bilinear_s`` and ``proj/{w,b}``. Raises on a missing, extra or
    misshapen array."""
    return _array_tree(params_np, recsys.param_shapes(cfg), "",
                       resolve_device(device), torch.float32)
