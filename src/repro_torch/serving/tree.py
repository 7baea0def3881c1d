"""Output trees of the serving layer.

A result is a tree: nested dicts (CaloClusterNet's heads and its ``cps``
dict), lists or tuples, whose leaves are numpy arrays or tensors. The
replica loops flatten a batch's result, bring every leaf to the host and
cut it per event (the reference does this with ``jax.tree_util``).
"""
from __future__ import annotations

import numpy as np
import torch


def tree_flatten(tree) -> tuple[list, object]:
    """(leaves, structure): dict keys in sorted order, as
    ``jax.tree_util`` orders them."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [tree_flatten(tree[k]) for k in keys]
        return ([leaf for p in parts for leaf in p[0]],
                ("dict", keys, [p[1] for p in parts]))
    if isinstance(tree, (list, tuple)):
        parts = [tree_flatten(v) for v in tree]
        return ([leaf for p in parts for leaf in p[0]],
                (type(tree), None, [p[1] for p in parts]))
    return [tree], None


def tree_unflatten(structure, leaves):
    """The tree of ``structure`` (from :func:`tree_flatten`) with
    ``leaves`` in its places."""
    it = iter(leaves)

    def build(s):
        if s is None:
            return next(it)
        kind, keys, children = s
        vals = [build(c) for c in children]
        return dict(zip(keys, vals)) if kind == "dict" else kind(vals)
    return build(structure)


def host_array(leaf) -> np.ndarray:
    """A leaf as a numpy array on the host: a CPU tensor's view, a
    device tensor copied back, anything else through ``np.asarray``."""
    if isinstance(leaf, torch.Tensor):
        return (leaf if leaf.device.type == "cpu" else leaf.cpu()).numpy()
    return np.asarray(leaf)
