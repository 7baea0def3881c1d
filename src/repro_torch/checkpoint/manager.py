"""Fault-tolerant checkpointing: async, atomic, rotating.

Counterpart of ``repro/checkpoint/manager.py``, with its on-disk format
byte for byte, so that a checkpoint written by either package restores
in the other:

- one ``step_%08d/`` directory per checkpoint, written to ``<dir>.tmp``
  and committed by an atomic rename — a crash mid-write never corrupts
  the latest checkpoint;
- one ``leaf_%05d.npy`` per leaf, in the reference's leaf order, and a
  ``manifest.json`` holding each leaf's path, file, shape, numpy dtype
  string and crc32, and the step.

A tree is nested dicts and lists of tensors (or numpy arrays), as the
port's parameter and AdamW trees are. Leaves are named as
``jax.tree_util.tree_flatten_with_path`` names them: dict keys sorted,
list items by index (``layers/0/A/w``), a q8 moment ``{"q", "scale"}``
down to its two leaves.

``async_=True`` snapshots every leaf to host memory synchronously (a
copy, device to host; on the card this orders the snapshot after every
step enqueued before it) and writes the files on a background thread.
``CheckpointManager`` rotates the last ``keep`` checkpoints and verifies
checksums on restore. ``restore(..., mesh=, shardings=)`` is the
reference's elastic restore: each leaf comes back as a DTensor on the
mesh, every rank reading the ``.npy`` and keeping its own slice (the
counterpart of ``device_put`` of a host array).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib

import numpy as np
import torch

from repro_torch.device import resolve_device

def flatten(tree, prefix: str = "") -> list:
    """[(path, leaf)] in the reference's order: dict keys sorted, list
    items by index, every dict (a q8 state's too) walked down to its
    leaves."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in flatten(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree)
                for x in flatten(t, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def unflatten(like, leaves):
    """``like``'s structure with its leaves, in :func:`flatten`'s order,
    taken from the iterator ``leaves``."""
    if isinstance(like, dict):
        return {k: unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(unflatten(t, leaves) for t in like)
    return next(leaves)


def _host(leaf) -> np.ndarray:
    """A host copy of ``leaf``, unaffected by later writes to it."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def save(ckpt_dir: str, step: int, tree, *, async_: bool = False):
    """Write one checkpoint at <ckpt_dir>/step_<step>."""
    host = [(name, _host(leaf)) for name, leaf in flatten(tree)]

    def _write():
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "leaves": []}
        for i, (name, arr) in enumerate(host):
            fn = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fn), arr)
            manifest["leaves"].append({
                "path": name, "file": fn, "shape": list(arr.shape),
                "dtype": str(arr.dtype),
                "crc": zlib.crc32(np.ascontiguousarray(arr).tobytes()),
            })
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    if async_:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def latest_step(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like_tree, *, mesh=None,
            shardings=None, verify: bool = True, device=None):
    """Load checkpoint ``step`` shaped like ``like_tree`` (the same
    structure; its leaves name the device). Each leaf comes back as a
    tensor on the device of ``like_tree``'s leaf where that is a tensor,
    else on ``device`` (None: the card). With ``shardings`` (a matching
    tree of ``dist.sharding.NamedSharding`` or specs, resolved on
    ``mesh``) a leaf comes back as a DTensor on its sharding's mesh,
    this rank holding its own slice. Returns (tree, step); raises
    ``IOError`` on a checksum mismatch and ``ValueError`` when the
    checkpoint lacks a leaf of ``like_tree``."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    leaves = flatten(like_tree)
    missing = [name for name, _ in leaves if name not in by_path]
    if missing:
        raise ValueError(f"{d} holds no leaf {missing[0]!r} ({len(missing)} "
                         f"of {len(leaves)} missing): a checkpoint of "
                         "another model; give this run its own ckpt_dir")
    shard_flat = (_sharding_leaves(shardings, mesh)
                  if shardings is not None else [None] * len(leaves))
    fallback = None
    out = []
    for (name, like), shd in zip(leaves, shard_flat):
        e = by_path[name]
        arr = np.load(os.path.join(d, e["file"]))
        if verify:
            crc = zlib.crc32(np.ascontiguousarray(arr).tobytes())
            if crc != e["crc"]:
                raise IOError(f"checksum mismatch for {name} in {d}")
        if shd is not None:
            out.append(_place(arr, shd))
            continue
        if isinstance(like, torch.Tensor):
            dev = like.device
        else:
            fallback = fallback or resolve_device(device)
            dev = fallback
        out.append(torch.from_numpy(arr).to(dev))
    return unflatten(like_tree, iter(out)), manifest["step"]


def _sharding_leaves(shardings, mesh) -> list:
    """The shardings tree's leaves in :func:`flatten`'s order, each a
    ``NamedSharding`` (a spec resolved on ``mesh``) or None."""
    from repro_torch.dist.sharding import (NamedSharding, P,
                                           logical_to_physical)

    def walk(tree):
        if tree is None or isinstance(tree, NamedSharding):
            return [tree]
        if isinstance(tree, P):
            if mesh is None:
                raise ValueError("a spec in shardings needs a mesh")
            return [NamedSharding(mesh, logical_to_physical(tree, mesh))]
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in walk(tree[k])]
        if isinstance(tree, (list, tuple)):
            return [x for t in tree for x in walk(t)]
        raise TypeError(f"not a sharding: {tree!r}")
    return walk(shardings)


def _place(arr: np.ndarray, shd):
    """The host array as a DTensor on ``shd``: this rank's slice, cut
    from its own copy (no rank sends anything)."""
    from torch.distributed.tensor import distribute_tensor
    mesh = shd.mesh
    t = torch.from_numpy(arr).to(mesh.device_type)
    return distribute_tensor(t, mesh, shd.placements, src_data_rank=None)


class CheckpointManager:
    def __init__(self, ckpt_dir: str, *, keep: int = 3,
                 async_: bool = True):
        self.dir = ckpt_dir
        self.keep = keep
        self.async_ = async_
        self._pending: threading.Thread | None = None
        os.makedirs(ckpt_dir, exist_ok=True)

    def save(self, step: int, tree):
        self.wait()
        self._pending = save(self.dir, step, tree, async_=self.async_)
        if not self.async_:
            self._gc()

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None
            self._gc()

    def _gc(self):
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.dir)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def latest(self):
        return latest_step(self.dir)

    def restore_latest(self, like_tree, *, mesh=None, shardings=None,
                       device=None):
        self.wait()
        s = self.latest()
        if s is None:
            return None, None
        return restore(self.dir, s, like_tree, mesh=mesh,
                       shardings=shardings, device=device)
