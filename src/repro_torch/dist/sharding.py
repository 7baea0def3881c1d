"""Logical sharding axes and their resolution against a DeviceMesh.

Counterpart of ``repro/dist/sharding.py``. Model code annotates params
and activations with *logical* axes (``DP`` for the batch/data
dimension, ``TP`` for the model/tensor dimension) in a :class:`P` spec;
:func:`logical_to_physical` resolves those names against the mesh the
launcher built (``torch.distributed.device_mesh.DeviceMesh``, resolved
on its ``mesh_dim_names``). The same ``PARAM_RULES`` then place on the
one-card host mesh (axes of extent 1 are replicated), on the (data,
model) production mesh, and on the multi-pod (pod, data, model) mesh
where DP spans pod×data.

A spec is a :class:`P`, a tuple of entries: ``None``, a name, or a tuple
of names. :class:`NamedSharding` turns a physical spec into DTensor
placements: ``Shard(d)`` on each mesh dim that dimension ``d`` maps to
(several mesh dims split it major first, in mesh order), ``Replicate()``
elsewhere.

:func:`constrain` is ``jax.lax.with_sharding_constraint`` (a
``redistribute``), :func:`einsum` an einsum whose operands may be
DTensors sharded on several of its labels at once (run on the local
shards with the placements it derives; a contracted label that is
sharded leaves a ``Partial`` sum, as GSPMD's partitioned dot does),
:func:`reshape` a reshape that gathers what it would split unevenly, and
:func:`embedding` a lookup into a table whose vocabulary is split.
"""
from __future__ import annotations

import math
import re

DP = "dp"      # data / batch parallel
TP = "tp"      # tensor / model parallel

# logical -> ordered physical candidates; only the ones present in the
# mesh survive (so the host ("data","model") mesh and the multi-pod
# ("pod","data","model") mesh both resolve).
_LOGICAL_TO_MESH = {
    DP: ("pod", "data"),
    TP: ("model",),
}


class P(tuple):
    """A partition spec: ``P(DP, None)`` is the tuple ``("dp", None)``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def axis_sizes(mesh) -> dict:
    """{mesh dim name: extent}."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def logical_to_physical(spec, mesh) -> P:
    """Resolve a logical spec into a physical one for ``mesh``.

    Entries may be ``None``, a logical name ('dp'/'tp'), a physical mesh
    axis name (passed through if the mesh has it), or a tuple of either.
    Logical axes missing from the mesh are dropped (replicated).
    """
    if mesh is None:
        return P(*([None] * len(spec)))
    mesh_axes = set(mesh.mesh_dim_names)

    def resolve_entry(entry):
        if entry is None:
            return None
        names = entry if isinstance(entry, (tuple, list)) else (entry,)
        phys = []
        for name in names:
            for axis in _LOGICAL_TO_MESH.get(name, (name,)):
                if axis in mesh_axes and axis not in phys:
                    phys.append(axis)
        if not phys:
            return None
        return phys[0] if len(phys) == 1 else tuple(phys)

    return P(*[resolve_entry(e) for e in spec])


def _ndim(leaf) -> int:
    shape = getattr(leaf, "shape", leaf)
    return len(tuple(shape))


def map_leaves(fn, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of nested dicts, lists and (non-spec)
    tuples, the structure of ``tree`` kept; a :class:`P` is a leaf, and
    so is whatever ``is_leaf`` accepts."""
    if isinstance(tree, P) or (is_leaf is not None and is_leaf(tree)):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: map_leaves(fn, tree[k], *(r[k] for r in rest),
                              is_leaf=is_leaf) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(fn, t, *(r[i] for r in rest),
                                     is_leaf=is_leaf)
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def specs_from_rules(params, rules):
    """Tree of logical specs from (regex, spec) rules.

    Each leaf's "/"-joined path (dict keys, list indices; as
    ``checkpoint/manager.py:flatten`` names it) is matched against the
    rules in order; the first ``re.search`` hit wins, unmatched leaves
    are replicated (``P()``). Specs are truncated to the leaf's rank so
    a rule written for the stacked (scanned) variant of a weight also
    applies to its unstacked form. A leaf is anything with a ``shape``
    or a shape tuple of ints.
    """
    compiled = [(re.compile(pat), spec) for pat, spec in rules]

    def is_shape(x):
        return isinstance(x, tuple) and not isinstance(x, P) and all(
            isinstance(d, int) for d in x)

    def assign(leaf, path):
        ndim = _ndim(leaf)
        for pat, spec in compiled:
            if pat.search(path):
                entries = list(spec)[:ndim] if ndim else list(spec)
                return P(*entries)
        return P()

    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(tree[k], f"{prefix}{k}/") for k in tree}
        if isinstance(tree, list) or (isinstance(tree, tuple)
                                      and not is_shape(tree)):
            return type(tree)(walk(t, f"{prefix}{i}/")
                              for i, t in enumerate(tree))
        return assign(tree, prefix[:-1])

    return walk(params, "")


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


class NamedSharding:
    """A physical spec on a mesh: ``jax.sharding.NamedSharding``'s
    counterpart, as DTensor placements."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = P(*spec)

    def __repr__(self):
        return f"NamedSharding({self.spec!r})"

    @property
    def placements(self) -> tuple:
        """``Shard(d)`` on each mesh dim of extent > 1 that dimension
        ``d`` maps to, ``Replicate()`` elsewhere."""
        from torch.distributed.tensor import Replicate, Shard
        sizes = axis_sizes(self.mesh)
        out = [Replicate()] * len(sizes)
        names = list(self.mesh.mesh_dim_names)
        for d, entry in enumerate(self.spec):
            for name in _names(entry):
                if sizes[name] > 1:
                    out[names.index(name)] = Shard(d)
        return tuple(out)

    def shard_shape(self, shape) -> tuple:
        """The local shard's shape of a global ``shape``."""
        sizes = axis_sizes(self.mesh)
        out = list(shape)
        for d, entry in enumerate(self.spec):
            for name in _names(entry):
                out[d] //= sizes[name]
        return tuple(out)


def constrain(x, mesh, *axes):
    """``with_sharding_constraint`` with logical axes: ``x`` (a DTensor)
    redistributed to ``P(*axes)`` resolved on ``mesh``; ``x`` itself for
    ``mesh=None`` or a plain tensor."""
    from torch.distributed.tensor import DTensor
    if mesh is None or not isinstance(x, DTensor):
        return x
    spec = logical_to_physical(P(*axes), mesh)
    return x.redistribute(mesh, NamedSharding(mesh, spec).placements)


def is_distributed(*xs) -> bool:
    from torch.distributed.tensor import DTensor
    return any(isinstance(x, DTensor) for x in xs)


def reshape(x, *shape):
    """``x.reshape(*shape)``; a DTensor's dims sharded where the reshape
    would split or merge them unevenly (heads across the model axis,
    d_head before the heads merge, a feature dim before a flatten) are
    gathered first, as the partitioner's reshard does."""
    if not is_distributed(x):
        return x.reshape(*shape)
    if -1 in shape:
        i = shape.index(-1)
        rest = math.prod(d for d in shape if d != -1)
        shape = (*shape[:i], x.numel() // max(rest, 1), *shape[i + 1:])
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    pl = list(x.placements)
    # the dims kept as they are: the leading ones common to both shapes
    keep = 0
    while (keep < min(x.ndim, len(shape))
           and x.shape[keep] == shape[keep]):
        keep += 1
    for m, p in enumerate(pl):
        if not isinstance(p, Shard) or p.dim < keep:
            continue
        # the leading dim of the regrouped ones may stay sharded: when
        # it splits, if its new extent still divides evenly; when it
        # merges with the dims after it, always
        n, new = x.shape[keep], shape[keep]
        split = n % new == 0 and new % mesh.size(m) == 0
        merge = new % n == 0 and new > n
        if not (p.dim == keep and (split or merge)):
            pl[m] = Replicate()
    if pl != list(x.placements):
        x = x.redistribute(mesh, pl)
    return x.reshape(*shape)


def shard_index(mesh, dims) -> int:
    """This rank's shard of a tensor dim split over the mesh dims
    ``dims`` (major first): its offset, in local extents."""
    coord = mesh.get_coordinate()
    index = 0
    for m in dims:
        index = index * mesh.size(m) + coord[m]
    return index


def _labels(eq: str, ndims) -> tuple[list, str]:
    """The einsum's operand label strings with '...' expanded into
    labels of their own (right-aligned), and the output's."""
    ins, out = eq.replace(" ", "").split("->")
    ins = ins.split(",")
    free = iter(c for c in "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
                if c not in eq)
    n_ell = max((nd - (len(s) - 3) for s, nd in zip(ins, ndims)
                 if "..." in s), default=0)
    ell = "".join(next(free) for _ in range(n_ell))
    ins = [s.replace("...", ell[n_ell - (nd - (len(s) - 3)):])
           for s, nd in zip(ins, ndims)]
    return ins, out.replace("...", ell)


def _split(x, dim) -> int:
    """How many shards a DTensor's ``dim`` is split into."""
    from torch.distributed.tensor import Shard
    n = 1
    for m, pl in enumerate(x.placements):
        if isinstance(pl, Shard) and pl.dim == dim:
            n *= x.device_mesh.size(m)
    return n


def einsum(eq: str, *ops, local=None):
    """``torch.einsum``; with DTensor operands, run on their local
    shards. Per mesh dim, the label sharded on the largest operand wins;
    every operand holding that label is split on it (a local slice),
    every other operand is made replicated there (a gather). The output
    is sharded where the label survives and ``Partial`` where it is
    contracted. A ``Partial`` operand is reduced first. ``local``, if
    given, computes the same product in another form (on the shards, and
    on plain tensors)."""
    import torch
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    fn = local or (lambda *xs: torch.einsum(eq, *xs))
    if not is_distributed(*ops):
        return fn(*ops)
    mesh = next(o.device_mesh for o in ops if isinstance(o, DTensor))
    ops = [o if isinstance(o, DTensor) else DTensor.from_local(
        o, mesh, [Replicate()] * mesh.ndim, run_check=False) for o in ops]
    ins, out = _labels(eq, [o.ndim for o in ops])
    in_pl = [[] for _ in ops]
    out_pl = []
    for m in range(mesh.ndim):
        best, size = None, -1
        for s, o in zip(ins, ops):
            pl = o.placements[m]
            # an uneven split stays out: a local shard's result would
            # not tell the global shape
            if (isinstance(pl, Shard) and o.numel() > size
                    and o.shape[pl.dim] % _split(o, pl.dim) == 0):
                best, size = s[pl.dim], o.numel()
        for i, s in enumerate(ins):
            in_pl[i].append(Shard(s.index(best))
                            if best is not None and best in s
                            else Replicate())
        out_pl.append(Replicate() if best is None else
                      Shard(out.index(best)) if best in out else Partial())
    fn = local_map(fn, out_placements=(tuple(out_pl),),
                   in_placements=tuple(tuple(p) for p in in_pl),
                   in_grad_placements=grad_placements(in_pl),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(*ops)


def grad_placements(in_pl) -> tuple:
    """The gradients' placements of a function run on local shards with
    inputs placed ``in_pl`` (one list per input, one placement per mesh
    dim): an input replicated on a mesh dim where another input is
    sharded saw only that shard's part, so its gradient there is a
    ``Partial`` sum; elsewhere the gradient is placed as its input."""
    from torch.distributed.tensor import Partial, Shard
    n_dims = len(in_pl[0]) if in_pl else 0
    split = [any(isinstance(p[m], Shard) for p in in_pl)
             for m in range(n_dims)]
    return tuple(tuple(Partial() if split[m] and not isinstance(pl, Shard)
                       else pl for m, pl in enumerate(p)) for p in in_pl)


def embedding(table, tokens):
    """``F.embedding(tokens, table)`` (the rows of ``table`` (V, D) at
    integer ``tokens``; its gradient sums each row's lookups in a fixed
    order). With DTensors, on each shard: where the vocabulary is split,
    each shard looks up the ids it holds (zeros elsewhere: a ``Partial``
    sum); where the tokens are split on a mesh dim that splits D, the
    table is gathered there first (the FSDP gather); the output follows
    the tokens' and D's sharding."""
    import torch
    import torch.nn.functional as F
    if not is_distributed(table, tokens):
        return F.embedding(tokens.to(torch.long), table)
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard)
    from torch.distributed.tensor.experimental import local_map
    mesh = next(x.device_mesh for x in (table, tokens)
                if isinstance(x, DTensor))
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh,
                                    [Replicate()] * mesh.ndim,
                                    run_check=False)
    tpl, kpl, opl = [], [], []
    v_dims = []
    for m in range(mesh.ndim):
        t = table.placements[m] if isinstance(table, DTensor) \
            else Replicate()
        k = tokens.placements[m]
        if isinstance(k, Shard) and tokens.shape[k.dim] % mesh.size(m):
            k = Replicate()
        if isinstance(k, Shard):
            tpl.append(Replicate())
            kpl.append(k)
            opl.append(k)
        elif t == Shard(0) and table.shape[0] % mesh.size(m) == 0:
            tpl.append(t)
            kpl.append(Replicate())
            opl.append(Partial())
            v_dims.append(m)
        elif t == Shard(1) and table.shape[1] % mesh.size(m) == 0:
            tpl.append(t)
            kpl.append(Replicate())
            opl.append(Shard(tokens.ndim))
        else:
            tpl.append(Replicate())
            kpl.append(Replicate())
            opl.append(Replicate())

    def local(tab, ids):
        ids = ids.to(torch.long)
        if not v_dims:
            return F.embedding(ids, tab)
        ids = ids - shard_index(mesh, v_dims) * tab.shape[0]
        held = (ids >= 0) & (ids < tab.shape[0])
        rows = F.embedding(torch.clamp(ids, 0, tab.shape[0] - 1), tab)
        return rows * held[..., None].to(rows.dtype)

    return local_map(local, out_placements=(tuple(opl),),
                     in_placements=(tuple(tpl), tuple(kpl)),
                     in_grad_placements=grad_placements([tpl, kpl]),
                     device_mesh=mesh, redistribute_inputs=True)(
        table, tokens)
