"""Cell abstraction: one (architecture × input-shape) dry-run unit.

Counterpart of ``repro/configs/base.py``. Every config module exposes
``cell(shape_name) -> Cell``. ``abstract_args()`` is a tree of
:class:`sds` records (shape and dtype: nothing is allocated),
``spec_args()`` the same tree of logical specs, and ``make_step(mesh)``
the step function, which takes tensors (DTensors placed by
:meth:`Cell.resolve_shardings` on a mesh). ``model_flops`` is the
analytic useful-FLOPs estimate of the roofline's MODEL_FLOPS ratio.

:meth:`Cell.lower` is the counterpart of ``jit(...).lower(...)``: one
run of the step on fake DTensors (``FakeTensorMode`` over the mesh's
world) under the counting mode of ``launch/analysis.py``, which returns
the per-device cost record.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.dist.sharding import (NamedSharding, P, axis_sizes,
                                       logical_to_physical, map_leaves)


@dataclasses.dataclass(frozen=True)
class sds:
    """``jax.ShapeDtypeStruct``: a shape and a dtype."""
    shape: tuple
    dtype: Any

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(d) for d in self.shape))

    @property
    def ndim(self) -> int:
        return len(self.shape)


def is_sds(x) -> bool:
    return isinstance(x, sds)


def eval_shape(fn, *args):
    """``jax.eval_shape``: ``fn`` run on fake tensors shaped as the
    :class:`sds` leaves of ``args`` (other leaves passed as they are);
    the tensors of its result become :class:`sds`. Nothing is
    allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True):
        fargs = map_leaves(
            lambda x: torch.empty(x.shape, dtype=x.dtype) if is_sds(x)
            else x, args, is_leaf=is_sds)
        out = fn(*fargs)
        return map_leaves(
            lambda x: sds(x.shape, x.dtype) if isinstance(x, torch.Tensor)
            else x, out)


def shapes_of(tree):
    """The :class:`sds` of every tensor of ``tree`` (a small model's
    parameters, made for real: a truncated-normal init draws until its
    samples fit, which fake tensors cannot run)."""
    return map_leaves(lambda x: sds(x.shape, x.dtype)
                      if isinstance(x, torch.Tensor) else x, tree)


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str                                  # train|prefill|decode|serve
    make_step: Callable[[Any], Callable]       # mesh -> step fn
    abstract_args: Callable[[], tuple]         # () -> tree of sds
    spec_args: Callable[[], tuple]             # () -> tree of logical P
    model_flops: float = 0.0
    sublowerings: Callable | None = None       # for scan-corrected costs

    def __post_init__(self):
        build = self.make_step

        def make_step(mesh):
            step = build(mesh)
            if mesh is None:
                return step

            def on_mesh(*args):
                # tensors a step makes (positions, masks, zeros) are the
                # same on every rank: replicated DTensors where they meet
                # the arguments' DTensors
                from torch.distributed.tensor.experimental import \
                    implicit_replication
                with implicit_replication():
                    return step(*args)
            return on_mesh
        self.make_step = make_step

    @property
    def name(self):
        return f"{self.arch}:{self.shape}"

    def resolve_shardings(self, mesh):
        """Logical specs -> :class:`NamedSharding` tree, sanitized
        against the argument shapes as the reference's is: an axis whose
        mesh extent does not divide the dimension is dropped (e.g. vocab
        49155 vs tp 16, d_in 1433 vs dp), and specs are truncated to the
        value rank."""
        sizes = axis_sizes(mesh)

        def extent(entry):
            if entry is None:
                return 1
            names = entry if isinstance(entry, (tuple, list)) else (entry,)
            n = 1
            for nm in names:
                n *= sizes[nm]
            return n

        def fix(spec, arg):
            phys = list(logical_to_physical(spec, mesh))[:len(arg.shape)]
            out = [e if e is None or arg.shape[i] % extent(e) == 0
                   else None for i, e in enumerate(phys)]
            return NamedSharding(mesh, P(*out))

        return map_leaves(fix, self.spec_args(), self.abstract_args())

    def lower(self, mesh) -> dict:
        """The step's per-device cost record on ``mesh`` (a fake world's
        mesh): ``launch.analysis.trace_costs``."""
        from repro_torch.launch import analysis
        return analysis.trace_costs(self.make_step(mesh),
                                    self.abstract_args(),
                                    self.resolve_shardings(mesh))


def place(args, shardings, make_local):
    """DTensors of the global shapes of ``args`` (tensors or sds) on
    their shardings: ``make_local(arg, sharding)`` gives each rank's
    shard, wrapped with ``DTensor.from_local``."""
    from torch.distributed.tensor import DTensor

    def one(arg, sh):
        local = make_local(arg, sh)
        return DTensor.from_local(local, sh.mesh, sh.placements,
                                  run_check=False, shape=tuple(arg.shape),
                                  stride=_contiguous(arg.shape))
    return map_leaves(one, args, shardings, is_leaf=is_sds)


def _contiguous(shape) -> tuple:
    stride, acc = [], 1
    for d in reversed(tuple(shape)):
        stride.append(acc)
        acc *= d
    return tuple(reversed(stride))


def distribute(args, shardings):
    """``jax.device_put(args, shardings)``: each tensor of ``args`` split
    onto its sharding's mesh, on the mesh's device (the same tensor is
    on every rank; each keeps its own slice, no rank sends anything)."""
    from torch.distributed.tensor import distribute_tensor
    return map_leaves(
        lambda a, sh: distribute_tensor(a.to(sh.mesh.device_type), sh.mesh,
                                        sh.placements, src_data_rank=None),
        args, shardings)
