"""Dataflow-graph IR for the deployment flow.

Counterpart of ``repro/core/graph_ir.py``: nodes are operators (single
layers), edges are data dependencies, and every pass of the design flow
rewrites this graph until ``core/pipeline.py`` executes it. Operator
params hold torch tensors. Op types are declared in
``core/op_registry.py``. A model joins the flow by registering its
``to_graph`` under a name (:func:`register_exporter`); ``export_graph``
calls it and refuses a graph with op types the registry lacks.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable

from repro_torch.core import op_registry as _reg


@dataclass
class Operator:
    name: str
    op_type: str
    inputs: list[str] = field(default_factory=list)
    attrs: dict[str, Any] = field(default_factory=dict)
    params: dict[str, Any] | None = None      # torch tensors (w, b)
    target: str | None = None                 # 'mxu' | 'xla' (partitioner)
    segment: int | None = None                # pipeline segment id
    out_dim: int | None = None                # feature dim of the output
    precision: str = "fp"                     # 'fp' | 'bf16' | 'int8'
    template: str | None = None               # mapping result
    attrs_opt: dict[str, Any] = field(default_factory=dict)  # kernel knobs

    def clone(self) -> "Operator":
        return dataclasses.replace(
            self,
            inputs=list(self.inputs),
            attrs=dict(self.attrs),
            params=None if self.params is None else dict(self.params),
            attrs_opt=dict(self.attrs_opt),
        )


class Graph:
    """Ordered operator graph. Insertion order must be a topological order
    (validated); passes keep it that way."""

    def __init__(self, ops: list[Operator] | None = None):
        self.ops: dict[str, Operator] = {}
        self.meta: dict[str, Any] = {}
        for op in ops or []:
            self.add(op)

    def add(self, op: Operator) -> Operator:
        if op.name in self.ops:
            raise ValueError(f"duplicate operator {op.name}")
        for inp in op.inputs:
            if inp not in self.ops:
                raise ValueError(
                    f"{op.name} depends on undefined {inp} (topo order)")
        self.ops[op.name] = op
        return op

    def clone(self) -> "Graph":
        g = Graph([op.clone() for op in self.ops.values()])
        g.meta = dict(self.meta)
        return g

    def __iter__(self):
        return iter(self.ops.values())

    def __getitem__(self, name: str) -> Operator:
        return self.ops[name]

    def __len__(self):
        return len(self.ops)

    def successors(self, name: str) -> list[Operator]:
        return [op for op in self.ops.values() if name in op.inputs]

    def outputs(self) -> list[Operator]:
        return [op for op in self.ops.values() if op.op_type == "output"]

    def rewire(self, old: str, new: str) -> None:
        """Point every consumer of ``old`` at ``new``."""
        for op in self.ops.values():
            op.inputs = [new if i == old else i for i in op.inputs]

    def remove(self, name: str) -> None:
        if self.successors(name):
            raise ValueError(f"cannot remove {name}: has consumers")
        del self.ops[name]

    def validate(self) -> None:
        seen: set[str] = set()
        for op in self.ops.values():
            for inp in op.inputs:
                if inp not in seen:
                    raise ValueError(f"{op.name} reads {inp} before def")
            seen.add(op.name)


# ------------------------------------------------------------------------
# exporter registry: how a model joins the deploy flow
_EXPORTERS: dict[str, Callable] = {}


def register_exporter(name: str, fn: Callable) -> Callable:
    """Register a model's ``to_graph(params, cfg) -> Graph`` under a
    stable name. The graph it returns is validated, uses registered op
    types only and sets ``g.meta["config"]``."""
    if name in _EXPORTERS:
        raise ValueError(f"exporter {name!r} already registered")
    _EXPORTERS[name] = fn
    return fn


def exporters() -> tuple[str, ...]:
    return tuple(sorted(_EXPORTERS))


def export_graph(name: str, params: Any, cfg: Any) -> Graph:
    """Export a registered model to graph IR, rejecting graphs with op
    types no pass recognizes (the same preflight ``deploy()`` runs)."""
    if name not in _EXPORTERS:
        raise KeyError(f"no exporter {name!r}; registered: "
                       f"{', '.join(exporters()) or '(none)'}")
    g = _EXPORTERS[name](params, cfg)
    bad = _reg.unknown_ops(g)
    if bad:
        listing = ", ".join(f"{n} ({t!r})" for n, t in bad)
        raise _reg.UnknownOperatorError(
            f"exporter {name!r} emitted unregistered op types: {listing}")
    return g
