"""Mapping pass (paper §III-A "Mapping").

Counterpart of ``repro/core/passes/mapping.py``: maps every operator
onto the template its registry spec declares for its target, and
inserts a ``retile`` operator on every edge whose producer and consumer
layouts differ (``lane128`` for MXU templates, ``compact`` otherwise).
"""
from __future__ import annotations

from repro_torch.core.graph_ir import Graph, Operator
from repro_torch.core.op_registry import require_spec, template_layout


def map_templates(g: Graph) -> Graph:
    g = g.clone()
    for op in g:
        target = op.target or "xla"
        template = require_spec(op).templates.get(target)
        if template is None:
            raise ValueError(f"no template for {(op.op_type, target)}")
        op.template = template
        op.attrs.setdefault("layout", template_layout(op.template))

    # insert retile ops on layout-mismatched edges
    out = Graph()
    renamed: dict[str, dict[str, str]] = {}  # producer -> {layout: name}
    for op in g:
        want = template_layout(op.template)
        new_inputs = []
        for inp in op.inputs:
            prod = out[renamed[inp]["_self"]]
            have = prod.attrs.get("layout", "compact")
            if have == want or prod.op_type in ("input",):
                new_inputs.append(prod.name)
                continue
            cache = renamed[inp]
            if want in cache:
                new_inputs.append(cache[want])
                continue
            rt = Operator(
                name=f"{prod.name}->{want}", op_type="retile",
                inputs=[prod.name],
                attrs={"from": have, "to": want, "layout": want},
                out_dim=prod.out_dim, precision=prod.precision,
                target=op.target, segment=op.segment,
            )
            rt.template = "xla_retile"
            out.add(rt)
            cache[want] = rt.name
            new_inputs.append(rt.name)
        c = op.clone()
        c.inputs = new_inputs
        out.add(c)
        renamed[op.name] = {"_self": c.name}
    out.meta = dict(g.meta)
    out.validate()
    return out
