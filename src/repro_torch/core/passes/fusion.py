"""Operator-fusion pass (paper §III-A "Operator Fusion").

Counterpart of ``repro/core/passes/fusion.py``. Three registered
rewrites, replayed by ``fuse()`` in registration order:

1. **Linear+ReLU → Dense**: a ``linear`` whose only consumer is a
   ``relu`` becomes one ``dense`` carrying the activation.
2. **GravNet-block fusion** (opt-in, ``fuse(g, gravnet_block=True)``):
   ``dense(S) ∥ dense(F) → gravnet_aggregate [→ concat(x, agg)] →
   dense(out)`` collapses into one ``gravnet_block`` operator, lowered
   onto the block kernel. Chains it cannot fuse losslessly stay
   unfused: an extra consumer of a projection or the aggregate,
   activations on the projections, missing biases, or mixed member
   precisions. A uniform int8 chain fuses only when it is calibrated
   (quantized weights and activation scales present), and then carries
   them onto the block, which lowers onto the quantized kernel; an
   uncalibrated int8 chain stays unfused.
3. **Parallel-Dense merge**: sibling denses reading the same single
   input with the same activation and precision merge into one wide
   dense (weights concatenated by column); consumers read ``slice``
   views.
"""
from __future__ import annotations

import torch

from repro_torch.core.graph_ir import Graph, Operator
from repro_torch.core.op_registry import fusion_rules, register_fusion_rule


def _fuse_linear_relu(g: Graph) -> Graph:
    out = Graph()
    renamed: dict[str, str] = {}
    consumed: set[str] = set()
    for op in list(g.ops.values()):
        if op.name in consumed:
            continue
        succ = g.successors(op.name)
        if (op.op_type == "linear" and len(succ) == 1
                and succ[0].op_type == "relu"):
            relu = succ[0]
            fused = op.clone()
            fused.op_type = "dense"
            fused.attrs["activation"] = "relu"
            fused.name = op.name + "+relu"
            fused.inputs = [renamed.get(i, i) for i in op.inputs]
            out.add(fused)
            renamed[op.name] = fused.name
            renamed[relu.name] = fused.name
            consumed.add(relu.name)
        else:
            c = op.clone()
            c.inputs = [renamed.get(i, i) for i in c.inputs]
            if c.op_type == "linear":
                c.op_type = "dense"
                c.attrs.setdefault("activation", "none")
            out.add(c)
            renamed[op.name] = c.name
    out.meta = dict(g.meta)
    out.validate()
    return out


def _match_gravnet_block(g: Graph, agg: Operator):
    """Match the fusable chain around one ``gravnet_aggregate``; returns
    (s_op, f_op, out_op, concat_x, member_names) or None."""
    if agg.op_type != "gravnet_aggregate" or len(agg.inputs) != 3:
        return None
    s_name, f_name, _mask_name = agg.inputs
    if s_name == f_name:
        return None
    s_op, f_op = g[s_name], g[f_name]
    for proj in (s_op, f_op):
        if (proj.op_type != "dense" or len(proj.inputs) != 1
                or proj.attrs.get("activation", "none") != "none"
                or not proj.params or "w" not in proj.params
                or "b" not in proj.params):
            return None
        # a projection with another consumer must stay materialized
        if [c.name for c in g.successors(proj.name)] != [agg.name]:
            return None
    if s_op.inputs != f_op.inputs:
        return None
    x_name = s_op.inputs[0]
    succ = g.successors(agg.name)
    if len(succ) != 1:     # aggregate output tapped elsewhere
        return None
    nxt = succ[0]
    if nxt.op_type == "concat":
        # the CaloClusterNet shape: out dense consumes concat(x, agg)
        if nxt.inputs != [x_name, agg.name]:
            return None
        csucc = g.successors(nxt.name)
        if len(csucc) != 1:
            return None
        out_op, concat_x = csucc[0], True
        members = [s_name, f_name, agg.name, nxt.name, out_op.name]
    elif nxt.op_type == "dense":
        out_op, concat_x = nxt, False
        members = [s_name, f_name, agg.name, out_op.name]
    else:
        return None
    if (out_op.op_type != "dense" or len(out_op.inputs) != 1
            or not out_op.params or "w" not in out_op.params
            or "b" not in out_op.params):
        return None
    # a chain is fusable when its members run ONE precision; a uniform
    # int8 chain only when every dense member is calibrated, since an
    # uncalibrated one runs op by op in fp and fusing it would freeze
    # that into one kernel
    precs = {s_op.precision, f_op.precision, agg.precision,
             out_op.precision}
    if len(precs) != 1:
        return None
    if precs == {"int8"}:
        calibrated = (all("w_q" in (o.params or {})
                          for o in (s_op, f_op, out_op))
                      and "act_scale" in agg.attrs
                      and "in_scale" in s_op.attrs
                      and "in_scale" in out_op.attrs)
        if not calibrated:
            return None
    return s_op, f_op, out_op, concat_x, members


def _fuse_gravnet_block(g: Graph) -> Graph:
    # collect non-overlapping matches keyed by the chain's last op
    matches: dict[str, tuple] = {}
    drop: set[str] = set()
    for op in g.ops.values():
        m = _match_gravnet_block(g, op)
        if m is None:
            continue
        s_op, f_op, out_op, concat_x, members = m
        if any(n in drop for n in members):
            continue
        matches[out_op.name] = (op, s_op, f_op, out_op, concat_x)
        drop.update(members)
    if not matches:
        return g

    out = Graph()
    renamed: dict[str, str] = {}
    for op in g.ops.values():
        if op.name in matches:
            agg, s_op, f_op, out_op, concat_x = matches[op.name]
            x_name, mask_name = s_op.inputs[0], agg.inputs[2]
            fused = Operator(
                name=agg.name + ".block",
                op_type="gravnet_block",
                inputs=[renamed.get(x_name, x_name),
                        renamed.get(mask_name, mask_name)],
                attrs={
                    "k": agg.attrs["k"], "scale": agg.attrs["scale"],
                    "d_s": agg.attrs["d_s"], "d_f": agg.attrs["d_f"],
                    "d_hidden": int(s_op.params["w"].shape[0]),
                    "activation": out_op.attrs.get("activation", "none"),
                    "concat_x": concat_x,
                },
                params={
                    "ws": s_op.params["w"], "bs": s_op.params["b"],
                    "wf": f_op.params["w"], "bf": f_op.params["b"],
                    "wo": out_op.params["w"], "bo": out_op.params["b"],
                },
                out_dim=out_op.out_dim,
                precision=out_op.precision,
            )
            if out_op.precision == "int8" and "w_q" in out_op.params:
                # an already-calibrated chain carries its quantized
                # weights and scales, so the block runs without
                # calibrating again (in deploy, fusion runs before
                # calibration and calibrate derives these instead)
                for src, nm in ((s_op, "ws"), (f_op, "wf"), (out_op, "wo")):
                    fused.params[nm + "_q"] = src.params["w_q"]
                    fused.params[nm + "_scale"] = src.params["w_scale"]
                fused.attrs["in_scale"] = s_op.attrs["in_scale"]
                fused.attrs["agg_scale"] = agg.attrs["act_scale"]
                fused.attrs["h_scale"] = out_op.attrs["in_scale"]
                if "act_scale" in out_op.attrs:
                    fused.attrs["act_scale"] = out_op.attrs["act_scale"]
            out.add(fused)
            renamed[out_op.name] = fused.name
        elif op.name in drop:
            continue
        else:
            c = op.clone()
            c.inputs = [renamed.get(i, i) for i in c.inputs]
            out.add(c)
            renamed[op.name] = c.name
    out.meta = dict(g.meta)
    out.validate()
    return out


def _merge_parallel_dense(g: Graph) -> Graph:
    out = Graph()
    renamed: dict[str, str] = {}
    consumed: set[str] = set()
    for op in g.ops.values():
        if op.name in consumed:
            continue
        # mergeable siblings: dense ops with the same single input,
        # activation and precision
        if op.op_type == "dense" and len(op.inputs) == 1:
            sibs = [s for s in g.ops.values()
                    if s.op_type == "dense" and s.name != op.name
                    and s.name not in consumed
                    and s.inputs == op.inputs
                    and s.attrs.get("activation") == op.attrs.get("activation")
                    and s.precision == op.precision]
            if sibs:
                group = [op] + sibs
                params = {"w": torch.cat([x.params["w"] for x in group],
                                         dim=1)}
                if all("b" in (x.params or {}) for x in group):
                    params["b"] = torch.cat([x.params["b"] for x in group],
                                            dim=0)
                merged = Operator(
                    name="+".join(x.name for x in group),
                    op_type="dense",
                    inputs=[renamed.get(op.inputs[0], op.inputs[0])],
                    attrs=dict(op.attrs),
                    params=params,
                    precision=op.precision,
                    out_dim=sum(x.out_dim for x in group),
                )
                out.add(merged)
                # slice views for each original output
                off = 0
                for x in group:
                    sl = Operator(
                        name=x.name + ".view", op_type="slice",
                        inputs=[merged.name],
                        attrs={"start": off, "size": x.out_dim},
                        out_dim=x.out_dim, precision=x.precision)
                    out.add(sl)
                    renamed[x.name] = sl.name
                    consumed.add(x.name)
                    off += x.out_dim
                continue
        c = op.clone()
        c.inputs = [renamed.get(i, i) for i in c.inputs]
        out.add(c)
        renamed[op.name] = c.name
    out.meta = dict(g.meta)
    out.validate()
    return out


# registration order IS application order: linear+relu first (so the
# block rewrite sees denses carrying their activation), the opt-in
# GravNet-block collapse second (before the merge, so the S/F
# projections are still separate operators), the parallel-dense merge
# last, iterated to a fixed point.
register_fusion_rule("linear_relu", _fuse_linear_relu)
register_fusion_rule("gravnet_block", _fuse_gravnet_block, opt_in=True)
register_fusion_rule("parallel_dense", _merge_parallel_dense,
                     fixpoint=True)


def fuse(g: Graph, *, gravnet_block: bool = False) -> Graph:
    """Replay the registered fusion rules in registration order; the
    opt-in GravNet-block collapse runs when ``gravnet_block`` is set."""
    for rule in fusion_rules():
        if rule.opt_in and not (gravnet_block
                                and rule.name == "gravnet_block"):
            continue
        if rule.fixpoint:
            prev = -1
            while len(g) != prev:
                prev = len(g)
                g = rule.fn(g)
        else:
            g = rule.fn(g)
    return g
