"""Raggedize pass: rewrite a model graph for padding-free events.

Counterpart of ``repro/core/passes/ragged.py``. It retargets the graph
at the bin-packed ragged layout (``data/ragged.py``): whole events
first-fit packed into fixed ``n_hits``-row bins, identified per row by
a segment id (event index, −1 padding) and an in-event slot, so a
micro-batch of bins packs actual hits instead of each event's padding.

Rewrites (the pass runs after fusion, before partitioning, so every
later pass handles the new ops through their registry specs):

- two new input ops, ``segids`` and ``slots`` (int32 per packed row);
- every ``gravnet_aggregate`` splits into the ragged kernel pair:
  ``knn_build`` (neighbour selection over the learned coordinates,
  masked by segment equality) feeding ``knn_aggregate`` (which keeps
  the aggregate's *name*, so consumers rewire for free);
- every fused ``gravnet_block`` swaps its mask input for ``segids``
  and marks ``attrs["ragged"]`` — the executor runs it as
  ``kernels.ops.gravnet_block_ragged``;
- ``cps`` consumes ``(heads..., segids, slots)`` and marks
  ``attrs["ragged"]`` — the executor scatters packed rows back to the
  per-event layout before condensation, whose per-event math is
  unchanged;
- ``batchnorm`` is refused: masked per-event statistics are not
  segment-aware on the packed layout.

Dense and elementwise ops are row-independent and pass through
untouched; with bin packing keeping each event's row order (hence
every kNN tie-break), that is why the ragged executable matches the
padded one on real rows.
"""
from __future__ import annotations

from repro_torch.core.graph_ir import Graph, Operator
from repro_torch.core.op_registry import GraphVerificationError

RAGGED_INPUTS = ("segids", "slots")


def raggedize(g: Graph) -> Graph:
    """The ragged rewrite of ``g`` (a new graph; ``g`` is untouched)."""
    for nm in RAGGED_INPUTS:
        if nm in g.ops:
            raise GraphVerificationError(
                f"raggedize: graph already has an op named {nm!r}")
    for op in g:
        if op.op_type == "batchnorm":
            raise GraphVerificationError(
                f"raggedize: {op.name}: batchnorm statistics are "
                "per-event, not segment-aware — this graph cannot be "
                "raggedized")

    out = Graph()
    for nm in RAGGED_INPUTS:
        out.add(Operator(name=nm, op_type="input", out_dim=1,
                         attrs={"feature": nm}))
    renamed: dict[str, str] = {}
    for op in g:
        if op.op_type == "gravnet_aggregate":
            s_name, f_name, _mask = op.inputs
            knn = Operator(
                name=op.name + ".knn", op_type="knn_build",
                inputs=[renamed.get(s_name, s_name), "segids"],
                attrs={"k": op.attrs["k"], "d_s": op.attrs["d_s"]},
                out_dim=op.attrs["k"], precision=op.precision)
            out.add(knn)
            agg = Operator(
                # keeps the aggregate's name: consumers rewire for free
                name=op.name, op_type="knn_aggregate",
                inputs=[renamed.get(f_name, f_name), knn.name],
                attrs={"k": op.attrs["k"], "scale": op.attrs["scale"],
                       "d_f": op.attrs["d_f"]},
                out_dim=2 * op.attrs["d_f"], precision=op.precision)
            out.add(agg)
            renamed[op.name] = agg.name
        elif op.op_type == "gravnet_block":
            c = op.clone()
            x_name = op.inputs[0]
            c.inputs = [renamed.get(x_name, x_name), "segids"]
            c.attrs["ragged"] = True
            out.add(c)
            renamed[op.name] = c.name
        elif op.op_type == "cps":
            c = op.clone()
            heads = op.inputs[:-1]          # (heads..., mask)
            c.inputs = ([renamed.get(h, h) for h in heads]
                        + ["segids", "slots"])
            c.attrs["ragged"] = True
            out.add(c)
            renamed[op.name] = c.name
        else:
            c = op.clone()
            c.inputs = [renamed.get(i, i) for i in c.inputs]
            out.add(c)
            renamed[op.name] = c.name
    out.meta = dict(g.meta)
    out.meta["ragged"] = True
    out.validate()
    return out
