"""Operator registry — the declarations the deploy passes dispatch on.

Counterpart of ``repro/core/op_registry.py``, holding the op types the
port's graphs use: ``input``/``output``, ``linear``/``dense``,
``relu``, ``concat``, ``slice``, ``retile``, ``gravnet_aggregate``,
``gravnet_block``, ``cps``, ``attention``, the ragged path's
``knn_build`` and ``knn_aggregate``, and the edge-based GNNs'
``gather_edge``, ``edge_aggregate``, ``eltwise`` and ``batchnorm``. Each
:class:`OpSpec` says whether the op's access pattern is regular
(MXU-eligible), which template it maps to per target, how to infer its
output feature dim, its analytic cost, how the kernel-opt pass binds its
launch knobs and which tuning-cache key its launch has; and, for the
cost model's "h100" platform, the kernel launches a call costs on the
card and the share of the SMs its hand kernel's launch fills. The specs,
cost formulas, binders and keys are the reference's, so the port's
passes emit the reference's graphs and tuning problems: a cached winner
(``repro_torch.tuning``) beats the heuristic, and a miss keeps the
heuristic binding, so an empty cache binds exactly what no cache does.
The port's keys carry the backend ``"cuda"`` or ``"cpu"``, so entries
that the reference tuned for its own backends never bind here.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, Callable


class GraphVerificationError(ValueError):
    """A graph failed shape/legality checks (see passes/verify.py)."""


class UnknownOperatorError(GraphVerificationError):
    """An op type absent from the registry — no pass can handle it."""


@dataclasses.dataclass(frozen=True)
class BindContext:
    """What the kernel-opt pass knows when binding launch knobs."""
    n_rows: int
    batch: int = 1
    cache: Any = None        # repro_torch.tuning.cache.TuningCache | None
    backend: str = "cuda"    # the key's backend: 'cuda' | 'cpu'
    # the keys whose stale entries this binding has warned of
    warned: set = dataclasses.field(default_factory=set)


@dataclasses.dataclass(frozen=True)
class OpSpec:
    """Declarative description of one op type, consumed by the passes.

    ``infer(op, dims, g)``     -> output feature dim (verify pass)
    ``cost(op, n_hits, pb)``   -> (flops, act_bytes, weight_bytes)
    ``mxu_eff(op, rows, n)``   -> the reference's size factor of a matmul
                                  (its "cpu" cost model, kept for parity)
    ``launches(op)``           -> kernel launches the op costs on the card
                                  per call (its "h100" cost model)
    ``sm_fill(op, n, p)``      -> share of the card's SMs that the hand
                                  kernel's launch over p events of n rows
                                  fills; set exactly for the ops that
                                  launch a hand kernel ("h100")
    ``bind(op, ctx)``          -> write launch knobs into op.attrs_opt
    ``tuning_key(op, n, be, b)``-> KernelKey | None (autotuner problems)
    ``int8_passthrough``       -> an int8 producer may hand this op its
                                  output in int8 (kernel-opt step 3)
    """
    op_type: str
    regular: bool = False            # statically scheduled -> MXU-eligible
    tpu_native_regular: bool = False  # regular under tpu_native_gravnet
    templates: dict[str, str] = dataclasses.field(default_factory=dict)
    infer: Callable | None = None
    cost: Callable | None = None
    mxu_matmul: bool = False         # cost model treats it as a matmul
    mxu_eff: Callable | None = None
    launches: Callable | int = 1     # kernel launches per call on the card
    sm_fill: Callable | None = None  # a hand kernel's share of the SMs
    bind: Callable | None = None
    tuning_key: Callable | None = None
    int8_passthrough: bool = False   # int8 chain fusion may emit through it


@dataclasses.dataclass(frozen=True)
class FusionRule:
    """One registered subgraph rewrite, replayed by ``fuse()`` in
    registration order. ``opt_in`` rules run only when the caller
    enables them by name; ``fixpoint`` rules iterate until the graph
    stops shrinking."""
    name: str
    fn: Callable  # Graph -> Graph
    opt_in: bool = False
    fixpoint: bool = False


_REGISTRY: dict[str, OpSpec] = {}
_FUSION_RULES: list[FusionRule] = []


def register_op(spec: OpSpec) -> OpSpec:
    if spec.op_type in _REGISTRY:
        raise ValueError(f"op type {spec.op_type!r} already registered")
    _REGISTRY[spec.op_type] = spec
    return spec


def require_spec(op) -> OpSpec:
    """Spec for ``op`` (an Operator), or the canonical unknown-op error."""
    spec = _REGISTRY.get(op.op_type)
    if spec is None:
        raise UnknownOperatorError(
            f"{op.name}: unknown op {op.op_type!r}")
    return spec


def is_regular(op, *, tpu_native_gravnet: bool = False) -> bool:
    spec = require_spec(op)
    return spec.regular or (tpu_native_gravnet and spec.tpu_native_regular)


def unknown_ops(g) -> list[tuple[str, str]]:
    """(node name, op type) for every op the registry does not know."""
    return [(op.name, op.op_type) for op in g
            if op.op_type not in _REGISTRY]


def register_fusion_rule(name: str, fn: Callable, *, opt_in: bool = False,
                         fixpoint: bool = False) -> FusionRule:
    if any(r.name == name for r in _FUSION_RULES):
        raise ValueError(f"fusion rule {name!r} already registered")
    rule = FusionRule(name, fn, opt_in=opt_in, fixpoint=fixpoint)
    _FUSION_RULES.append(rule)
    return rule


def fusion_rules() -> tuple[FusionRule, ...]:
    return tuple(_FUSION_RULES)


# ------------------------------------------------------------------------
# template layouts: MXU templates exchange ``lane128`` tensors (feature
# dim zero-padded to 128 lanes), everything else ``compact`` tensors.
LANE = 128
TEMPLATE_LAYOUT = {"fused_dense": "lane128", "gravnet_kernel": "lane128",
                   "gravnet_block_kernel": "lane128",
                   "xla_gravnet_block": "lane128"}


def template_layout(template: str | None) -> str:
    return TEMPLATE_LAYOUT.get(template, "compact")


# ========================================================================
# shape inference (verify pass arms)
# ========================================================================
def _infer_input(op, dims, g):
    if op.out_dim is None:
        raise GraphVerificationError(f"{op.name}: input needs out_dim")
    return op.out_dim


def _infer_dense(op, dims, g):
    if not op.params or "w" not in op.params:
        raise GraphVerificationError(f"{op.name}: missing weight")
    d_in, d_out = op.params["w"].shape
    got = dims[op.inputs[0]]
    if got != d_in:
        raise GraphVerificationError(
            f"{op.name}: weight expects d_in={d_in}, producer "
            f"{op.inputs[0]!r} provides {got}")
    if "b" in op.params and tuple(op.params["b"].shape) != (d_out,):
        raise GraphVerificationError(f"{op.name}: bias shape "
                                     f"{tuple(op.params['b'].shape)}")
    return d_out


def _infer_same(op, dims, g):
    return dims[op.inputs[0]]


def _infer_retile(op, dims, g):
    return op.out_dim or dims[op.inputs[0]]


def _infer_concat(op, dims, g):
    return sum(dims[i] for i in op.inputs)


def _infer_slice(op, dims, g):
    st, sz = op.attrs["start"], op.attrs["size"]
    if st + sz > dims[op.inputs[0]]:
        raise GraphVerificationError(
            f"{op.name}: slice [{st}:{st + sz}] exceeds producer "
            f"dim {dims[op.inputs[0]]}")
    return sz


def _infer_gravnet_aggregate(op, dims, g):
    ins = op.inputs
    if len(ins) != 3:
        raise GraphVerificationError(
            f"{op.name}: needs (s, f, mask) inputs")
    ds, df = op.attrs.get("d_s"), op.attrs.get("d_f")
    if dims[ins[0]] != ds or dims[ins[1]] != df:
        raise GraphVerificationError(
            f"{op.name}: S/FLR dims ({dims[ins[0]]},{dims[ins[1]]})"
            f" != attrs ({ds},{df})")
    return 2 * df


def _infer_gravnet_block(op, dims, g):
    ins = op.inputs
    if len(ins) != 2:
        raise GraphVerificationError(
            f"{op.name}: needs (x, mask) inputs")
    need = ("ws", "bs", "wf", "bf", "wo", "bo")
    if not op.params or any(p not in op.params for p in need):
        raise GraphVerificationError(
            f"{op.name}: gravnet_block needs params {need}")
    dh = op.attrs.get("d_hidden")
    ds, df = op.attrs.get("d_s"), op.attrs.get("d_f")
    if dims[ins[0]] != dh:
        raise GraphVerificationError(
            f"{op.name}: x provides {dims[ins[0]]}, expects "
            f"d_hidden={dh}")
    if tuple(op.params["ws"].shape) != (dh, ds):
        raise GraphVerificationError(
            f"{op.name}: ws shape {tuple(op.params['ws'].shape)} != "
            f"({dh},{ds})")
    if tuple(op.params["wf"].shape) != (dh, df):
        raise GraphVerificationError(
            f"{op.name}: wf shape {tuple(op.params['wf'].shape)} != "
            f"({dh},{df})")
    dcat = (dh + 2 * df if op.attrs.get("concat_x", True)
            else 2 * df)
    if op.params["wo"].shape[0] != dcat:
        raise GraphVerificationError(
            f"{op.name}: wo expects {op.params['wo'].shape[0]} "
            f"inputs, block provides {dcat}")
    return int(op.params["wo"].shape[1])


def _infer_attention(op, dims, g):
    ins = op.inputs
    if len(ins) != 3:
        raise GraphVerificationError(
            f"{op.name}: needs (q, k, v) inputs")
    if len({dims[i] for i in ins}) != 1:
        raise GraphVerificationError(
            f"{op.name}: q/k/v dims differ: "
            f"{[dims[i] for i in ins]}")
    return dims[ins[0]]


def _infer_cps(op, dims, g):
    heads = op.attrs.get("head_names", [])
    # ragged form (passes/ragged.py) consumes (heads..., segids, slots)
    aux = 2 if op.attrs.get("ragged") else 1
    if len(op.inputs) != len(heads) + aux:
        raise GraphVerificationError(
            f"{op.name}: expects {len(heads)} heads + "
            f"{'segids/slots' if aux == 2 else 'mask'}, got "
            f"{len(op.inputs)} inputs")
    return op.out_dim or 1


def _infer_output(op, dims, g):
    return sum(dims[i] for i in op.inputs
               if g[i].op_type != "cps")


def _infer_knn_build(op, dims, g):
    if len(op.inputs) != 2:
        raise GraphVerificationError(
            f"{op.name}: needs (s, segids) inputs")
    ds = op.attrs.get("d_s")
    if dims[op.inputs[0]] != ds:
        raise GraphVerificationError(
            f"{op.name}: S dim {dims[op.inputs[0]]} != attrs d_s={ds}")
    return op.attrs["k"]


def _infer_knn_aggregate(op, dims, g):
    if len(op.inputs) != 2:
        raise GraphVerificationError(
            f"{op.name}: needs (f, knn) inputs")
    df = op.attrs.get("d_f")
    if dims[op.inputs[0]] != df:
        raise GraphVerificationError(
            f"{op.name}: FLR dim {dims[op.inputs[0]]} != attrs "
            f"d_f={df}")
    if g[op.inputs[1]].op_type != "knn_build":
        raise GraphVerificationError(
            f"{op.name}: neighbor input {op.inputs[1]!r} must be a "
            "knn_build op")
    return 2 * df


def _infer_gather_edge(op, dims, g):
    if len(op.inputs) != 2:
        raise GraphVerificationError(
            f"{op.name}: needs (nodes, edge_index) inputs")
    if op.attrs.get("endpoint") not in ("src", "dst"):
        raise GraphVerificationError(
            f"{op.name}: endpoint must be 'src' or 'dst', got "
            f"{op.attrs.get('endpoint')!r}")
    return dims[op.inputs[0]]


def _infer_edge_aggregate(op, dims, g):
    if len(op.inputs) not in (2, 3):
        raise GraphVerificationError(
            f"{op.name}: needs (messages, edge_index[, edge_mask]) "
            "inputs")
    if op.attrs.get("reduce", "sum") not in ("sum", "mean"):
        raise GraphVerificationError(
            f"{op.name}: reduce must be 'sum' or 'mean', got "
            f"{op.attrs.get('reduce')!r}")
    return dims[op.inputs[0]]


_ELTWISE_FNS = ("add", "mul", "div", "sigmoid", "relu", "mask",
                "add_const", "l2norm")


def _infer_eltwise(op, dims, g):
    fn = op.attrs.get("fn")
    if fn not in _ELTWISE_FNS:
        raise GraphVerificationError(
            f"{op.name}: eltwise fn must be one of {_ELTWISE_FNS}, "
            f"got {fn!r}")
    if fn in ("add", "mul", "div"):
        if len({dims[i] for i in op.inputs}) != 1:
            raise GraphVerificationError(
                f"{op.name}: eltwise {fn} operand dims differ: "
                f"{[dims[i] for i in op.inputs]}")
    if fn == "mask" and len(op.inputs) != 2:
        raise GraphVerificationError(
            f"{op.name}: eltwise mask needs (x, mask) inputs")
    return dims[op.inputs[0]]


def _infer_batchnorm(op, dims, g):
    if len(op.inputs) != 2:
        raise GraphVerificationError(
            f"{op.name}: needs (x, mask) inputs")
    return dims[op.inputs[0]]


# ========================================================================
# analytic cost model (parallelize pass arms): (flops, act, wb) / event
# ========================================================================
def _cost_dense(op, n_hits, pb):
    d_out = op.out_dim or 1
    d_in = op.params["w"].shape[0] if op.params else d_out
    flops = 2.0 * n_hits * d_in * d_out
    act = n_hits * (d_in + d_out) * pb
    wb = d_in * d_out * pb
    return flops, act, wb


def _cost_gravnet_aggregate(op, n_hits, pb):
    d_out = op.out_dim or 1
    ds = op.attrs.get("d_s", 4)
    df = op.attrs.get("d_f", d_out // 2)
    k = op.attrs.get("k", 8)
    flops = 2.0 * n_hits * n_hits * (ds + k * df) + 10.0 * n_hits * k
    act = n_hits * (ds + df + d_out) * pb
    return flops, act, 0.0


def _cost_gravnet_block(op, n_hits, pb):
    d_out = op.out_dim or 1
    dh = op.attrs.get("d_hidden", 64)
    ds = op.attrs.get("d_s", 4)
    df = op.attrs.get("d_f", d_out // 2)
    k = op.attrs.get("k", 8)
    dcat = dh + 2 * df if op.attrs.get("concat_x", True) else 2 * df
    flops = (2.0 * n_hits * dh * (ds + df)              # prologue
             + 2.0 * n_hits * n_hits * (ds + k * df)    # aggregate
             + 10.0 * n_hits * k
             + 2.0 * n_hits * dcat * d_out)             # epilogue
    act = n_hits * (dh + d_out) * pb
    wb = (dh * (ds + df) + dcat * d_out) * pb
    return flops, act, wb


def _cost_attention(op, n_hits, pb):
    d = op.out_dim or 1
    flops = 4.0 * n_hits * n_hits * d + 10.0 * n_hits * n_hits
    act = n_hits * 4.0 * d * pb
    return flops, act, 0.0


def _cost_cps(op, n_hits, pb):
    kmax = op.attrs.get("k_max", 8)
    flops = 20.0 * n_hits * kmax + 10.0 * n_hits * math.log2(max(n_hits, 2))
    act = n_hits * 8.0 * pb
    return flops, act, 0.0


def _cost_knn_build(op, n_hits, pb):
    # gravnet_aggregate's selection half: the (n, n) distances plus k
    # argmin/knockout sweeps
    ds = op.attrs.get("d_s", 4)
    k = op.attrs.get("k", 8)
    flops = 2.0 * n_hits * n_hits * ds + 10.0 * n_hits * k
    act = n_hits * (ds + 2.0 * k) * pb
    return flops, act, 0.0


def _cost_knn_aggregate(op, n_hits, pb):
    # gravnet_aggregate's aggregation half, costed as the reference's
    # k one-hot (n, n) @ (n, df) selection products plus the weighting
    d_out = op.out_dim or 1
    df = op.attrs.get("d_f", d_out // 2)
    k = op.attrs.get("k", 8)
    flops = 2.0 * n_hits * n_hits * k * df + 10.0 * n_hits * k
    act = n_hits * (df + d_out + 2.0 * k) * pb
    return flops, act, 0.0


def _cost_eltwise_like(op, n_hits, pb):
    d_out = op.out_dim or 1
    flops = 1.0 * n_hits * d_out
    act = 2.0 * n_hits * d_out * pb
    return flops, act, 0.0


def _n_edges(op, n_hits):
    # exporters record the padded edge count; fall back to a sparse
    # power-law-ish estimate when absent
    return int(op.attrs.get("n_edges") or 4 * n_hits)


def _cost_gather_edge(op, n_hits, pb):
    d_out = op.out_dim or 1
    e = _n_edges(op, n_hits)
    flops = 1.0 * e * d_out
    act = (n_hits * d_out + e * (d_out + 2.0)) * pb
    return flops, act, 0.0


def _cost_edge_aggregate(op, n_hits, pb):
    d_out = op.out_dim or 1
    e = _n_edges(op, n_hits)
    flops = 2.0 * e * d_out + 1.0 * n_hits * d_out
    act = (e * d_out + n_hits * d_out) * pb
    return flops, act, 0.0


def _cost_batchnorm(op, n_hits, pb):
    d_out = op.out_dim or 1
    flops = 10.0 * n_hits * d_out
    act = 2.0 * n_hits * d_out * pb
    return flops, act, 0.0


def default_cost(op, n_hits, pb):
    return 0.0, n_hits * (op.out_dim or 1) * pb, 0.0


# The reference's MXU-efficiency factors (the share of its 128x128
# systolic array a matmul of this size uses; consulted only for
# mxu-targeted matmul ops). The port's "cpu" cost model keeps them so that
# it picks the reference's P; the "h100" model reads ``sm_fill`` instead.
def _eff_dense(op, n_rows, n_hits):
    d_in = op.params["w"].shape[0] if op.params else 128
    d_out = op.out_dim or 128
    return (min(d_in, 128) / 128.0) * (min(d_out, 128) / 128.0) * \
        min(1.0, n_rows / 8.0)


def _eff_gravnet(op, n_rows, n_hits):
    df = op.attrs.get("d_f", 32)
    return (min(n_hits, 128) / 128.0) * (min(df, 128) / 128.0)


def _eff_attention(op, n_rows, n_hits):
    d = op.out_dim or 128
    return (min(n_hits, 128) / 128.0) * (min(d, 128) / 128.0)


# ========================================================================
# the "h100" cost model's hooks: kernel launches per call, SM fill
# ========================================================================
# Launches per call as the profiler counts them on the card (NVIDIA H100
# 80GB HBM3, 700.00 W; ``python -m repro_torch.launch.h100_model``): one
# per hand-kernel call, none for a view (``slice``, a ``retile`` to the
# compact layout) or a feed, and the plain PyTorch ops' own kernels. Not
# counted: a third copy before some of GatedGCN's edge kernels.
#: CPS's kernels per call (``core/caloclusternet.py:cps``: the sort and
#: gathers, then k_max rounds of about 14 small ops over all events; the
#: ragged path's scatter back to events adds 14 more)
CPS_LAUNCHES = 152
#: a masked batch normalization's kernels (``_Executor._batchnorm``)
BATCHNORM_LAUNCHES = 15
#: a raggedized block's chain (``ops.gravnet_block_ragged``): x's copy,
#: the S and F denses, knn_build, knn_aggregate, the concat, the output
#: dense, the padding mask and its product
RAGGED_BLOCK_LAUNCHES = 9
#: the edge kernel's call: the copy of its messages out of a lane-padded
#: producer, and the kernel
EDGE_AGGREGATE_LAUNCHES = 2


def _launches_retile(op):
    # to lane128: the padded buffer's fill and the copy into it; to the
    # compact layout: a view
    return 2 if op.attrs.get("to") == "lane128" else 0


def _launches_cps(op):
    return CPS_LAUNCHES + (14 if op.attrs.get("ragged") else 0)


def _launches_eltwise(op):
    fn = op.attrs.get("fn")
    if fn in ("add", "mul"):
        return max(1, len(op.inputs) - 1)
    return 3 if fn == "l2norm" else 1   # l2norm: norm, clamp, division


def _launches_gravnet_block(op):
    return RAGGED_BLOCK_LAUNCHES if op.attrs.get("ragged") else 1


#: an int8 dense's quantization of an f32 input (``quantize_act``: the
#: scale's fill, the division, the rounding, the clamp and the cast)
QUANTIZE_LAUNCHES = 5


def _quantizes_input(g, op) -> bool:
    """Whether the int8 dense ``op`` of graph ``g`` quantizes its input
    on each call: its producer, past 8-bit passthrough ops, is no dense
    that int8 chain fusion lets emit int8 (``kernel_opt.emits_int8``)."""
    from repro_torch.core.passes.kernel_opt import emits_int8
    if op.precision != "int8" or op.op_type not in ("dense", "linear"):
        return False
    src = g[op.inputs[0]]
    while (src.op_type not in ("dense", "linear") and src.inputs
           and src.precision == "int8" and require_spec(src).int8_passthrough):
        src = g[src.inputs[0]]
    return not emits_int8(g, src)


def op_launches(op, g=None) -> int:
    """Kernel launches one call of ``op`` costs on the card; given its
    graph ``g``, an int8 dense that quantizes an f32 input counts that
    quantization's kernels too."""
    n = require_spec(op).launches
    n = n(op) if callable(n) else n
    if g is not None and _quantizes_input(g, op):
        n += QUANTIZE_LAUNCHES
    return n


def _fill(ctas: int) -> float:
    from repro_torch.launch.mesh import H100_SMS
    return min(1.0, ctas / H100_SMS)


def _fill_dense(op, n_hits, p):
    # the kernel the executor launches for the p events row-packed
    from repro_torch.core.passes.kernel_opt import fused_dense_dtype
    from repro_torch.kernels import fused_dense as fd
    m = n_hits * p
    d_out = op.out_dim or 1
    if fused_dense_dtype(op) == "int8":
        bm, bn = fd.INT8_TILES[0]
        return _fill(-(-m // bm) * -(-d_out // bn))
    return _fill(fd.ctas(fd.plan(m, d_out), m, d_out))


def _fill_gravnet_aggregate(op, n_hits, p):
    from repro_torch.kernels import gravnet
    bm, _ = gravnet.plan(n_hits, p, op.attrs.get("d_f", 1))
    return _fill(-(-n_hits // bm) * p)


def _fill_gravnet_block(op, n_hits, p):
    from repro_torch.kernels import gravnet_block as gb
    from repro_torch.kernels import knn_build
    a = op.attrs
    if a.get("ragged"):     # its chain's widest launch: the kNN pair
        bm, _ = knn_build.build_plan(n_hits, p)
    elif op.precision == "int8":
        bm = min(n_hits, gb.BM_INT8)
    else:
        bm, _ = gb.plan(n_hits, a.get("d_hidden", 64), a.get("d_s", 4),
                        a.get("d_f", 32), op.out_dim or a.get("d_hidden", 64),
                        a.get("concat_x", True))
    return _fill(-(-n_hits // bm) * p)


def _fill_knn_build(op, n_hits, p):
    from repro_torch.kernels import knn_build
    bm, _ = knn_build.build_plan(n_hits, p)
    return _fill(-(-n_hits // bm) * p)


def _fill_knn_aggregate(op, n_hits, p):
    from repro_torch.kernels import knn_build
    bm, _ = knn_build.aggregate_plan(n_hits, p, op.attrs.get("d_f", 1))
    return _fill(-(-n_hits // bm) * p)


def _fill_edge_aggregate(op, n_hits, p):
    from repro_torch.kernels import edge_aggregate as ea
    d = op.out_dim or 1
    bm, cw = ea.plan(n_hits, d, p)
    return _fill(-(-d // cw) * -(-n_hits // bm) * p)


def _fill_attention(op, n_hits, p):
    from repro_torch.kernels import flash_attention as fa
    return _fill(-(-n_hits // fa.plan_block(128)) * p)


# ========================================================================
# kernel-opt binders + tuning-cache problem keys
# ========================================================================
def tuning_candidates(op, *, n_rows: int, batch: int = 1) -> list[dict]:
    """The Hopper candidates of the launch knobs of the kernel this op
    launches, at its shape (``tuning/candidates.py``), the kernel's own
    plan first; [] for an op with no launch knob. A dense keyed int8
    takes the int8 kernel's tiles, any other the f32 kernel's; a
    raggedized GravNet block, which launches the kNN pair with its bm,
    the rows both kNN kernels take."""
    from repro_torch.core.passes.kernel_opt import (fused_dense_dtype,
                                                    fused_dense_shape)
    from repro_torch.tuning import candidates as cand
    a, n = op.attrs, n_rows
    if op.template == "fused_dense":
        fam = (cand.fused_dense_int8_candidates
               if fused_dense_dtype(op) == "int8"
               else cand.fused_dense_candidates)
        return fam(*fused_dense_shape(op, n_rows, batch))
    t = op.op_type
    if t == "gravnet_block" and a.get("ragged"):
        return cand.gravnet_block_ragged_candidates(n, batch=batch,
                                                    d_f=a["d_f"])
    if t == "gravnet_block":
        fam = (cand.gravnet_block_int8_candidates if op.precision == "int8"
               else cand.gravnet_block_candidates)
        return fam(n, a["d_hidden"], a["d_f"], op.out_dim or a["d_hidden"],
                   d_s=a["d_s"], concat_x=a.get("concat_x", True),
                   batch=batch)
    if t == "gravnet_aggregate":
        return cand.gravnet_candidates(n, batch=batch, d_f=a["d_f"])
    if t == "knn_build":
        return cand.knn_build_candidates(n, batch=batch)
    if t == "knn_aggregate":
        return cand.knn_aggregate_candidates(n, batch=batch, d_f=a["d_f"])
    if t == "edge_aggregate":
        return cand.edge_aggregate_candidates(n, _n_edges(op, n),
                                              d=op.out_dim or 1, batch=batch)
    if t == "attention":
        return cand.flash_attention_candidates(n, n, op.out_dim or 128)
    return []


def _cached(op, ctx: BindContext, key):
    """The cached config for ``key``, or None: on a miss (or no cache),
    and for a stale entry, which on a ``"cuda"`` key is one that is not
    among :func:`tuning_candidates` (such as the reference's ``{"bm":
    128}`` defaults that caches before the launch knobs hold). A stale
    entry binds nothing, so the kernel's own plan launches; it is warned
    of once per key. ``"cpu"`` keys bind as the reference's do."""
    from repro_torch.tuning.candidates import among
    tuned = ctx.cache.lookup(key) if ctx.cache is not None else None
    if tuned is None or ctx.backend != "cuda" or among(
            tuned, tuning_candidates(op, n_rows=ctx.n_rows,
                                     batch=ctx.batch)):
        return tuned
    if key not in ctx.warned:
        ctx.warned.add(key)
        warnings.warn(f"tuning cache entry {key.encode()} {tuned} is not "
                      f"among the {key.kernel} plans at this shape; it "
                      "binds nothing (the kernel's own plan launches)",
                      RuntimeWarning, stacklevel=3)
    return None


def _bind_fused_dense(op, ctx: BindContext):
    """Variant selection / block shape for the fused_dense template
    (cached winner > heuristic) — see passes/kernel_opt.py. A cached
    winner's (bm, bn), one of the kernel's tiles, is what the executor
    hands the card's kernel (only where ``tuned`` is set, as the
    reference's executor does); the heuristic's variant and blocks are
    annotations that keep the reference's graph and change no launch."""
    from repro_torch.core.passes.kernel_opt import (FLATTEN_DIM,
                                                    FLATTEN_ROWS,
                                                    _FUSED_DENSE_KNOBS,
                                                    _pick_block,
                                                    fused_dense_shape)
    if op.template != "fused_dense":
        return
    rows, d_in, d_out = fused_dense_shape(op, ctx.n_rows, ctx.batch)
    tuned = _cached(op, ctx, _key_fused_dense(op, ctx.n_rows, ctx.backend,
                                              ctx.batch))
    if tuned is not None:
        for knob in _FUSED_DENSE_KNOBS:
            if knob in tuned:
                op.attrs_opt[knob] = tuned[knob]
        op.attrs_opt["tuned"] = True     # provenance, as the reference's
    elif rows <= FLATTEN_ROWS and max(d_in, d_out) <= FLATTEN_DIM:
        op.attrs_opt["variant"] = "flattened"
    else:
        op.attrs_opt["variant"] = "looped"
        op.attrs_opt["bm"] = _pick_block(rows, 512)
        op.attrs_opt["bn"] = _pick_block(d_out, 512)
        op.attrs_opt["bk"] = _pick_block(d_in, 2048)


def _bind_cached(op, ctx, key, knobs):
    """Copy ``knobs`` of the cached winner for ``key`` into attrs_opt; a
    miss (or no cache), or a stale entry (:func:`_cached`), leaves
    attrs_opt untouched."""
    tuned = _cached(op, ctx, key)
    if tuned is not None:
        for knob in knobs:
            if knob in tuned:
                op.attrs_opt[knob] = tuned[knob]


def _bind_gravnet_aggregate(op, ctx: BindContext):
    # cache-only: the kernel's own plan is the default
    _bind_cached(op, ctx, _key_gravnet_aggregate(op, ctx.n_rows, ctx.backend,
                                                 ctx.batch), ("bm",))


def _bind_gravnet_block(op, ctx: BindContext):
    # cache-only (bm, bn, bk); an int8 block keys with its own
    # gravnet_block_int8 family, so f32 and int8 winners never cross;
    # bn and bk (the reference's epilogue blocking) stay annotations
    _bind_cached(op, ctx, _key_gravnet_block(op, ctx.n_rows, ctx.backend,
                                             ctx.batch), ("bm", "bn", "bk"))


def _bind_attention(op, ctx: BindContext):
    # cache-only (bq, bk); a miss keeps ops.flash_attention's (128, 128)
    _bind_cached(op, ctx, _key_attention(op, ctx.n_rows, ctx.backend,
                                         ctx.batch), ("bq", "bk"))


def _bind_edge_aggregate(op, ctx: BindContext):
    # cache-only (bm, bn); be (the reference's edge chunk) an annotation
    _bind_cached(op, ctx, _key_edge_aggregate(op, ctx.n_rows, ctx.backend,
                                              ctx.batch), ("bm", "bn", "be"))


def _bind_knn_build(op, ctx: BindContext):
    _bind_cached(op, ctx, _key_knn_build(op, ctx.n_rows, ctx.backend,
                                         ctx.batch), ("bm",))


def _bind_knn_aggregate(op, ctx: BindContext):
    _bind_cached(op, ctx, _key_knn_aggregate(op, ctx.n_rows, ctx.backend,
                                             ctx.batch), ("bm",))


def _key_fused_dense(op, n_rows, backend, batch):
    from repro_torch.core.passes.kernel_opt import (fused_dense_dtype,
                                                    fused_dense_shape)
    from repro_torch.tuning.cache import fused_dense_key
    rows, d_in, d_out = fused_dense_shape(op, n_rows, batch)
    return fused_dense_key(rows, d_in, d_out, fused_dense_dtype(op),
                           backend)


def _key_gravnet_aggregate(op, n_rows, backend, batch):
    from repro_torch.tuning.cache import gravnet_key
    return gravnet_key(n_rows, op.attrs["d_s"], op.attrs["d_f"],
                       op.attrs["k"], "float32", backend, batch=batch)


def _key_gravnet_block(op, n_rows, backend, batch):
    from repro_torch.tuning.cache import (gravnet_block_int8_key,
                                          gravnet_block_key)
    if op.precision == "int8":
        return gravnet_block_int8_key(n_rows, op.attrs["d_hidden"],
                                      op.attrs["d_f"], op.attrs["k"],
                                      backend, batch=batch)
    return gravnet_block_key(n_rows, op.attrs["d_hidden"],
                             op.attrs["d_f"], op.attrs["k"],
                             "float32", backend, batch=batch)


def _key_attention(op, n_rows, backend, batch):
    # the executor launches one (B, N, d) flash call per micro-batch:
    # bh = the packed batch, s = t = n_rows
    from repro_torch.tuning.cache import flash_attention_key
    return flash_attention_key(batch, n_rows, n_rows, op.out_dim or 128,
                               "float32", backend)


def _key_edge_aggregate(op, n_rows, backend, batch):
    from repro_torch.tuning.cache import edge_aggregate_key
    return edge_aggregate_key(n_rows, _n_edges(op, n_rows),
                              op.out_dim or 1, "float32", backend,
                              batch=batch)


def _key_knn_build(op, n_rows, backend, batch):
    from repro_torch.tuning.cache import knn_build_key
    return knn_build_key(n_rows, op.attrs["d_s"], op.attrs["k"],
                         "float32", backend, batch=batch)


def _key_knn_aggregate(op, n_rows, backend, batch):
    from repro_torch.tuning.cache import knn_aggregate_key
    return knn_aggregate_key(n_rows, op.attrs["d_f"], op.attrs["k"],
                             "float32", backend, batch=batch)


# templates whose binder / tuning key is picked by the *template* the
# mapper chose, not the op type (a dense on the xla target binds nothing
# and has no tuning problem)
TEMPLATE_BINDERS = {"fused_dense": _bind_fused_dense}
TEMPLATE_TUNING_KEYS = {"fused_dense": _key_fused_dense}


def bind_kernels(op, ctx: BindContext) -> None:
    """Kernel-opt dispatch for one op: template binder first, then the
    op-type binder from its spec."""
    binder = TEMPLATE_BINDERS.get(op.template)
    if binder is not None:
        binder(op, ctx)
        return
    spec = require_spec(op)
    if spec.bind is not None:
        spec.bind(op, ctx)


def tuning_problem(op, *, n_rows: int, backend: str, batch: int = 1):
    """The tuning-cache key this op's bound kernel launches with, or
    None for ops with no searchable launch config."""
    keyer = TEMPLATE_TUNING_KEYS.get(op.template)
    if keyer is None:
        keyer = require_spec(op).tuning_key
    if keyer is None:
        return None
    return keyer(op, n_rows, backend, batch)


# ========================================================================
# the registry
# ========================================================================
def _both(template: str) -> dict[str, str]:
    return {"mxu": template, "xla": template}


register_op(OpSpec(
    "input", templates={"xla": "io"}, infer=_infer_input, launches=0))
register_op(OpSpec(
    "output", templates={"xla": "io"}, infer=_infer_output, launches=0))
register_op(OpSpec(
    "linear", regular=True,
    templates={"mxu": "fused_dense", "xla": "xla_dense"},
    infer=_infer_dense, cost=_cost_dense, mxu_matmul=True,
    mxu_eff=_eff_dense, sm_fill=_fill_dense))
register_op(OpSpec(
    "dense", regular=True,
    templates={"mxu": "fused_dense", "xla": "xla_dense"},
    infer=_infer_dense, cost=_cost_dense, mxu_matmul=True,
    mxu_eff=_eff_dense, sm_fill=_fill_dense, int8_passthrough=True))
register_op(OpSpec(
    "relu", regular=True, templates=_both("xla_eltwise"),
    infer=_infer_same, cost=_cost_eltwise_like, int8_passthrough=True))
register_op(OpSpec(
    "concat", regular=True, templates=_both("xla_concat"),
    infer=_infer_concat, cost=_cost_eltwise_like, int8_passthrough=True))
register_op(OpSpec(
    "slice", regular=True, templates=_both("xla_slice"),
    infer=_infer_slice, cost=_cost_eltwise_like, launches=0,
    int8_passthrough=True))
register_op(OpSpec(
    "retile", regular=True, templates=_both("xla_retile"),
    infer=_infer_retile, cost=_cost_eltwise_like,
    launches=_launches_retile))
register_op(OpSpec(
    "attention", regular=True,
    templates={"mxu": "flash_attention", "xla": "xla_attention"},
    infer=_infer_attention, cost=_cost_attention, mxu_matmul=True,
    mxu_eff=_eff_attention, sm_fill=_fill_attention, bind=_bind_attention,
    tuning_key=_key_attention))
register_op(OpSpec(
    "gravnet_aggregate", tpu_native_regular=True,
    templates={"mxu": "gravnet_kernel", "xla": "xla_gravnet"},
    infer=_infer_gravnet_aggregate, cost=_cost_gravnet_aggregate,
    mxu_matmul=True, mxu_eff=_eff_gravnet, sm_fill=_fill_gravnet_aggregate,
    bind=_bind_gravnet_aggregate, tuning_key=_key_gravnet_aggregate))
register_op(OpSpec(
    # the fused dense→aggregate→dense block carries the aggregation's
    # data-dependent selection, so it classifies like gravnet_aggregate
    "gravnet_block", tpu_native_regular=True,
    templates={"mxu": "gravnet_block_kernel", "xla": "xla_gravnet_block"},
    infer=_infer_gravnet_block, cost=_cost_gravnet_block,
    mxu_matmul=True, mxu_eff=_eff_gravnet, launches=_launches_gravnet_block,
    sm_fill=_fill_gravnet_block,
    bind=_bind_gravnet_block, tuning_key=_key_gravnet_block))
register_op(OpSpec(
    "cps", templates=_both("xla_cps"),
    infer=_infer_cps, cost=_cost_cps, launches=_launches_cps))

# --- the ragged, padding-free path (passes/ragged.py) -------------------
# Both kNN ops classify like gravnet_aggregate. Their templates exchange
# compact tensors on both targets: knn_build's value is an (idx, d2)
# tuple, on which no retile may ever land. Their binders are cache-only.
register_op(OpSpec(
    "knn_build", tpu_native_regular=True,
    templates={"mxu": "knn_build_kernel", "xla": "xla_knn_build"},
    infer=_infer_knn_build, cost=_cost_knn_build,
    mxu_matmul=True, mxu_eff=_eff_gravnet, sm_fill=_fill_knn_build,
    bind=_bind_knn_build, tuning_key=_key_knn_build))
register_op(OpSpec(
    "knn_aggregate", tpu_native_regular=True,
    templates={"mxu": "knn_agg_kernel", "xla": "xla_knn_agg"},
    infer=_infer_knn_aggregate, cost=_cost_knn_aggregate,
    mxu_matmul=True, mxu_eff=_eff_gravnet, sm_fill=_fill_knn_aggregate,
    bind=_bind_knn_aggregate, tuning_key=_key_knn_aggregate))

# --- edge-based message passing (GatedGCN / GraphSAGE) ------------------
register_op(OpSpec(
    # data-dependent gather of node rows by an explicit edge list —
    # irregular, like the kNN gather
    "gather_edge", templates=_both("xla_gather"),
    infer=_infer_gather_edge, cost=_cost_gather_edge))
register_op(OpSpec(
    # masked segment sum/mean of per-edge messages into node slots (the
    # edge_aggregate kernel on either target); like gravnet_aggregate it
    # reclassifies as regular under tpu_native_gravnet. Cache-only (bm,
    # be) binder.
    "edge_aggregate", tpu_native_regular=True,
    templates={"mxu": "edge_aggregate_kernel",
               "xla": "xla_edge_aggregate"},
    infer=_infer_edge_aggregate, cost=_cost_edge_aggregate,
    launches=EDGE_AGGREGATE_LAUNCHES, sm_fill=_fill_edge_aggregate,
    bind=_bind_edge_aggregate, tuning_key=_key_edge_aggregate))
register_op(OpSpec(
    "eltwise", regular=True, templates=_both("xla_eltwise"),
    infer=_infer_eltwise, cost=_cost_eltwise_like,
    launches=_launches_eltwise))
register_op(OpSpec(
    "batchnorm", regular=True, templates=_both("xla_batchnorm"),
    infer=_infer_batchnorm, cost=_cost_batchnorm,
    launches=BATCHNORM_LAUNCHES))
