"""Per-device cost terms, collective bytes and the H100 roofline.

Counterpart of ``repro/launch/analysis.py``. The reference reads XLA's
``cost_analysis`` and parses the post-SPMD HLO text for collectives;
the port has no compiled module to read, so :func:`trace_costs` runs the
step once on fake DTensors (``FakeTensorMode``, over a ``fake`` world)
under :class:`CostMode`, a dispatch mode that sees the *local* ops each
device runs (DTensor's own ops are passed down to their shards):

- ``flops``: ``torch.utils.flop_counter``'s formulas (matrix products,
  convolutions, attention) on the local shapes. Replicated work counts
  whole on every device. Elementwise ops count none (XLA's count has
  them);
- ``bytes``: every non-view local op's input and output bytes;
- collectives: the functional collectives DTensor issues, under the
  reference's kind names, each counted at its per-device output bytes
  (the reference sums the collective ops' output shapes);
- memory: argument and output bytes per device, exact from the shard
  shapes; ``temp_size_in_bytes`` the peak of the bytes of the local
  tensors the step made and held at once.

Sharding propagation itself runs the op once on global fake tensors;
those calls are not counted (``ShardingPropagator._fake_mode_lock`` is
the hook DTensor gives around them).

Scan caveat of the reference: XLA counts a scan body once, so its LM
costs are composed from n_layers ∈ {2, 4} by :func:`affine_extrapolate`.
The port's layers are a Python loop and count exactly; the dry-run
still lowers the reference's L 2 / L 4 variants and reports both.
"""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.launch import mesh as hw

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "s32": 4, "s16": 2, "s8": 1,
    "u64": 8, "u32": 4, "u16": 2, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# functional collective (``torch.ops._c10d_functional``) -> kind
_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) \
        else 0


class _Propagating:
    """Marks DTensor's sharding propagation (its fake run of the global
    op), which :class:`CostMode` must not count."""

    def __init__(self):
        self.depth = 0

    def __enter__(self):
        self.depth += 1

    def __exit__(self, *exc):
        self.depth -= 1


def _host_shard_offsets():
    """Make ``_StridedShard.local_shard_size_and_offset`` (DTensor's
    bookkeeping of a strided shard's rows, which builds an index tensor
    and reads it back) run on real host tensors under the fake mode;
    returns the attribute as it was, for restoring."""
    import inspect

    from torch.distributed.tensor.placement_types import _StridedShard
    from torch.utils._python_dispatch import _disable_current_modes
    saved = inspect.getattr_static(_StridedShard,
                                   "local_shard_size_and_offset")
    fn = saved.__func__ if isinstance(saved, (staticmethod, classmethod)) \
        else saved

    def on_host(*args, **kwargs):
        with _disable_current_modes():
            return fn(*args, **kwargs)
    _StridedShard.local_shard_size_and_offset = (
        type(saved)(on_host) if isinstance(saved, (staticmethod,
                                                   classmethod))
        else on_host)
    return saved


class CostMode(TorchDispatchMode):
    """Counts the local ops under it (see the module docstring). Push it
    inside ``FakeTensorMode``; a DTensor op returns ``NotImplemented``
    here, so that DTensor runs it and its shards' ops come back."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.coll_bytes = {k: 0.0 for k in _COLLECTIVES}
        self.coll_counts = {k: 0 for k in _COLLECTIVES}
        self.live = 0
        self.peak = 0
        self._prop = None
        self._saved = None

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        self._prop = _Propagating()
        self._saved = ShardingPropagator._fake_mode_lock
        ShardingPropagator._fake_mode_lock = self._prop
        self._strided = _host_shard_offsets()
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        from torch.distributed.tensor.placement_types import _StridedShard
        ShardingPropagator._fake_mode_lock = self._saved
        _StridedShard.local_shard_size_and_offset = self._strided
        return super().__exit__(*exc)

    def _free(self, n):
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        kwargs = kwargs or {}
        flat, _ = tree_flatten((args, kwargs))
        if any(isinstance(a, DTensor) for a in flat):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._prop is not None and self._prop.depth:
            return out
        pkt = func._overloadpacket
        ns = func.namespace
        if ns == "_c10d_functional":
            kind = _KIND.get(pkt.__name__)
            if kind is not None:
                outs = [o for o in tree_flatten(out)[0]
                        if isinstance(o, torch.Tensor)]
                self.coll_bytes[kind] += sum(_nbytes(o) for o in outs)
                self.coll_counts[kind] += 1
            return out
        if pkt in flop_registry:
            self.flops += flop_registry[pkt](*args, **kwargs, out_val=out)
        if not func.is_view and ns != "prim":
            outs = [o for o in tree_flatten(out)[0]
                    if isinstance(o, torch.Tensor)]
            ins = [a for a in flat if isinstance(a, torch.Tensor)]
            self.bytes += sum(_nbytes(a) for a in ins) + \
                sum(_nbytes(o) for o in outs)
            fresh = [o for o in outs if all(o is not a for a in ins)]
            for o in fresh:
                n = _nbytes(o)
                self.live += n
                weakref.finalize(o, self._free, n)
            self.peak = max(self.peak, self.live)
        return out

    def record(self) -> dict:
        colls = dict(self.coll_bytes)
        colls["total_bytes"] = sum(self.coll_bytes.values())
        colls["counts"] = dict(self.coll_counts)
        return {"flops": self.flops, "bytes": self.bytes,
                "collective_bytes": colls["total_bytes"],
                "collectives": colls}


def trace_costs(step, abstract_args, shardings) -> dict:
    """Run ``step`` once on fake DTensors of ``abstract_args`` placed by
    ``shardings``, under :class:`CostMode`: the per-device cost record
    (``flops``, ``bytes``, ``collective_bytes``, ``collectives``) and
    ``memory`` (argument, output and temp bytes per device)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.base import place
    with FakeTensorMode(allow_non_fake_inputs=True), \
            implicit_replication():
        args = place(abstract_args, shardings,
                     lambda a, sh: torch.empty(sh.shard_shape(a.shape),
                                               dtype=a.dtype))
        arg_bytes = sum(_nbytes(x.to_local()) for x in
                        tree_flatten(args)[0] if isinstance(x, DTensor))
        mode = CostMode()
        with mode:
            out = step(*args)
        leaves = [x for x in tree_flatten(out)[0]
                  if isinstance(x, torch.Tensor)]
        out_bytes = sum(_nbytes(x.to_local() if isinstance(x, DTensor)
                                else x) for x in leaves)
    rec = mode.record()
    rec["memory"] = {
        "argument_size_in_bytes": int(arg_bytes),
        "output_size_in_bytes": int(out_bytes),
        "temp_size_in_bytes": int(mode.peak),
        "alias_size_in_bytes": 0,
        "generated_code_size_in_bytes": 0,
    }
    return rec


def cost_terms(rec: dict) -> dict:
    """The reference's cost-term record from a :func:`trace_costs`
    record."""
    return {k: rec[k] for k in ("flops", "bytes", "collective_bytes",
                                "collectives")}


def affine_extrapolate(t2: dict, t4: dict, l_full: int) -> dict:
    """F(L) = a + b·L from L=2, L=4 measurements."""
    out = {}
    for k in ("flops", "bytes", "collective_bytes"):
        b = (t4[k] - t2[k]) / 2.0
        a = t2[k] - 2.0 * b
        out[k] = a + b * l_full
    return out


def roofline(terms: dict, *, n_chips: int, model_flops: float) -> dict:
    """Three-term roofline (seconds) over the H100 datasheet model
    (``launch/mesh.py``) + the dominant bottleneck; ``terms`` are per
    device."""
    t_compute = terms["flops"] / hw.H100_PEAK_FLOPS_BF16
    t_memory = terms["bytes"] / hw.H100_HBM_BW
    t_coll = terms["collective_bytes"] / hw.H100_LINK_BW
    dominant = max(
        (("compute", t_compute), ("memory", t_memory),
         ("collective", t_coll)), key=lambda kv: kv[1])[0]
    step_time = max(t_compute, t_memory, t_coll)
    useful = model_flops / max(terms["flops"] * n_chips, 1.0)
    mfu = (model_flops / n_chips / max(step_time, 1e-12)
           ) / hw.H100_PEAK_FLOPS_BF16
    return {
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll, "dominant": dominant,
        "step_time_s": step_time,
        "model_flops": model_flops,
        "useful_flops_ratio": useful,
        "roofline_fraction_mfu": mfu,
    }
