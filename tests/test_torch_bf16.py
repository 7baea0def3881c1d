"""The kernels' bf16 forms, their plain versions against the JAX package
on the CPU: bf16 operands through every entry point of
``kernels/ops.py`` that the Pallas kernels give a bf16 form (the dense,
the GravNet aggregation and block, the int8 block's x, the kNN pair,
the edge aggregation), the executor's bf16-tagged dense, and the
chunked edge sum rounded once.

The JAX side runs ``repro.kernels.ops`` with ``backend="xla"`` and, once
for each kernel, with the Pallas kernel in interpret mode, as its own
tests run it. Its kernels widen bf16 operands to f32, compute in f32 and
cast to ``out_dtype or`` the input's dtype; the port's plain versions
(``kernels/ref.py``), which ``chip_smoke.py`` holds the CUDA kernels to
on the card bitwise, do the same, so each result has the reference's
dtype and lies within the bfloat16 row of ``tests/_numerics.py`` (the
two sum in other orders, which may move a value across a bf16 rounding
step). The GravNet and kNN inputs lie on dyadic grids (bf16 holds them
exactly), so every distance is exact and both packages select the same
neighbours. The int8 block's output stays f32, held to the calibration
bound of the two packages' grids as ``test_torch_epilogues.py`` holds
it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _numerics import (assert_bitwise, assert_calibration_close,
                       assert_close, int8_flip_tolerance)
from test_torch_lm import _two_threads  # noqa: F401 (autouse)

from repro.core.graph_ir import Graph as JGraph
from repro.core.graph_ir import Operator as JOperator
from repro.core.pipeline import _Executor as JExecutor
from repro.kernels import ops as jops
from repro_torch.core.graph_ir import Graph as TGraph
from repro_torch.core.graph_ir import Operator as TOperator
from repro_torch.core.pipeline import Requirements as TRequirements
from repro_torch.core.pipeline import _Executor as TExecutor
from repro_torch.core.pipeline import deploy as tdeploy
from repro_torch.kernels import _build, bf16_cases, f32_cases, int8_cases
from repro_torch.kernels import edge_aggregate as emod
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

BF16 = torch.bfloat16
K = 4
#: events, hits, d_hidden, d_s, d_f, d_out: the reference's smoke widths
WIDTHS = (2, 16, 24, 3, 8, 24)
#: each kernel's entry point that also runs the Pallas kernel interpreted
INTERPRETED = {"fused_dense", "gravnet_aggregate_batched",
               "gravnet_block_batched", "gravnet_block_int8_batched",
               "knn_build_batched", "knn_aggregate_batched",
               "edge_aggregate_batched"}


def _b(a):
    """A float32 numpy array on the bf16 grid as a bf16 tensor (exact)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(BF16)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jb(a):
    return jnp.asarray(a, jnp.bfloat16)


def _np(x):
    """A result of either package as float64 numpy."""
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


def _dtype(x):
    return str(x.dtype).rsplit(".", 1)[-1]


def _within_row(got, want, context=""):
    """The reference's dtype, and within the bfloat16 row."""
    assert _dtype(got) == _dtype(want), context
    assert tuple(got.shape) == tuple(want.shape), context
    assert_close(_np(got), _np(want), dtype="bfloat16", context=context)


def _dense():
    rng = np.random.default_rng(0)
    x = bf16_cases.bf16_values(rng.normal(size=(2, 24, 40)))
    w = bf16_cases.bf16_values(rng.normal(size=(40, 16)) / 6)
    b = bf16_cases.bf16_values(rng.normal(size=(16,)) * 0.1)
    return x, w, b


def _gravnet():
    b, n, dh, ds, df, dout = WIDTHS
    block = f32_cases.block_inputs(b, n, dh=dh, ds=ds, df=df, dout=dout,
                                   seed=3, n_valid=13, dup=2)
    agg = f32_cases.aggregate_inputs(b, n, ds=ds, df=df, seed=3,
                                     n_valid=13, dup=2)
    return ([a if i == 1 else bf16_cases.bf16_values(a)
             for i, a in enumerate(block)],
            [bf16_cases.bf16_values(a) if i < 2 else a
             for i, a in enumerate(agg)])


def _knn():
    s, seg = f32_cases.knn_build_inputs(((5, 6), (11,)), 16, 3, K, "grid",
                                        1, seed=4)
    s = bf16_cases.bf16_values(s)
    idx, d2 = tref.knn_build_ref(_t(s), _t(seg), k=K)
    # every index in range: the jnp reference reads one outside [0, n)
    # as jnp.take does, the kernels as a row of zeros
    f, idx = f32_cases.knn_aggregate_inputs(idx.numpy(), 16, 8, False,
                                            seed=4)
    return s, seg, bf16_cases.bf16_values(f), idx, d2.numpy()


def _edges(e=40, d=6, bsz=2, n=9):
    msg, dst, mask = f32_cases.edge_inputs(bsz, e, d, "random", n=n, seed=5)
    src = np.zeros_like(dst)
    return bf16_cases.bf16_values(msg), np.stack([src, dst], 1), mask, n


# (port call, reference call) on the same bf16 inputs, by entry point
def _case(name, backend):
    x, w, b = _dense()
    block, (s, f, mask) = _gravnet()
    ks, seg, kf, kidx, kd2 = _knn()
    msg, ei, emask, n = _edges()
    ref = dict(backend=backend)
    if name == "fused_dense":
        return (lambda: tops.fused_dense(_b(x[0]), _b(w), _b(b)),
                lambda: jops.fused_dense(_jb(x[0]), _jb(w), _jb(b), **ref))
    if name == "fused_dense_batched":
        return (lambda: tops.fused_dense_batched(_b(x), _b(w), _b(b),
                                                 activation="none"),
                lambda: jops.fused_dense_batched(_jb(x), _jb(w), _jb(b),
                                                 activation="none", **ref))
    if name.startswith("gravnet_aggregate"):
        if name.endswith("batched"):
            return (lambda: tops.gravnet_aggregate_batched(
                        _b(s), _b(f), _t(mask), k=K),
                    lambda: jops.gravnet_aggregate_batched(
                        _jb(s), _jb(f), jnp.asarray(mask), k=K, **ref))
        return (lambda: tops.gravnet_aggregate(_b(s[1]), _b(f[1]),
                                               _t(mask[1]), k=K),
                lambda: jops.gravnet_aggregate(_jb(s[1]), _jb(f[1]),
                                               jnp.asarray(mask[1]), k=K,
                                               **ref))
    if name.startswith("gravnet_block_int8"):
        raise AssertionError("the int8 block has its own test")
    if name.startswith("gravnet_block"):
        tb = [_t(a) if i == 1 else _b(a) for i, a in enumerate(block)]
        jb = [jnp.asarray(a) if i == 1 else _jb(a)
              for i, a in enumerate(block)]
        if name.endswith("batched"):
            return (lambda: tops.gravnet_block_batched(*tb, k=K),
                    lambda: jops.gravnet_block_batched(*jb, k=K, **ref))
        one = [t[1] if i < 2 else t for i, t in enumerate(tb)]
        jone = [t[1] if i < 2 else t for i, t in enumerate(jb)]
        return (lambda: tops.gravnet_block(*one, k=K),
                lambda: jops.gravnet_block(*jone, k=K, **ref))
    if name.startswith("knn_build"):
        if name.endswith("batched"):
            return (lambda: tops.knn_build_batched(_b(ks), _t(seg), k=K),
                    lambda: jops.knn_build_batched(_jb(ks), jnp.asarray(seg),
                                                   k=K, **ref))
        return (lambda: tops.knn_build(_b(ks[0]), _t(seg[0]), k=K),
                lambda: jops.knn_build(_jb(ks[0]), jnp.asarray(seg[0]), k=K,
                                       **ref))
    if name.startswith("knn_aggregate"):
        if name.endswith("batched"):
            return (lambda: tops.knn_aggregate_batched(_b(kf), _t(kidx),
                                                       _t(kd2)),
                    lambda: jops.knn_aggregate_batched(
                        _jb(kf), jnp.asarray(kidx), jnp.asarray(kd2), **ref))
        return (lambda: tops.knn_aggregate(_b(kf[0]), _t(kidx[0]),
                                           _t(kd2[0])),
                lambda: jops.knn_aggregate(_jb(kf[0]), jnp.asarray(kidx[0]),
                                           jnp.asarray(kd2[0]), **ref))
    if name.startswith("edge_aggregate"):
        if name.endswith("batched"):
            return (lambda: tops.edge_aggregate_batched(
                        _b(msg), _t(ei), n, _t(emask), reduce="mean"),
                    lambda: jops.edge_aggregate_batched(
                        _jb(msg), jnp.asarray(ei), n, jnp.asarray(emask),
                        reduce="mean", **ref))
        return (lambda: tops.edge_aggregate(_b(msg[0]), _t(ei[0]), n,
                                            _t(emask[0])),
                lambda: jops.edge_aggregate(_jb(msg[0]), jnp.asarray(ei[0]),
                                            n, jnp.asarray(emask[0]), **ref))
    raise ValueError(name)


ENTRIES = ["fused_dense", "fused_dense_batched", "gravnet_aggregate",
           "gravnet_aggregate_batched", "gravnet_block",
           "gravnet_block_batched", "knn_aggregate", "knn_aggregate_batched",
           "edge_aggregate", "edge_aggregate_batched"]


@pytest.mark.parametrize("name,backend", [
    *((n, "xla") for n in ENTRIES),
    *((n, "pallas_interpret") for n in ENTRIES if n in INTERPRETED)])
def test_bf16_entry_points_match_jax(name, backend):
    """bf16 in, the reference's dtype out (bf16), within the bfloat16
    row; on the CPU no launch is counted."""
    port, ref = _case(name, backend)
    before = dict(tops.launch_counts())
    got = port()
    assert tops.launch_counts() == before
    _within_row(got, ref(), context=f"{name} {backend}")


@pytest.mark.parametrize("batched,backend", [
    (False, "xla"), (True, "xla"), (True, "pallas_interpret")])
def test_knn_build_on_bf16_coordinates(batched, backend):
    """idx int32 and d2 f32 as in the f32 form. On coordinates whose k-th
    and (k+1)-th distances lie far apart (more than bf16 rounding), idx
    is bitwise the reference's; d2 within the float32 row."""
    bins = ((7, 9), (16,))
    for attempt in range(50):
        s, seg = f32_cases.knn_build_inputs(bins, 16, 3, K, "separated", 0,
                                            seed=10 + attempt)
        s = bf16_cases.bf16_values(s)
        if f32_cases.knn_min_gap(s, seg, K) > 1e-2:
            break
    else:
        raise AssertionError("no well-separated bf16 draw")
    if batched:
        idx, d2 = tops.knn_build_batched(_b(s), _t(seg), k=K)
        jidx, jd2 = jops.knn_build_batched(_jb(s), jnp.asarray(seg), k=K,
                                           backend=backend)
    else:
        idx, d2 = tops.knn_build(_b(s[0]), _t(seg[0]), k=K)
        jidx, jd2 = jops.knn_build(_jb(s[0]), jnp.asarray(seg[0]), k=K,
                                   backend=backend)
    assert idx.dtype == torch.int32 and d2.dtype == torch.float32
    assert _dtype(jd2) == "float32"
    assert_bitwise(idx.numpy(), np.asarray(jidx))
    assert_close(d2.numpy(), np.asarray(jd2), dtype="float32")


@pytest.mark.parametrize("backend", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("out_int8", [False, True])
def test_int8_block_reads_a_bf16_x(out_int8, backend):
    """The quantized block on a bf16 x (the Pallas kernel reads it as
    f32): its output stays f32 (or int8), within the calibration bound
    of the two packages' grids."""
    b, n, dh, ds, df, dout = WIDTHS
    ops, sc = int8_cases.block_inputs(b, n, dh=dh, ds=ds, df=df, dout=dout,
                                      seed=6, n_valid=12, dup=2)
    x = bf16_cases.bf16_values(ops[0])
    out_scale = 0.05
    kw = dict(sc, k=K, out_scale=out_scale)
    want = jops.gravnet_block_int8_batched(
        _jb(x), *(jnp.asarray(a) for a in ops[1:]), **kw,
        out_dtype=jnp.int8 if out_int8 else jnp.float32, backend=backend)
    got = tops.gravnet_block_int8_batched(_b(x), *(_t(a) for a in ops[1:]),
                                          **kw, out_int8=out_int8)
    assert got.dtype == (torch.int8 if out_int8 else torch.float32)
    assert _dtype(want) == ("int8" if out_int8 else "float32")
    # the bf16 x read as its exact f32 values: the f32 form on them
    f32 = tref.gravnet_block_int8_ref(_t(x), *(_t(a) for a in ops[1:]),
                                      **kw, out_int8=out_int8)
    assert_bitwise(got.numpy(), f32.numpy())
    scale = out_scale if out_int8 else 1.0
    assert_calibration_close(
        got.numpy() * np.float64(scale),
        np.asarray(want).astype(np.float64) * scale,
        quantum=int8_flip_tolerance(sc["h_scale"], ops[10])
        + (out_scale if out_int8 else 0.0))


@pytest.mark.parametrize("name", ["gravnet_aggregate", "knn_aggregate",
                                  "edge_aggregate"])
def test_plain_versions_return_the_input_dtype(name):
    """The three plain versions that returned f32 on bf16 inputs now
    return bf16 (computed in f32, rounded once), as the reference's
    ``out_dtype or f.dtype``; an f32 ``out_dtype`` keeps the f32
    result, whose rounding is the bf16 one."""
    block, (s, f, mask) = _gravnet()
    ks, seg, kf, kidx, kd2 = _knn()
    msg, ei, emask, n = _edges()
    if name == "gravnet_aggregate":
        args, kw = (_b(s), _b(f), _t(mask)), dict(k=K)
        want = jops.gravnet_aggregate_batched(_jb(s), _jb(f),
                                              jnp.asarray(mask), k=K,
                                              backend="xla")
        fn = tref.gravnet_aggregate_ref
    elif name == "knn_aggregate":
        args, kw = (_b(kf), _t(kidx), _t(kd2)), {}
        want = jops.knn_aggregate_batched(_jb(kf), jnp.asarray(kidx),
                                          jnp.asarray(kd2), backend="xla")
        fn = tref.knn_aggregate_ref
    else:
        dst = _t(ei[:, 1])
        args, kw = (_b(msg), dst, _t(emask)), dict(n_nodes=n)
        want = jops.edge_aggregate_batched(_jb(msg), jnp.asarray(ei), n,
                                           jnp.asarray(emask),
                                           backend="xla")
        fn = tref.edge_aggregate_ref
    got = fn(*args, **kw)
    assert got.dtype == BF16
    _within_row(got, want, context=name)
    wide = fn(*args, **kw, out_dtype=torch.float32)
    assert wide.dtype == torch.float32
    assert_bitwise(got.float().numpy(), wide.to(BF16).float().numpy())
    # and the f32 form on the widened inputs is that f32 result
    f32 = fn(*(a.float() if a.dtype == BF16 else a for a in args), **kw)
    assert_bitwise(f32.numpy(), wide.numpy())


@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_chunked_bf16_edge_sum_rounds_once(reduce):
    """Past the edges one launch takes (14,399 on the H100) the kernel
    carries f32 sums and counts from chunk to chunk and rounds the output
    once: the plain version's bf16 result is its f32 result rounded
    once, and the chunks cover the edges in order, the first without a
    carry, the last alone writing."""
    msg, dst, mask = f32_cases.edge_inputs(1, 30000, 3, "random", n=64,
                                           seed=7)
    msg = bf16_cases.bf16_values(msg)
    got = tref.edge_aggregate_ref(_b(msg), _t(dst), _t(mask), n_nodes=64,
                                  reduce=reduce)
    f32 = tref.edge_aggregate_ref(_t(msg), _t(dst), _t(mask), n_nodes=64,
                                  reduce=reduce)
    assert got.dtype == BF16
    assert_bitwise(got.float().numpy(), f32.to(BF16).float().numpy())
    ei = np.stack([np.zeros_like(dst), dst], 1)
    want = jops.edge_aggregate_batched(_jb(msg), jnp.asarray(ei), 64,
                                       jnp.asarray(mask), reduce=reduce,
                                       backend="xla")
    _within_row(got, want, context=reduce)
    step = emod.max_edges()
    plan = emod.chunk_plan(30000, step)
    assert [c[0] for c in plan] == [0, step, 2 * step]
    assert sum(c[1] for c in plan) == 30000
    assert [(c[2], c[3]) for c in plan] == [(False, False), (True, False),
                                            (True, True)]
    assert emod.chunk_plan(step, step) == [(0, step, False, True)]
    assert emod.chunk_plan(0, step) == [(0, 0, False, True)]


def _executor_dense_op(pkg, w, b):
    """A bf16-tagged dense op of either package, reading an input of
    (lane128-padded) width."""
    op_cls, wrap = (JOperator, jnp.asarray) if pkg == "jax" else (
        TOperator, _t)
    return op_cls(name="d", op_type="dense", inputs=["x"],
                  params={"w": wrap(w), "b": wrap(b)}, out_dim=w.shape[1],
                  attrs={"activation": "relu"}, precision="bf16")


@pytest.mark.parametrize("lane128", [False, True])
@pytest.mark.parametrize("batched", [False, True])
def test_executor_runs_a_bf16_dense(batched, lane128, monkeypatch):
    """A dense tagged bf16 runs the dense on bf16 x, w and b with a bf16
    output in both packages' executors (the port: one fused_dense call,
    the plain version on the CPU), a lane128-padded input included."""
    rng = np.random.default_rng(8)
    kdim = 20
    w = rng.normal(size=(kdim, 12)).astype(np.float32) / 4
    b = (rng.normal(size=(12,)) * 0.1).astype(np.float32)
    width = 128 if lane128 else kdim
    x = rng.normal(size=((3, 16) if batched else (16,)) + (width,))
    x[..., kdim:] = 0.0
    x = x.astype(np.float32)
    jex = JExecutor(JGraph(), None, "xla")
    tex = TExecutor(None)
    want = jex._dense(_executor_dense_op("jax", w, b), jnp.asarray(x),
                      "bf16")
    calls = []
    real = tops.fused_dense

    def spy(x_, w_, b_=None, **kw):
        calls.append((x_.dtype, w_.dtype, None if b_ is None else b_.dtype))
        return real(x_, w_, b_, **kw)

    monkeypatch.setattr(tops, "fused_dense", spy)
    got = tex._dense(_executor_dense_op("torch", w, b), _t(x), "bf16")
    assert got.dtype == BF16
    assert calls == [(BF16, BF16, BF16)]
    _within_row(got, want, context=f"batched={batched} lane128={lane128}")


def test_executor_casts_bf16_weights_once(monkeypatch):
    """The port's executor casts a bf16 dense's w and b to bf16 once:
    later calls pass the same bf16 tensors to the kernel, and a w
    changed in place or replaced is cast again."""
    rng = np.random.default_rng(9)
    w = rng.normal(size=(8, 6)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    op = _executor_dense_op("torch", w, b)
    x = _t(rng.normal(size=(4, 8)).astype(np.float32))
    seen = []
    real = tops.fused_dense

    def spy(x_, w_, b_=None, **kw):
        seen.append((w_, b_))
        return real(x_, w_, b_, **kw)

    monkeypatch.setattr(tops, "fused_dense", spy)
    tex = TExecutor(None)
    first = tex._dense(op, x, "bf16")
    again = tex._dense(op, x, "bf16")
    assert seen[0][0] is seen[1][0] and seen[0][1] is seen[1][1]
    assert torch.equal(first, again)
    op.params["w"].mul_(2.0)                  # in place: cast again
    doubled = tex._dense(op, x, "bf16")
    assert seen[2][0] is not seen[1][0]
    assert torch.equal(seen[2][0], op.params["w"].to(BF16))
    assert not torch.equal(doubled, first)
    op.params["b"] = torch.zeros(6)           # replaced: cast again
    tex._dense(op, x, "bf16")
    assert not seen[3][1].any() and seen[3][1].dtype == BF16


def test_executor_bf16_dense_microbatch_conversions(monkeypatch):
    """A warm micro-batch of a deployed graph whose dense is tagged bf16
    converts twice, x to bf16 at the dense and its output to f32 at the
    output op, as ``chip_smoke.py`` phase 17 (d) requires on the card
    (the kernel stood in by a call that converts nothing)."""
    rng = np.random.default_rng(10)
    kdim = n_out = 12
    g = TGraph()
    g.add(TOperator(name="x", op_type="input", out_dim=kdim,
                    attrs={"feature": "x"}))
    g.add(TOperator(name="d", op_type="dense", inputs=["x"], params={
        "w": _t(rng.normal(size=(kdim, n_out)).astype(np.float32)),
        "b": _t(rng.normal(size=(n_out,)).astype(np.float32))},
        out_dim=n_out, attrs={"activation": "relu"}))
    g.add(TOperator(name="out", op_type="output", inputs=["d"],
                    attrs={"head_names": ["y"]}, out_dim=n_out))
    req = TRequirements(design_point=3, platform="cpu",
                        precision_policy="fp", n_hits=16,
                        target_throughput=1e3)
    pipe = tdeploy(g, req, batch=4, device=torch.device("cpu"))
    for op in pipe.graph:
        if op.op_type == "dense":
            op.precision = "bf16"

    def stand_in(x_, w_, b_=None, **kw):
        assert x_.dtype == w_.dtype == b_.dtype == BF16
        return x_.new_zeros((*x_.shape[:-1], w_.shape[1]))

    monkeypatch.setattr(tops, "fused_dense", stand_in)
    monkeypatch.setattr(tops, "fused_dense_batched", stand_in)
    feeds = {"x": rng.normal(size=(8, 16, kdim)).astype(np.float32)}
    chunks = pipe._chunks(feeds)[2]
    pipe.run_chunk(chunks[0])
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = pipe.run_chunk(chunks[1])
    assert out["y"].dtype == torch.float32
    assert sum(e.name == "aten::_to_copy" for e in prof.events()) == 2


def test_io_dtypes_takes_one_float_dtype():
    """The wrappers' dtype rule: float32 or bfloat16 operands of one
    dtype, the output theirs unless out_dtype says f32 or bf16."""
    f, b = torch.zeros(2), torch.zeros(2, dtype=BF16)
    assert _build.io_dtypes("k", [f, f]) == (0, 0, torch.float32)
    assert _build.io_dtypes("k", [b]) == (1, 1, BF16)
    assert _build.io_dtypes("k", [b], torch.float32) == (1, 0, torch.float32)
    assert _build.io_dtypes("k", [f], BF16) == (0, 1, BF16)
    for bad, out in (([f, b], None), ([f.half()], None), ([f], torch.half)):
        with pytest.raises(TypeError):
            _build.io_dtypes("k", bad, out)
