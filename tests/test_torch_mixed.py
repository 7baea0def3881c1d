"""The port's mixed precision path (the reference's serve default)
against the JAX package's, on the CPU: the deployed graphs op for op
(precisions, ``emit_int8``, micro-batch), the int8 weights bitwise and
the calibrated scales to the ``float32`` row, the heads within
calibration tolerance and the CPS decisions bitwise on the same weights
and events — at design points 1 and 3, and at 3 with ``fuse_int8=False``.
Also the port's own check that its fused int8 block agrees with the
unfused calibrated chain, and the int8 guard of its fusion pass.
"""
import jax
import numpy as np
import pytest
import torch
from _numerics import (assert_bitwise, assert_calibration_close,
                       assert_close, int8_flip_tolerance)

from repro.core import caloclusternet as jccn
from repro.core.passes.parallelize import Requirements as JReq
from repro.core.pipeline import deploy as jdeploy
from repro.data import belle2 as jbelle2
from repro_torch.convert import from_jax_params
from repro_torch.core import caloclusternet as tccn
from repro_torch.core.graph_ir import Graph, Operator
from repro_torch.core.passes.fusion import fuse as tfuse
from repro_torch.core.pipeline import QTensor
from repro_torch.core.pipeline import Requirements as TReq
from repro_torch.core.pipeline import deploy as tdeploy
from repro_torch.core.quantization import f32, quantize_act, quantize_weight
from repro_torch.kernels import ref as tref

N_HITS = 32
# (design point, fuse_int8): the served default, its int8 escape hatch,
# and the unfused partitioned baseline
CASES = [(3, True), (3, False), (1, True)]


def _req_kw(dp):
    return dict(design_point=dp, platform="cpu", precision_policy="mixed",
                n_hits=N_HITS, target_throughput=1e5, max_latency_s=2e-3)


@pytest.fixture(scope="module")
def model():
    jcfg = jccn.CCNConfig(n_hits=N_HITS)
    tcfg = tccn.CCNConfig(n_hits=N_HITS)
    params = jccn.init(jax.random.PRNGKey(3), jcfg)
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                              tcfg, device="cpu")
    return jccn.to_graph(params, jcfg), tccn.to_graph(tparams, tcfg)


@pytest.fixture(scope="module")
def feeds():
    gen = jbelle2.current_detector()
    calib = jbelle2.generate(gen, 16, seed=123)
    ev = jbelle2.generate(gen, 8, seed=11)
    return ({"hits": calib["feats"], "mask": calib["mask"]},
            {"hits": ev["feats"], "mask": ev["mask"]})


@pytest.fixture(scope="module", params=CASES,
                ids=[f"dp{dp}-fuse_int8={fi}" for dp, fi in CASES])
def deployed(request, model, feeds):
    dp, fuse_int8 = request.param
    jg, tg = model
    calib, _ = feeds
    jpipe = jdeploy(jg, JReq(**_req_kw(dp)), calibration_feeds=calib,
                    fuse_int8=fuse_int8)
    tpipe = tdeploy(tg, TReq(**_req_kw(dp)), calibration_feeds=calib,
                    fuse_int8=fuse_int8, device="cpu")
    return dp, fuse_int8, jpipe, tpipe


def _op_rows(g):
    return [(op.name, op.op_type, op.target, op.segment, op.precision,
             op.attrs_opt.get("P"), op.attrs_opt.get("variant"),
             op.attrs_opt.get("emit_int8", False)) for op in g]


def _quantum(graph, flips=4):
    """The largest output movement one requantization flip can cause,
    over every int8 dense and block of the graph (see
    ``int8_flip_tolerance``), times ``flips``."""
    q = 0.0
    for op in graph:
        if op.op_type in ("dense", "linear") and "w_q" in op.params:
            q = max(q, int8_flip_tolerance(op.attrs["in_scale"],
                                           np.asarray(op.params["w_scale"]),
                                           flips=flips))
        elif op.op_type == "gravnet_block" and "wo_q" in op.params:
            q = max(q, int8_flip_tolerance(op.attrs["h_scale"],
                                           np.asarray(op.params["wo_scale"]),
                                           flips=flips))
    return q


def test_mixed_graphs_equal_reference(deployed):
    dp, fuse_int8, jpipe, tpipe = deployed
    assert _op_rows(tpipe.graph) == _op_rows(jpipe.graph)
    assert tpipe.microbatch == jpipe.microbatch
    assert ({op.op_type for op in tpipe.graph if op.precision == "bf16"}
            == {"input", "cps", "output"})
    blocks = [op for op in tpipe.graph if op.op_type == "gravnet_block"]
    assert len(blocks) == (2 if (dp, fuse_int8) == (3, True) else 0)
    n_agg = sum(op.op_type == "gravnet_aggregate" for op in tpipe.graph)
    assert n_agg == (0 if blocks else 2)
    for op in jpipe.graph:
        top = tpipe.graph[op.name]
        assert set(top.params or {}) == set(op.params or {}), op.name
        for k, v in (op.params or {}).items():
            # weights, their int8 quantization and per-channel scales
            got = top.params[k].numpy()
            assert got.dtype == np.asarray(v).dtype, (op.name, k)
            assert_bitwise(got, np.asarray(v), context=f"{op.name}/{k}")
        scales = {k for k in op.attrs if k.endswith("_scale")}
        assert scales == {k for k in top.attrs if k.endswith("_scale")}
        for k in scales:
            assert isinstance(top.attrs[k], float)
            assert_close(top.attrs[k], op.attrs[k], dtype="float32",
                         context=f"{op.name}/{k}")
    # the reference's unit input scale: the raw hits quantize at 1.0
    first = [op for op in tpipe.graph if op.op_type in ("dense", "linear")][0]
    assert first.inputs == ["hits"] and first.attrs["in_scale"] == 1.0


def test_mixed_heads_close_and_cps_bitwise(deployed, feeds):
    _, _, jpipe, tpipe = deployed
    _, f = feeds
    jout = jax.tree_util.tree_map(np.asarray, jpipe(f))
    tout = tpipe(f)
    quantum = _quantum(tpipe.graph)
    for h in ("beta", "coords", "energy", "cls"):
        assert tout[h].dtype == torch.float32
        assert_calibration_close(tout[h].numpy(), jout[h], quantum=quantum,
                                 context=h)
    jc = jout["cps"]
    tc = {k: v.numpy() for k, v in tout["cps"].items()}
    for k in ("n_clusters", "trigger", "cluster_valid"):
        assert tc[k].dtype == jc[k].dtype, k
        assert_bitwise(tc[k], jc[k], context=k)


def test_int8_handoff_between_denses(deployed, feeds):
    """At design point 3 an ``emit_int8`` dense hands its consumer a
    QTensor on its own calibrated grid; design point 1 runs no
    kernel-opt pass, so no dense emits int8."""
    dp, _, _, tpipe = deployed
    emitters = [op for op in tpipe.graph if op.attrs_opt.get("emit_int8")]
    assert bool(emitters) == (dp == 3)
    _, f = feeds
    ex = tpipe._ex
    env = {}
    feeds_t = tpipe._on_device({k: v[:tpipe.microbatch]
                                for k, v in f.items()})
    for op in tpipe.graph:
        env[op.name] = ex.run_op(op, [env[i] for i in op.inputs], feeds_t)
    for op in emitters:
        v = env[op.name]
        assert isinstance(v, QTensor) and v.q.dtype == torch.int8
        assert v.scale == op.attrs["act_scale"]


@pytest.mark.parametrize("seed", [11, 29])
def test_fused_int8_block_matches_unfused_chain(model, feeds, seed):
    """The port's own fused-against-unfused int8 check: the quantized
    block (scales baked by ``_calibrate_block``) and the unfused
    calibrated chain (``fuse_int8=False``) agree within calibration
    tolerance."""
    _, tg = model
    calib, _ = feeds
    ev = jbelle2.generate(jbelle2.current_detector(), 8, seed=seed)
    f = {"hits": ev["feats"], "mask": ev["mask"]}
    fused = tdeploy(tg, TReq(**_req_kw(3)), calibration_feeds=calib,
                    device="cpu")
    unfused = tdeploy(tg, TReq(**_req_kw(3)), calibration_feeds=calib,
                      fuse_int8=False, device="cpu")
    blocks = [op for op in fused.graph if op.op_type == "gravnet_block"]
    assert len(blocks) == 2
    # flips=4: a flip inside block 0 can shift block 1's inputs and
    # stack with block 1's own boundary flips
    quantum = max(int8_flip_tolerance(b.attrs["h_scale"],
                                      b.params["wo_scale"].numpy(), flips=4)
                  for b in blocks)
    yf, yu = fused(f), unfused(f)
    for h in ("beta", "coords", "energy", "cls"):
        assert_calibration_close(yf[h].numpy(), yu[h].numpy(),
                                 quantum=quantum, context=h)


def test_fp_deploys_ignore_fuse_int8(model):
    _, tg = model
    req = TReq(**dict(_req_kw(3), precision_policy="fp"))
    a = tdeploy(tg, req, fuse_int8=False, device="cpu")
    assert sum(op.op_type == "gravnet_block" for op in a.graph) == 2
    b = tdeploy(tg, req, fuse_gravnet_block=False, device="cpu")
    assert not any(op.op_type == "gravnet_block" for op in b.graph)


def test_mixed_without_calibration_is_rejected(model):
    _, tg = model
    with pytest.raises(ValueError, match="calibration"):
        tdeploy(tg, TReq(**_req_kw(3)), device="cpu")


# ------------------------------------ int8 fusion guard (direct fuse) ----
def _int8_chain_graph(*, calibrated=True, uniform=True, tap_agg=False,
                      dh=12, ds=3, df=5, dout=12, k=4):
    """A hand-built int8 GravNet chain, as the reference's fusion tests
    build it: only direct fusion of an already-calibrated graph reaches
    the int8 guard (deploy fuses before the precision policy runs)."""
    rng = np.random.default_rng(11)
    g = Graph()
    g.add(Operator(name="x", op_type="input", out_dim=dh,
                   attrs={"feature": "x"}))
    g.add(Operator(name="m", op_type="input", out_dim=1,
                   attrs={"feature": "m"}))

    def _dense(name, inp, d_in, d_out, activation):
        w = torch.from_numpy((rng.normal(size=(d_in, d_out)) * 0.3)
                             .astype(np.float32))
        b = torch.from_numpy((rng.normal(size=(d_out,)) * 0.1)
                             .astype(np.float32))
        op = Operator(name=name, op_type="dense", inputs=[inp],
                      params={"w": w, "b": b}, out_dim=d_out,
                      attrs={"activation": activation}, precision="int8")
        if calibrated:
            op.params["w_q"], op.params["w_scale"] = quantize_weight(w)
            op.attrs["in_scale"] = 0.02
        return op

    g.add(_dense("s", "x", dh, ds, "none"))
    g.add(_dense("f", "x", dh, df, "none"))
    agg = Operator(name="agg", op_type="gravnet_aggregate",
                   inputs=["s", "f", "m"],
                   attrs={"k": k, "scale": 10.0, "d_s": ds, "d_f": df},
                   out_dim=2 * df, precision="int8")
    if calibrated:
        agg.attrs["act_scale"] = 0.01
    g.add(agg)
    g.add(Operator(name="cat", op_type="concat", inputs=["x", "agg"],
                   out_dim=dh + 2 * df, precision="int8"))
    g.add(_dense("blk_out", "cat", dh + 2 * df, dout, "relu"))
    g["blk_out"].attrs["act_scale"] = 0.05
    if not uniform:
        g["f"].precision = "bf16"
    heads, head_names = ["blk_out"], ["y"]
    if tap_agg:
        g.add(Operator(name="agg_tap", op_type="relu", inputs=["agg"],
                       out_dim=2 * df))
        heads.append("agg_tap")
        head_names.append("tap")
    g.add(Operator(name="out", op_type="output", inputs=heads,
                   attrs={"head_names": head_names},
                   out_dim=dout + (2 * df if tap_agg else 0)))
    g.validate()
    return g


def test_fuse_calibrated_int8_chain_carries_quantization():
    """Direct fusion of an already-calibrated uniform-int8 chain carries
    the quantized weights and the chain's scales onto the block, which
    then computes the quantized block's plain version."""
    g = _int8_chain_graph()
    blocks = [op for op in tfuse(g, gravnet_block=True)
              if op.op_type == "gravnet_block"]
    assert len(blocks) == 1
    blk = blocks[0]
    assert blk.precision == "int8"
    for nm, src in (("ws", "s"), ("wf", "f"), ("wo", "blk_out")):
        assert blk.params[nm + "_q"] is g[src].params["w_q"]
        assert blk.params[nm + "_scale"] is g[src].params["w_scale"]
    assert (blk.attrs["in_scale"], blk.attrs["agg_scale"],
            blk.attrs["h_scale"], blk.attrs["act_scale"]) == (
                0.02, 0.01, 0.02, 0.05)


@pytest.mark.parametrize("case", ["uncalibrated", "mixed_members",
                                  "tapped_aggregate"])
def test_fuse_refuses_int8_chain(case):
    g = _int8_chain_graph(calibrated=case != "uncalibrated",
                          uniform=case != "mixed_members",
                          tap_agg=case == "tapped_aggregate")
    f = tfuse(g, gravnet_block=True)
    assert not any(op.op_type == "gravnet_block" for op in f)
    assert any(op.op_type == "gravnet_aggregate" for op in f)


def test_quantized_block_plain_version_is_the_unfused_int8_chain():
    """``gravnet_block_int8_ref`` composed from the unfused chain's own
    plain ops: quantize x, int8 S/F dots, the aggregation, the int8
    snap, quantize concat(x, agg), the int8 output dot."""
    g = _int8_chain_graph()
    rng = np.random.default_rng(5)
    x = torch.from_numpy(np.maximum(rng.normal(size=(2, 9, 12)), 0)
                         .astype(np.float32))
    m = torch.ones(2, 9)
    p = {n: g[n].params for n in ("s", "f", "blk_out")}
    xq = quantize_act(x, 0.02)
    s = tref.fused_dense_int8_ref(xq, p["s"]["w_q"], p["s"]["b"], 0.02,
                                  p["s"]["w_scale"], activation="none")
    f = tref.fused_dense_int8_ref(xq, p["f"]["w_q"], p["f"]["b"], 0.02,
                                  p["f"]["w_scale"], activation="none")
    agg = tref.gravnet_aggregate_ref(s, f, m, k=4)
    agg = torch.clamp(torch.round(agg / f32(0.01)), -127, 127) * f32(0.01)
    hq = quantize_act(torch.cat([x, agg], -1), 0.02)
    want = tref.fused_dense_int8_ref(hq, p["blk_out"]["w_q"],
                                     p["blk_out"]["b"], 0.02,
                                     p["blk_out"]["w_scale"])
    got = tref.gravnet_block_int8_ref(
        x, m, p["s"]["w_q"], p["s"]["b"], p["f"]["w_q"], p["f"]["b"],
        p["blk_out"]["w_q"], p["blk_out"]["b"], p["s"]["w_scale"],
        p["f"]["w_scale"], p["blk_out"]["w_scale"], x_scale=0.02,
        agg_scale=0.01, h_scale=0.02, k=4)
    assert_bitwise(got.numpy(), want.numpy())
