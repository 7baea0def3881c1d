"""The port's design flow and deployed pipeline against the JAX
package's, on the CPU: the same graphs op for op, heads within the
float32 row and CPS decisions bitwise on the same weights and events.
"""
import dataclasses

import jax
import numpy as np
import pytest
from _numerics import (assert_bitwise, assert_calibration_close,
                       assert_close, int8_flip_tolerance)

from repro.core import caloclusternet as jccn
from repro.core.passes.fusion import fuse as jfuse
from repro.core.passes.parallelize import Requirements as JReq
from repro.core.passes.partition import partition as jpartition
from repro.core.pipeline import deploy as jdeploy
from repro.core.quantization import apply_precision_policy as jpolicy
from repro.data import belle2 as jbelle2
from repro_torch.convert import from_jax_params
from repro_torch.core import caloclusternet as tccn
from repro_torch.core.passes.fusion import fuse as tfuse
from repro_torch.core.passes.partition import partition as tpartition
from repro_torch.core.pipeline import Requirements as TReq
from repro_torch.core.pipeline import deploy as tdeploy
from repro_torch.core.quantization import apply_precision_policy as tpolicy
from repro_torch.data import belle2 as tbelle2

N_EVENTS = 8


def _req_kw(dp, cfg, policy="fp"):
    return dict(design_point=dp, platform="cpu", precision_policy=policy,
                n_hits=cfg.n_hits, target_throughput=1e5,
                max_latency_s=2e-3)


@pytest.fixture(scope="module")
def model():
    jcfg = jccn.CCNConfig(n_hits=32)
    tcfg = tccn.CCNConfig(n_hits=32)
    params = jccn.init(jax.random.PRNGKey(3), jcfg)
    params_np = jax.tree_util.tree_map(np.asarray, params)
    tparams = from_jax_params(params_np, tcfg, device="cpu")
    return (jcfg, jccn.to_graph(params, jcfg),
            tcfg, tccn.to_graph(tparams, tcfg))


@pytest.fixture(scope="module")
def events():
    gen = jbelle2.current_detector()
    ev = jbelle2.generate(gen, N_EVENTS, seed=11)
    ev_t = tbelle2.generate(tbelle2.current_detector(), N_EVENTS, seed=11)
    return ev, ev_t


def _op_rows(g):
    return [(op.name, op.op_type, op.target, op.segment, op.precision,
             op.attrs_opt.get("P"), op.attrs_opt.get("variant"))
            for op in g]


@pytest.fixture(scope="module", params=[2, 3])
def deployed(request, model):
    dp = request.param
    jcfg, jg, tcfg, tg = model
    jpipe = jdeploy(jg, JReq(**_req_kw(dp, jcfg)))
    tpipe = tdeploy(tg, TReq(**_req_kw(dp, tcfg)), device="cpu")
    return dp, jpipe, tpipe


def test_belle2_copies_are_byte_equal(events):
    ev, ev_t = events
    assert set(ev) == set(ev_t)
    for k in ev:
        assert ev[k].dtype == ev_t[k].dtype
        assert ev[k].tobytes() == ev_t[k].tobytes(), k


def test_deployed_graphs_equal(deployed):
    dp, jpipe, tpipe = deployed
    assert _op_rows(tpipe.graph) == _op_rows(jpipe.graph)
    assert (tpipe.graph.meta["parallelization"]["microbatch"]
            == jpipe.graph.meta["parallelization"]["microbatch"])
    assert tpipe.microbatch == jpipe.microbatch
    # the merged head dense carries the same (concatenated) weights
    for op in jpipe.graph:
        if op.params:
            for k, v in op.params.items():
                assert_bitwise(tpipe.graph[op.name].params[k].numpy(),
                               np.asarray(v), context=f"{op.name}/{k}")


@pytest.mark.parametrize("backend", ["xla", "pallas_interpret"])
def test_heads_close_and_cps_bitwise(deployed, model, events, backend):
    dp, jpipe, tpipe = deployed
    jcfg, jg, _, _ = model
    if backend != "xla":
        jpipe = jdeploy(jg, JReq(**_req_kw(dp, jcfg)),
                        kernel_backend=backend)
    ev = events[0]
    feeds = {"hits": ev["feats"], "mask": ev["mask"]}
    jout = jax.tree_util.tree_map(np.asarray, jpipe(feeds))
    tout = tpipe(feeds)
    for h in ("beta", "coords", "energy", "cls"):
        assert_close(tout[h].numpy(), jout[h], dtype="float32", context=h)
    jc, tc = jout["cps"], {k: v.numpy() for k, v in tout["cps"].items()}
    for k in ("n_clusters", "trigger", "cluster_valid"):
        assert tc[k].dtype == jc[k].dtype, k
        assert_bitwise(tc[k], jc[k], context=k)
    for k in ("cluster_xy", "cluster_e", "cluster_beta"):
        assert_close(tc[k], jc[k], dtype="float32", context=k)


def test_precision_policies_match_reference(model):
    """Both branches of apply_precision_policy set the reference's
    precisions on the fused, partitioned graph."""
    _, jg, _, tg = model
    jp = jpartition(jfuse(jg, gravnet_block=True))
    tp = tpartition(tfuse(tg, gravnet_block=True))
    for policy in ("fp", "mixed"):
        assert ([(o.name, o.precision) for o in tpolicy(tp, policy=policy)]
                == [(o.name, o.precision) for o in jpolicy(jp,
                                                           policy=policy)])


def _compare_with_reference(jpipe, tpipe, events, heads, quantum=None):
    """Graph rows and micro-batch equal; heads to the float32 row (or to
    calibration tolerance when ``quantum`` is given); CPS integer
    outputs bitwise."""
    assert _op_rows(tpipe.graph) == _op_rows(jpipe.graph)
    assert tpipe.microbatch == jpipe.microbatch
    ev = events[0]
    feeds = {"hits": ev["feats"], "mask": ev["mask"]}
    jout = jax.tree_util.tree_map(np.asarray, jpipe(feeds))
    tout = tpipe(feeds)
    for h in heads:
        if quantum is None:
            assert_close(tout[h].numpy(), jout[h], dtype="float32",
                         context=h)
        else:
            assert_calibration_close(tout[h].numpy(), jout[h],
                                     quantum=quantum, context=h)
    for k in ("n_clusters", "trigger", "cluster_valid"):
        assert_bitwise(tout["cps"][k].numpy(), jout["cps"][k], context=k)


def test_mixed_precision_deploys_at_design_point_2(model, events):
    """The mixed policy (the reference's serve default) deploys at
    design point 2 too, calibrated, with quantized blocks, and agrees
    with the reference."""
    jcfg, jg, tcfg, tg = model
    ev = events[0]
    calib = {"hits": ev["feats"], "mask": ev["mask"]}
    jpipe = jdeploy(jg, JReq(**_req_kw(2, jcfg, "mixed")),
                    calibration_feeds=calib)
    tpipe = tdeploy(tg, TReq(**_req_kw(2, tcfg, "mixed")),
                    calibration_feeds=calib, device="cpu")
    blocks = [op for op in tpipe.graph if op.op_type == "gravnet_block"]
    assert len(blocks) == 2 and all("ws_q" in b.params for b in blocks)
    quantum = max(int8_flip_tolerance(b.attrs["h_scale"],
                                      b.params["wo_scale"].numpy(), flips=4)
                  for b in blocks)
    _compare_with_reference(jpipe, tpipe, events,
                            ("beta", "coords", "energy", "cls"), quantum)


def test_design_point_1_runs_gravnet_aggregate(model, events):
    """Design point 1 keeps the GravNet chain unfused and runs the
    gravnet_aggregate kernel's entry point; it matches the reference."""
    jcfg, jg, tcfg, tg = model
    jpipe = jdeploy(jg, JReq(**_req_kw(1, jcfg)))
    tpipe = tdeploy(tg, TReq(**_req_kw(1, tcfg)), device="cpu")
    assert tpipe.microbatch == 1
    assert sum(op.op_type == "gravnet_aggregate" for op in tpipe.graph) == 2
    _compare_with_reference(jpipe, tpipe, events,
                            ("beta", "coords", "energy", "cls"))


def test_unfusable_block_runs_gravnet_aggregate(model, events):
    """A GravNet chain the fusion pass must leave unfused (here: the
    aggregate has a second consumer) runs the gravnet_aggregate kernel's
    entry point and matches the reference, tapped aggregate included."""
    jcfg, jg, tcfg, tg = model
    graphs = []
    for g0 in (jg, tg):
        g = g0.clone()
        out = g["out"]
        g.ops["out"] = dataclasses.replace(out, inputs=out.inputs[:-1]
                                           + ["gn0_agg", "cps"])
        g.ops["out"].attrs = dict(out.attrs, head_names=list(
            out.attrs["head_names"]) + ["tap"])
        graphs.append(g)
    jpipe = jdeploy(graphs[0], JReq(**_req_kw(3, jcfg)))
    tpipe = tdeploy(graphs[1], TReq(**_req_kw(3, tcfg)), device="cpu")
    kinds = [op.op_type for op in tpipe.graph]
    assert kinds.count("gravnet_aggregate") == 1
    assert kinds.count("gravnet_block") == 1
    _compare_with_reference(jpipe, tpipe, events,
                            ("beta", "coords", "energy", "cls", "tap"))


def test_block_without_concat_raises(model, events):
    """A fused block whose output dense reads the aggregate alone
    (concat_x=False) once raised here, having no kernel in the port; it
    now runs the blocks' no-concat form and agrees with the reference
    (the test keeps its name): the graph without its concat ops
    (``test_torch_no_concat.no_concat_graph``), fp at design point 3."""
    from test_torch_no_concat import no_concat_graph
    jcfg, jg, tcfg, tg = model
    jpipe = jdeploy(no_concat_graph(jg, jcfg.d_hidden),
                    JReq(**_req_kw(3, jcfg)))
    tpipe = tdeploy(no_concat_graph(tg, tcfg.d_hidden),
                    TReq(**_req_kw(3, tcfg)), device="cpu")
    blocks = [op for op in tpipe.graph if op.op_type == "gravnet_block"]
    assert blocks and not any(op.attrs["concat_x"] for op in blocks)
    _compare_with_reference(jpipe, tpipe, events,
                            ("beta", "coords", "energy", "cls"))


@pytest.mark.parametrize("dp", [1, 2, 3])
@pytest.mark.parametrize("policy", ["fp", "mixed"])
def test_tpu_native_gravnet_matches_reference(model, events, dp, policy):
    """``Requirements.tpu_native_gravnet=True`` (serve's
    ``--tpu-native-gravnet``) partitions the GravNet aggregation onto
    the kernel target: the deployed graphs equal the reference's op for
    op, the heads within the float32 row (under mixed both packages
    quantize on the same calibrated grid) and CPS decisions bitwise."""
    jcfg, jg, tcfg, tg = model
    ev = events[0]
    calib = ({"hits": ev["feats"], "mask": ev["mask"]}
             if policy == "mixed" else None)
    kw = dict(_req_kw(dp, jcfg, policy), tpu_native_gravnet=True)
    jpipe = jdeploy(jg, JReq(**kw), calibration_feeds=calib)
    tpipe = tdeploy(tg, TReq(**kw), calibration_feeds=calib, device="cpu")
    plain = tdeploy(tg, TReq(**_req_kw(dp, tcfg, policy)),
                    calibration_feeds=calib, device="cpu")
    agg = [op for op in tpipe.graph if op.op_type == "gravnet_aggregate"]
    assert all(op.target == "mxu" for op in agg)
    if agg:   # the flag moves the aggregation off the host target
        assert _op_rows(tpipe.graph) != _op_rows(plain.graph)
    _compare_with_reference(jpipe, tpipe, events,
                            ("beta", "coords", "energy", "cls"))
