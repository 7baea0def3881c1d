"""A deployed GravNet block whose output dense reads the aggregate alone
(``concat_x=False``), the port against the JAX package on the CPU.

The graph is CaloClusterNet's at the current detector's widths with each
``gn{i}_cat`` taken out: ``gn{i}_out`` reads ``gn{i}_agg`` and keeps the
aggregate's rows of its weight, (2·d_f, d_hidden). The fusion pass of
both packages then fuses each S/F → aggregate → dense chain into a block
with ``concat_x=False``. Both packages deploy it on the same converted
weights, fp and mixed at design points 2 and 3, and ragged fp: the
deployed graphs equal op for op, the heads within the float32 row (mixed:
the calibration bound of the baked scales), CPS decisions bitwise.
"""
import dataclasses

import jax
import numpy as np
import pytest
from _numerics import (assert_bitwise, assert_calibration_close,
                       assert_close, int8_flip_tolerance)

from repro.core import caloclusternet as jccn
from repro.core.passes.parallelize import Requirements as JReq
from repro.core.pipeline import deploy as jdeploy
from repro.data import belle2 as jbelle2
from repro_torch.convert import from_jax_params
from repro_torch.core import caloclusternet as tccn
from repro_torch.core.pipeline import Requirements as TReq
from repro_torch.core.pipeline import deploy as tdeploy

N_EVENTS = 8
HEADS = ("beta", "coords", "energy", "cls")


def no_concat_graph(g, d_hidden):
    """``g`` with every concat op taken out: its consumer reads the
    concat's second input (the aggregate) and keeps the rows of its
    weight past ``d_hidden`` (the aggregate's)."""
    g = g.clone()
    for name in [op.name for op in g if op.op_type == "concat"]:
        agg = g.ops.pop(name).inputs[1]
        for op in list(g):
            if name in op.inputs:
                new = dataclasses.replace(
                    op, inputs=[agg if i == name else i for i in op.inputs])
                new.params = dict(op.params, w=op.params["w"][d_hidden:])
                g.ops[op.name] = new
    g.validate()
    return g


@pytest.fixture(scope="module")
def model():
    jcfg = jccn.CCNConfig(n_hits=32)
    tcfg = tccn.CCNConfig(n_hits=32)
    params = jccn.init(jax.random.PRNGKey(5), jcfg)
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                              tcfg, device="cpu")
    return (jcfg, no_concat_graph(jccn.to_graph(params, jcfg),
                                  jcfg.d_hidden),
            tcfg, no_concat_graph(tccn.to_graph(tparams, tcfg),
                                  tcfg.d_hidden))


@pytest.fixture(scope="module")
def feeds():
    ev = jbelle2.generate(jbelle2.current_detector(), N_EVENTS, seed=13)
    return {"hits": ev["feats"], "mask": ev["mask"]}


def _req_kw(dp, cfg, policy):
    return dict(design_point=dp, platform="cpu", precision_policy=policy,
                n_hits=cfg.n_hits, target_throughput=1e5,
                max_latency_s=2e-3)


def _rows(g):
    return [(op.name, op.op_type, op.target, op.segment, op.precision,
             op.attrs.get("concat_x"), op.attrs_opt.get("P"))
            for op in g]


def _check(jout, tout, quantum=None):
    jout = jax.tree_util.tree_map(np.asarray, jout)
    for h in HEADS:
        got = np.asarray(tout[h])
        if quantum is None:
            assert_close(got, jout[h], dtype="float32", context=h)
        else:
            assert_calibration_close(got, jout[h], quantum=quantum,
                                     context=h)
    for k in ("n_clusters", "trigger", "cluster_valid"):
        assert_bitwise(np.asarray(tout["cps"][k]), jout["cps"][k],
                       context=k)


@pytest.mark.parametrize("policy", ["fp", "mixed"])
@pytest.mark.parametrize("dp", [2, 3])
def test_no_concat_deployment_matches_reference(model, feeds, dp, policy):
    jcfg, jg, tcfg, tg = model
    calib = feeds if policy == "mixed" else None
    jpipe = jdeploy(jg, JReq(**_req_kw(dp, jcfg, policy)),
                    calibration_feeds=calib)
    tpipe = tdeploy(tg, TReq(**_req_kw(dp, tcfg, policy)),
                    calibration_feeds=calib, device="cpu")
    assert _rows(tpipe.graph) == _rows(jpipe.graph)
    blocks = [op for op in tpipe.graph if op.op_type == "gravnet_block"]
    assert len(blocks) == 2
    assert not any(op.attrs["concat_x"] for op in blocks)
    assert all(op.params["wo"].shape[0] == 2 * tcfg.d_flr for op in blocks)
    quantum = None
    if policy == "mixed":
        assert all("ws_q" in op.params for op in blocks)
        for op in blocks:   # calibrated on the aggregate alone
            jop = jpipe.graph[op.name]
            for s in ("in_scale", "agg_scale", "h_scale"):
                assert op.attrs[s] == pytest.approx(jop.attrs[s],
                                                    rel=1e-6), s
        quantum = max(int8_flip_tolerance(op.attrs["h_scale"],
                                          op.params["wo_scale"].numpy(),
                                          flips=4) for op in blocks)
    _check(jpipe(feeds), tpipe(feeds), quantum)


def test_no_concat_ragged_deployment_matches_reference(model, feeds):
    """The ragged path runs the no-concat block as its chain (S/F
    denses, knn_build, knn_aggregate, the output dense on the aggregate
    alone)."""
    jcfg, jg, tcfg, tg = model
    jpipe = jdeploy(jg, JReq(**_req_kw(3, jcfg, "fp")), batch=4,
                    ragged=True)
    tpipe = tdeploy(tg, TReq(**_req_kw(3, tcfg, "fp")), batch=4,
                    ragged=True, device="cpu")
    assert _rows(tpipe.pipe.graph) == _rows(jpipe.pipe.graph)
    blocks = [op for op in tpipe.pipe.graph
              if op.op_type == "gravnet_block"]
    assert blocks and not any(op.attrs["concat_x"] for op in blocks)
    _check(jpipe(feeds), tpipe(feeds))
