"""The design flow's platforms in the port: the H100's cost model ("h100",
the default, which deploys on the card) and the reference's CPU
constants ("cpu", which the CPU deployments and the differential tests
use), on the CPU.

"h100" meets a reachable target at the smallest P (the port's
counterpart of ``tests/test_core_flow.py``'s test on the reference's TPU
model) and picks the P that ``chip_smoke.py`` phase 19 reads on the card
for the served paths; "cpu" picks the reference's P and micro-batch for
every deployment of ``test_torch_deploy.py``'s matrix (the pass run in
both packages on the same graphs); no TPU constant is left in the port.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import caloclusternet as jccn
from repro.core.passes.fusion import fuse as jfuse
from repro.core.passes.mapping import map_templates as jmap
from repro.core.passes.parallelize import Requirements as JReq
from repro.core.passes.parallelize import parallelize as jparallelize
from repro.core.passes.partition import partition as jpartition
from repro.core.quantization import apply_precision_policy as jpolicy
from repro_torch.convert import from_jax_params
from repro_torch.core import caloclusternet as tccn
from repro_torch.core.graph_ir import export_graph
from repro_torch.core.passes.fusion import fuse as tfuse
from repro_torch.core.passes.mapping import map_templates as tmap
from repro_torch.core.passes.parallelize import Requirements as TReq
from repro_torch.core.passes.parallelize import model_step
from repro_torch.core.passes.parallelize import parallelize as tparallelize
from repro_torch.core.passes.partition import partition as tpartition
from repro_torch.core.pipeline import deploy as tdeploy
from repro_torch.core.quantization import apply_precision_policy as tpolicy
from repro_torch.launch import mesh, serve
from repro_torch.models.gnn import gatedgcn

#: the paper's targets (repro/benchmarks/design_points.py)
PAPER = dict(target_throughput=3e6, max_latency_s=10e-6)
#: serve's (launch/serve.py: TARGET_THROUGHPUT and the 2 ms budget)
SERVE = dict(target_throughput=serve.TARGET_THROUGHPUT, max_latency_s=2e-3)


def _mapped(cfg, params, policy, *, fused=True, native=False):
    """The upgrade-width graph through fuse, partition, the precision
    policy and mapping: the pass sequence ``deploy`` runs before the P
    search."""
    g = export_graph("caloclusternet", params, cfg)
    if fused:
        g = tfuse(g, gravnet_block=True)
    return tmap(tpolicy(tpartition(g, tpu_native_gravnet=native),
                        policy=policy))


@pytest.fixture(scope="module")
def upgrade():
    cfg = tccn.CCNConfig()
    return cfg, tccn.init(torch.Generator().manual_seed(0), cfg)


def _gatedgcn_graph():
    gcfg = gatedgcn.GatedGCNConfig(n_layers=16, d_hidden=70, d_in=8,
                                   d_edge_in=4, n_classes=2)
    params = gatedgcn.init(torch.Generator().manual_seed(1), gcfg)
    g = export_graph("gatedgcn", params, gcfg)
    return tmap(tpolicy(tpartition(tfuse(g, gravnet_block=True)),
                        policy="fp"))


@pytest.mark.parametrize("policy,target", [("fp", 1e4), ("fp", 1e5),
                                           ("mixed", 1e5)])
def test_h100_meets_a_reachable_target_at_the_smallest_p(upgrade, policy,
                                                          target):
    """On "h100" the search meets a reachable target, and bounding P
    below the chosen P_mxu misses it (or costs no less), as the
    reference's test holds its TPU model."""
    cfg, params = upgrade
    g = _mapped(cfg, params, policy)
    req = TReq(target_throughput=target, n_hits=cfg.n_hits,
               precision_policy=policy)
    meta = tparallelize(g, req).meta["parallelization"]
    assert meta["model_throughput_ev_s"] >= target
    assert meta["P_mxu"] in {2 ** i for i in range(9)}
    half = dataclasses.replace(req, max_p=max(meta["P_mxu"],
                                              meta["P_xla"]) // 2)
    m2 = tparallelize(g, half).meta["parallelization"]
    assert (m2["model_throughput_ev_s"] < target
            or m2["P_mxu"] + m2["P_xla"] <= meta["P_mxu"] + meta["P_xla"])
    assert m2["model_throughput_ev_s"] < target


# The P the "h100" model picks, as chip_smoke.py phase 19 prints it on the
# card (NVIDIA H100 80GB HBM3, 700.00 W): (P_mxu, P_xla).
PICKS = {
    ("mixed", "serve"): (16, 32),
    ("fp", "serve"): (8, 32),
    ("gatedgcn", "serve"): (16, 16),
    ("mixed", "paper"): (1, 1),
    ("fp", "paper"): (1, 1),
    ("gatedgcn", "paper"): (1, 1),
}


@pytest.mark.parametrize("path,targets", sorted(PICKS))
def test_h100_picks_the_cards_p(upgrade, path, targets):
    """The served default (mixed), fp and GatedGCN 16 x 70 at serve's
    target (1e5 events/s within 2 ms) and at the paper's (3e6 within 10
    µs, which no P meets: CPS's launches alone take longer, so the search
    falls back as the reference's does)."""
    cfg, params = upgrade
    if path == "gatedgcn":
        g, n = _gatedgcn_graph(), 64
    else:
        g, n = _mapped(cfg, params, path), cfg.n_hits
    req = TReq(n_hits=n, precision_policy="fp" if path == "gatedgcn"
               else path, **(SERVE if targets == "serve" else PAPER))
    meta = tparallelize(g, req).meta["parallelization"]
    assert (meta["P_mxu"], meta["P_xla"]) == PICKS[(path, targets)]
    if targets == "paper":
        assert meta["model_latency_s"] > PAPER["max_latency_s"]


def _both_graphs(dp, policy, fused, native, ragged=False):
    """The same model through both packages' passes up to mapping (the
    current detector's CaloClusterNet, as test_torch_deploy.py deploys)."""
    from repro.core.passes.ragged import raggedize as jraggedize
    from repro_torch.core.passes.ragged import raggedize as traggedize
    jcfg, tcfg = jccn.CCNConfig(n_hits=32), tccn.CCNConfig(n_hits=32)
    params = jccn.init(jax.random.PRNGKey(3), jcfg)
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                              tcfg, device="cpu")
    jg, tg = jccn.to_graph(params, jcfg), tccn.to_graph(tparams, tcfg)
    if dp >= 2:
        jg = jfuse(jg, gravnet_block=fused)
        tg = tfuse(tg, gravnet_block=fused)
    if ragged:
        jg, tg = jraggedize(jg), traggedize(tg)
    jg = jmap(jpolicy(jpartition(jg, tpu_native_gravnet=native),
                      policy=policy))
    tg = tmap(tpolicy(tpartition(tg, tpu_native_gravnet=native),
                      policy=policy))
    return jg, tg


@pytest.mark.parametrize("dp,policy,fused,native,ragged", [
    (2, "fp", True, False, False), (3, "fp", True, False, False),
    (2, "mixed", True, False, False), (3, "mixed", True, False, False),
    (3, "mixed", False, False, False), (3, "fp", False, False, False),
    (2, "fp", True, True, False), (3, "fp", True, True, False),
    (2, "mixed", True, True, False), (3, "mixed", True, True, False),
    (3, "fp", True, False, True)])
def test_cpu_picks_the_reference_p(dp, policy, fused, native, ragged):
    """On "cpu" the P search picks the reference's P per op, micro-batch
    and modelled figures for test_torch_deploy.py's deployments (design
    points 2-3, fp and mixed, fused or not, tpu_native_gravnet, and the
    ragged graph); design point 1 runs no search (P = 1 in both)."""
    jg, tg = _both_graphs(dp, policy, fused, native, ragged)
    kw = dict(design_point=dp, platform="cpu", precision_policy=policy,
              n_hits=32, target_throughput=1e5, max_latency_s=2e-3,
              tpu_native_gravnet=native)
    jp = jparallelize(jg, JReq(**kw))
    tp = tparallelize(tg, TReq(**kw))
    assert tp.meta["parallelization"] == jp.meta["parallelization"]
    assert [(op.name, op.attrs_opt["P"]) for op in tp] == \
        [(op.name, op.attrs_opt["P"]) for op in jp]


def test_requirements_default_to_the_h100():
    assert TReq().platform == "h100"
    assert dataclasses.replace(TReq(), platform="cpu").platform == "cpu"
    with pytest.raises(ValueError, match="platform"):
        tparallelize(_gatedgcn_graph(), TReq(platform="tpu", n_hits=64))


def test_no_tpu_constant_left():
    """The port's hardware module holds no TPU rate or memory size; the
    H100's constants are there."""
    for name in ("PEAK_FLOPS_BF16", "HBM_BW", "VMEM_BYTES"):
        assert not hasattr(mesh, name), name
    from repro_torch.core.passes import parallelize
    assert not hasattr(parallelize, "VPU_PEAK")
    for name in ("H100_HBM_BW", "H100_PEAK_FLOPS_F32", "H100_SMS",
                 "H100_L2_BYTES", "H100_LAUNCH_S", "H100_KERNEL_LAUNCH_S",
                 "H100_PLAIN_FLOPS"):
        assert getattr(mesh, name) > 0, name
    assert mesh.H100_PEAK_FLOPS_F32_NO_FMA == mesh.H100_PEAK_FLOPS_F32 / 2


@pytest.mark.parametrize("device,platform,want", [
    ("cpu", None, "cpu"), ("cpu", "h100", "h100"), ("cpu", "cpu", "cpu")])
def test_serve_deploys_on_the_devices_platform(device, platform, want):
    """``serve.build_pipeline(device="cpu")`` deploys on "cpu" (the
    reference's P); a caller may still name the platform; a GNN route
    follows the device too."""
    cfg = tccn.current_detector_config()
    pipe = serve.build_pipeline(cfg, serve.detector_configs("current")[1],
                                precision="fp", device=device,
                                platform=platform)
    assert pipe.req.platform == want
    args = serve.parse_args(["--device", device]
                            + (["--platform", platform] if platform else []))
    assert serve._edge_req(args).platform == want
    assert serve.platform_of("cpu") == "cpu"


def test_h100_report_has_l2_and_sm_fill(upgrade):
    """The "h100" report rows: the working set's share of the L2, the
    widest launch's share of the SMs at the segment's P and its launches,
    no VMEM share; the "cpu" rows keep the reference's keys but it."""
    cfg, params = upgrade
    g = export_graph("caloclusternet", params, cfg)
    h = tdeploy(g, TReq(precision_policy="fp", n_hits=cfg.n_hits, **SERVE),
                device="cpu")
    rows = h.resource_report()
    assert rows and all("vmem_util" not in r and "vmem_working_set" not in r
                        for r in rows)
    assert all({"l2_util", "sm_fill", "launches"} <= set(r) for r in rows)
    assert max(r["sm_fill"] for r in rows) > 0
    assert all(0 <= r["sm_fill"] <= 1 and r["l2_util"] > 0 for r in rows)
    par = h.graph.meta["parallelization"]
    assert h.model_latency() > 0 and par["model_latency_s"] == pytest.approx(
        model_step(h.graph, h.req, par["P_mxu"], par["P_xla"])[1])
    c = tdeploy(g, TReq(precision_policy="fp", n_hits=cfg.n_hits,
                        platform="cpu", **SERVE), device="cpu")
    assert all("vmem_util" not in r and "vmem_working_set" in r
               and "l2_util" not in r for r in c.resource_report())
