"""The port's dry-run (``repro_torch/launch/{dryrun,analysis}.py``) on
the CPU, against the JAX package's where the two are comparable.

- The per-device counting rule: at a (16, 16) fake mesh, a matrix
  product sharded over the model axis counts its global FLOPs / 16 on a
  device, a replicated one its global FLOPs; a redistribute counts its
  collective under the reference's kind name at its per-device bytes.
- ``affine_extrapolate`` equals the reference's on the same numbers;
  ``roofline`` reads the H100 datasheet model with the reference's keys.
- ``dryrun.run_cell`` in its own processes for olmo-1b ``train_4k`` and
  ``decode_32k`` (with the reference's cost variants, L 2 and 4),
  ``caloclusternet:trigger_serve``, ``gatedgcn:full_graph_sm`` and
  ``mind:serve_p99`` at (16, 16): the report has the reference's keys,
  ``model_flops`` equals the reference's, the argument bytes per device
  equal the sum of the reference's shard bytes, a contraction over the
  model axis shows its collectives, and decode_32k's per-device FLOPs
  of the full L lie on its L 2 / L 4 line within 1e-6 (train_4k runs
  without the cost pass here; the full dry-run reports its line too).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from _blas_threads import _blas_two_threads  # noqa: F401 (autouse)

from repro.launch import analysis as janalysis
from repro_torch.launch import analysis as tanalysis

REPO = Path(__file__).resolve().parent.parent
CELLS = ["olmo-1b:train_4k", "olmo-1b:decode_32k",
         "caloclusternet:trigger_serve", "gatedgcn:full_graph_sm",
         "mind:serve_p99"]
# cells per process, the largest alone (they run at once)
GROUPS = [["olmo-1b:train_4k"], ["gatedgcn:full_graph_sm"],
          ["olmo-1b:decode_32k", "caloclusternet:trigger_serve",
           "mind:serve_p99"]]
_DT_BYTES = {"float32": 4, "bfloat16": 2, "int32": 4, "int8": 1,
             "float16": 2, "int64": 8}

# the reference's report keys (repro/launch/dryrun.py)
REPORT_KEYS = {"arch", "shape", "mesh", "kind", "n_chips", "t_lower_s",
               "t_compile_s", "memory", "per_device", "collectives",
               "model_flops", "roofline"}
MEMORY_KEYS = {"generated_code_size_in_bytes", "argument_size_in_bytes",
               "output_size_in_bytes", "temp_size_in_bytes",
               "alias_size_in_bytes"}


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO / "src"),
                JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    """The port's reports (``run_cell`` in processes of their own, all
    at once) and the reference's shard shapes of the same cells."""
    out = tmp_path_factory.mktemp("dryrun")
    code = ("import sys\n"
            "from repro_torch.launch import dryrun\n"
            "for c in sys.argv[2:]:\n"
            "    a, s = c.split(':')\n"
            "    dryrun.run_cell(a, s, multi_pod=False,\n"
            "                    cost_pass=s == 'decode_32k',\n"
            "                    report_dir=sys.argv[1], force=True)\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(out), *g],
                              env=_env(), cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for g in GROUPS]
    ref = subprocess.Popen([sys.executable, str(REPO / "tests" /
                                                "_ref_cells.py"), *CELLS],
                           env=_env(), stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    ref_out, ref_err = ref.communicate(timeout=600)
    assert ref.returncode == 0, ref_err[-3000:]
    for p in procs:
        log = p.communicate(timeout=600)[0]
        assert p.returncode == 0, log[-3000:]
    recs = {}
    for c in CELLS:
        a, s = c.split(":")
        with open(out / f"{a}__{s}__pod16x16.json") as f:
            recs[c] = json.load(f)
    return recs, {f"{r['arch']}:{r['shape']}": r
                  for r in json.loads(ref_out)}


def test_per_device_counting_rule():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.mesh import fake_world, make_production_mesh
    m, k, n = 256, 512, 1024
    glob = 2.0 * m * k * n
    with fake_world(256):
        mesh = make_production_mesh()
        with FakeTensorMode(), implicit_replication():
            x = distribute_tensor(torch.empty(m, k), mesh,
                                  [Replicate(), Replicate()])
            w_tp = distribute_tensor(torch.empty(k, n), mesh,
                                     [Replicate(), Shard(1)])
            w_rep = distribute_tensor(torch.empty(k, n), mesh,
                                      [Replicate(), Replicate()])
            for w, want in ((w_tp, glob / 16), (w_rep, glob)):
                mode = tanalysis.CostMode()
                with mode:
                    y = x @ w
                assert mode.flops == want
                assert mode.record()["collective_bytes"] == 0
            mode = tanalysis.CostMode()
            with mode:
                y.redistribute(mesh, [Replicate(), Replicate()])
            rec = mode.record()
    # y was already replicated: nothing moves; an all-gather of the
    # model-sharded product moves its whole (m, n) f32 to every device
    assert rec["collective_bytes"] == 0
    with fake_world(256):
        mesh = make_production_mesh()
        with FakeTensorMode(), implicit_replication():
            x = distribute_tensor(torch.empty(m, k), mesh,
                                  [Replicate(), Replicate()])
            y = x @ distribute_tensor(torch.empty(k, n), mesh,
                                      [Replicate(), Shard(1)])
            mode = tanalysis.CostMode()
            with mode:
                y.redistribute(mesh, [Replicate(), Replicate()])
            rec = mode.record()
    assert rec["collectives"]["counts"]["all-gather"] == 1
    assert rec["collectives"]["all-gather"] == m * n * 4
    assert rec["collective_bytes"] == m * n * 4
    assert set(rec["collectives"]) == set(janalysis._COLLECTIVES) | {
        "total_bytes", "counts"}


def test_affine_extrapolate_and_roofline():
    rng = np.random.default_rng(0)
    for _ in range(5):
        t2 = {k: float(v) for k, v in zip(
            ("flops", "bytes", "collective_bytes"), rng.uniform(1, 1e12, 3))}
        t4 = {k: v * float(rng.uniform(1.2, 2.5)) for k, v in t2.items()}
        for l_full in (2, 4, 16, 88):
            assert tanalysis.affine_extrapolate(t2, t4, l_full) == \
                janalysis.affine_extrapolate(t2, t4, l_full)
    terms = {"flops": 9.89e14, "bytes": 3.35e12 * 2,
             "collective_bytes": 5e10}
    r = tanalysis.roofline(terms, n_chips=256, model_flops=1e17)
    jr = janalysis.roofline(terms, n_chips=256, model_flops=1e17)
    assert set(r) == set(jr)
    assert r["t_compute_s"] == pytest.approx(1.0)
    assert r["t_memory_s"] == pytest.approx(2.0)
    assert r["t_collective_s"] == pytest.approx(1.0)
    assert r["dominant"] == "memory" and r["step_time_s"] == r["t_memory_s"]
    assert tanalysis._DTYPE_BYTES == janalysis._DTYPE_BYTES


@pytest.mark.parametrize("cell", CELLS)
def test_run_cell_report(reports, cell):
    recs, ref = reports
    rec, want = recs[cell], ref[cell]
    keys = set(REPORT_KEYS)
    lm = cell.startswith("olmo")
    if cell.endswith("decode_32k"):
        keys |= {"per_device_corrected", "cost_variants"}
    assert set(rec) == keys
    assert set(rec["memory"]) == MEMORY_KEYS
    assert set(rec["roofline"]) == set(janalysis.roofline(
        {"flops": 1.0, "bytes": 1.0, "collective_bytes": 1.0}, n_chips=1,
        model_flops=1.0))
    assert rec["n_chips"] == 256 and rec["mesh"] == "pod16x16"
    assert rec["kind"] == want["kind"]
    assert rec["model_flops"] == want["model_flops"]
    arg_bytes = sum(int(np.prod(leaf["single"])) * _DT_BYTES[leaf["dtype"]]
                    for leaf in want["leaves"].values())
    assert rec["memory"]["argument_size_in_bytes"] == arg_bytes
    assert rec["memory"]["output_size_in_bytes"] > 0
    assert rec["memory"]["temp_size_in_bytes"] > 0
    assert rec["per_device"]["flops"] > 0 and rec["per_device"]["bytes"] > 0
    counts = rec["collectives"]["counts"]
    if lm:
        # the model axis splits heads / d_head and the FSDP weights: the
        # contractions over it reduce, the weights gather
        assert counts["all-reduce"] > 0
        if cell.endswith("train_4k"):
            assert counts["all-gather"] > 0
        else:
            corr = rec["per_device_corrected"]["flops"]
            assert abs(rec["per_device"]["flops"] - corr) <= 1e-6 * corr
            assert set(rec["cost_variants"]) == {"2", "4"}
    if cell.startswith("gatedgcn"):
        # E 10556 and every weight's dims are indivisible by 16: the
        # reference's rule replicates every argument, so each device
        # runs the whole step and nothing moves
        assert all(leaf["single"] == leaf["shape"]
                   for leaf in want["leaves"].values())
        assert rec["per_device"]["collective_bytes"] == 0
    assert rec["collectives"]["total_bytes"] == \
        rec["per_device"]["collective_bytes"]


def test_multi_pod_traced_as_pod_data():
    """The dry-run traces the (2, 16, 16) mesh as its (32, 16) pod·data
    equivalent (``launch/mesh.traced_mesh``): every leaf shards alike on
    both, since DP names pod only beside data (one cell of each kind and
    family here; ``test_torch_cells.py`` holds every cell's shards)."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import (fake_world, make_production_mesh,
                                         traced_mesh)
    cells = [configs.get_arch(a).cell(s) for a, s in (
        ("olmo-1b", "train_4k"), ("granite-moe-1b-a400m", "long_500k"),
        ("gatedgcn", "molecule"), ("graphsage-reddit", "minibatch_lg"),
        ("mind", "retrieval_cand"), ("caloclusternet",
                                     "condensation_train"))]
    with fake_world(512):
        mesh = make_production_mesh(multi_pod=True)
        flat = traced_mesh(mesh)
        assert tuple(flat.shape) == (32, 16)
        assert flat.mesh_dim_names == ("data", "model")
        assert traced_mesh(flat) is flat
        for cell in cells:
            dryrun._check_pod(cell, mesh)
            args = cell.abstract_args()
            from test_torch_cells import _named
            a = dict(_named(args))
            on3 = dict(_named(cell.resolve_shardings(mesh)))
            on2 = dict(_named(cell.resolve_shardings(flat)))
            for path, sh in on3.items():
                assert sh.shard_shape(a[path].shape) == \
                    on2[path].shard_shape(a[path].shape), (cell.name, path)
