"""Every config's ``Cell`` in the port (``repro_torch/configs``) against
the JAX package's, on the CPU.

- ``all_cells()`` and ``all_cells(include_paper=True)`` give the
  reference's (arch, shape) in its order.
- Every cell's ``kind`` and ``model_flops`` (equal), and its abstract
  arguments leaf for leaf: path, shape, dtype, logical spec, and the
  local shard shape at the (16, 16) and (2, 16, 16) production meshes
  (the port's on a ``fake`` world, the reference's
  ``NamedSharding.shard_shape`` from ``tests/_ref_cells.py``, run once in
  its own process with 512 host devices).
- Each family's step on a world of one: ``test_torch_cell_steps.py``.
- One LM train step and two decode steps (the cache split on the batch,
  and on its positions), granite-moe's and MIND's train steps, the
  train steps of GatedGCN, DimeNet and NequIP with their edges split,
  and a mean over split edges, on a 4-rank gloo (2, 2) mesh against the
  same on plain tensors (``tests/_gloo_ranks.py lm``).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from _blas_threads import _blas_two_threads  # noqa: F401 (autouse)
from _numerics import assert_close
from test_torch_compress import run_ranks, start_ranks

from repro import configs as jconfigs
from repro_torch import configs as tconfigs
from repro_torch.configs.base import sds
from repro_torch.dist.sharding import NamedSharding, P
from repro_torch.launch.mesh import fake_world, make_production_mesh

REPO = Path(__file__).resolve().parent.parent


def _ref_cells_proc():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    return subprocess.Popen([sys.executable, str(REPO / "tests" /
                                                 "_ref_cells.py")],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


_REF_PROC = None
# the 4-rank gloo world of ``test_sharded_steps_on_four_gloo_ranks``,
# started beside the reference's process: (its output dir, its ranks)
_GLOO = None


def _named(tree, prefix=""):
    if isinstance(tree, (sds, P, NamedSharding)):
        return [(prefix[:-1], tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _named(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree)
                for x in _named(t, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def _spec(p):
    return [list(e) if isinstance(e, tuple) else e for e in p]


@pytest.fixture(scope="module")
def reference():
    """The reference's cells (``_ref_cells.py``), started before the
    port's records are made."""
    global _REF_PROC
    proc = _REF_PROC or _ref_cells_proc()
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Per cell: kind, model_flops and each leaf's [shape, dtype, spec,
    shard shape (16, 16), shard shape (2, 16, 16)]."""
    global _REF_PROC, _GLOO
    _REF_PROC = _REF_PROC or _ref_cells_proc()
    if _GLOO is None:
        out = tmp_path_factory.mktemp("gloo")
        _GLOO = (out, start_ranks("lm", out))
    cells = [(a, s, m.cell(s))
             for a, s, m in tconfigs.all_cells(include_paper=True)]
    recs = {}
    for a, s, c in cells:
        args = _named(c.abstract_args())
        specs = dict(_named(c.spec_args()))
        recs[(a, s)] = {"kind": c.kind, "model_flops": c.model_flops,
                        "leaves": {p: [list(x.shape),
                                       str(x.dtype).replace("torch.", ""),
                                       _spec(specs[p])]
                                   for p, x in args}}
    for size, multi in ((256, False), (512, True)):
        with fake_world(size):
            mesh = make_production_mesh(multi_pod=multi)
            for a, s, c in cells:
                args = dict(_named(c.abstract_args()))
                for p, sh in _named(c.resolve_shardings(mesh)):
                    recs[(a, s)]["leaves"][p].append(
                        list(sh.shard_shape(args[p].shape)))
    return recs


@pytest.mark.parametrize("paper", [False, True])
def test_all_cells_in_the_reference_order(paper):
    got = [(a, s) for a, s, _ in tconfigs.all_cells(include_paper=paper)]
    want = [(a, s) for a, s, _ in jconfigs.all_cells(include_paper=paper)]
    assert got == want
    assert len(got) == (43 if paper else 40)


_CELLS = [(a, s) for a, s, _ in jconfigs.all_cells(include_paper=True)]


@pytest.mark.parametrize("arch,shape", _CELLS,
                         ids=[f"{a}:{s}" for a, s in _CELLS])
def test_cell_matches_reference(port, reference, arch, shape):
    ref = next(r for r in reference
               if (r["arch"], r["shape"]) == (arch, shape))
    got = port[(arch, shape)]
    assert got["kind"] == ref["kind"]
    assert got["model_flops"] == ref["model_flops"]
    assert sorted(got["leaves"]) == sorted(ref["leaves"])
    for path, leaf in ref["leaves"].items():
        want = [leaf["shape"], leaf["dtype"], leaf["spec"], leaf["single"],
                leaf["multi"]]
        assert got["leaves"][path] == want, path


def test_sharded_steps_on_four_gloo_ranks(tmp_path):
    """olmo-1b's smoke train and decode steps on a (2, 2) mesh (kv heads
    sharded, FSDP weights, the vocabulary split for the embedding and
    the loss; the decode's cache split on the batch, and on its
    positions for long_500k), granite-moe-1b-a400m's smoke train step
    (the MoE dispatch under the mesh), MIND's smoke train step (its
    tables split over the model axis), GatedGCN's, DimeNet's and
    NequIP's smoke train steps with their edges split over dp, and
    ``edge_aggregate``'s mean over split edges with fractional masks,
    against the same on plain tensors."""
    out, procs = _GLOO or (tmp_path, None)
    run_ranks("lm", out, procs=procs)
    d = np.load(out / "lm.npz")
    got = sorted(k for k in d if "/got/" in k)
    assert len(got) > 30 and {k.split("/")[0] for k in got} == {
        "train", "decode", "long", "gnn", "moe", "mind", "mean", "dimenet",
        "nequip"}
    for k in got:
        want = d[k.replace("/got/", "/want/")]
        if np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(d[k], want, err_msg=k)
        else:
            assert_close(d[k], want, dtype="float32", context=k)
