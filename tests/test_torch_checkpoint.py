"""The port's checkpoints (``repro_torch/checkpoint/manager.py``) and
the JAX package's are one format: a checkpoint written by either
restores in the other bitwise, and the two packages write equal
manifests and equal leaf files for the same tree — CaloClusterNet's
parameters with its plain and q8-quantized AdamW state, GatedGCN's and
GraphSAGE's with theirs (the list paths ``layers/0/...``). The restore
path agrees with ``convert.from_jax_params`` / ``from_jax_adamw_state``
/ ``from_jax_gnn_params``. The reference's four checkpoint tests
(``tests/test_substrates.py``) in the port's terms: round trip and
atomicity, corruption detected, rotation with async writes, and the
mesh restore refused (it waits for the multi-device tools); and a
snapshot is unaffected by a write to the tensor right after ``save``.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jmgr
from repro.core import caloclusternet as jccn
from repro.models.gnn import gatedgcn as jgatedgcn
from repro.models.gnn import graphsage as jgraphsage
from repro.optim import adamw as jadamw
from repro_torch.checkpoint import CheckpointManager, latest_step
from repro_torch.checkpoint import manager as tmgr
from repro_torch.convert import (from_jax_adamw_state, from_jax_gnn_params,
                                 from_jax_params)
from repro_torch.core import caloclusternet as tccn
from repro_torch.models.gnn import gatedgcn, graphsage


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ccn_cfgs():
    kw = dict(n_hits=16, n_crystals=576, d_hidden=24, d_flr=8, d_s=3, k=4,
              d_decoder=12)
    return jccn.CCNConfig(**kw), tccn.CCNConfig(**kw)


def _trees(arch, quantize):
    """(the JAX package's {"p", "o"} after one AdamW step, the port's
    same tree through ``convert``)."""
    ocfg = jadamw.AdamWConfig(quantize_states=quantize)
    if arch == "caloclusternet":
        jcfg, tcfg = _ccn_cfgs()
        jp = jccn.init(jax.random.PRNGKey(3), jcfg)
    elif arch == "gatedgcn":
        kw = dict(n_layers=2, d_hidden=16, d_in=8, n_classes=3)
        jcfg, tcfg = (jgatedgcn.GatedGCNConfig(**kw),
                      gatedgcn.GatedGCNConfig(**kw))
        jp = jgatedgcn.init(jax.random.PRNGKey(3), jcfg)
    else:
        kw = dict(n_layers=2, d_hidden=16, d_in=8, n_classes=3)
        jcfg, tcfg = (jgraphsage.GraphSAGEConfig(**kw),
                      graphsage.GraphSAGEConfig(**kw))
        jp = jgraphsage.init(jax.random.PRNGKey(3), jcfg)
    grads = jax.tree_util.tree_map(
        lambda a: jnp.sin(jnp.arange(a.size, dtype=jnp.float32)
                          ).reshape(a.shape), jp)
    js = jadamw.adamw_init(jp, ocfg)
    jp, js, _ = jadamw.adamw_update(grads, js, jp, lr=1e-3, cfg=ocfg)
    jtree = {"p": jp, "o": js}
    if arch == "caloclusternet":
        ttree = {"p": from_jax_params(_np(jp), tcfg, device="cpu"),
                 "o": from_jax_adamw_state(_np(js), tcfg, device="cpu")}
    else:
        tp = from_jax_gnn_params(_np(jp), tcfg, device="cpu")
        to = {"m": from_jax_gnn_params(_np(js["m"]), tcfg, device="cpu"),
              "v": from_jax_gnn_params(_np(js["v"]), tcfg, device="cpu"),
              "step": torch.tensor(int(js["step"]), dtype=torch.int32)}
        ttree = {"p": tp, "o": to}
    return jtree, ttree


def _same_files(a, b):
    for d in (a, b):
        assert sorted(os.listdir(d)) == sorted(os.listdir(a))
    for name in os.listdir(a):
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name


def _assert_tree_bitwise(got, want):
    g, w = tmgr.flatten(got), tmgr.flatten(_np(want))
    assert [n for n, _ in g] == [n for n, _ in w]
    for (name, x), (_, y) in zip(g, w):
        x = np.asarray(x)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert x.tobytes() == y.tobytes(), name


CASES = [("caloclusternet", False), ("caloclusternet", True),
         ("gatedgcn", False), ("graphsage", False)]


@pytest.mark.parametrize("arch,quantize", CASES)
def test_jax_writes_port_reads(tmp_path, arch, quantize):
    """The reference's checkpoint restores in the port bitwise, and
    equals what ``convert`` makes of the same tree."""
    jtree, ttree = _trees(arch, quantize)
    jmgr.save(str(tmp_path), 5, jtree)
    like = jax.tree_util.tree_map(torch.zeros_like, ttree)
    got, step = tmgr.restore(str(tmp_path), 5, like)
    assert step == 5
    _assert_tree_bitwise(got, jtree)
    _assert_tree_bitwise(got, ttree)
    assert got["o"]["step"].dtype == torch.int32
    assert got["o"]["step"].shape == ()


@pytest.mark.parametrize("arch,quantize", CASES)
def test_port_writes_jax_reads(tmp_path, arch, quantize):
    """The port's checkpoint restores in the reference bitwise, and both
    packages write equal manifests and equal leaf files."""
    jtree, ttree = _trees(arch, quantize)
    tmgr.save(str(tmp_path / "port"), 5, ttree)
    jmgr.save(str(tmp_path / "jax"), 5, jtree)
    _same_files(str(tmp_path / "jax" / "step_00000005"),
                str(tmp_path / "port" / "step_00000005"))
    like = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), jtree)
    got, step = jmgr.restore(str(tmp_path / "port"), 5, like)
    assert step == 5
    _assert_tree_bitwise(_np(got), jtree)
    with open(tmp_path / "port" / "step_00000005" / "manifest.json") as f:
        manifest = json.load(f)
    paths = [e["path"] for e in manifest["leaves"]]
    assert "o/step" in paths
    if quantize:
        assert "o/m/enc1/w/q" in paths and "o/m/enc1/w/scale" in paths
    if arch != "caloclusternet":
        assert any(p.startswith("p/layers/0/") for p in paths)


def test_checkpoint_roundtrip_and_atomicity(tmp_path):
    tree = {"w": torch.arange(12.0).reshape(3, 4),
            "nested": {"b": torch.ones((5,), dtype=torch.int32)}}
    tmgr.save(str(tmp_path), 7, tree)
    like = {"w": np.zeros((3, 4), np.float32),
            "nested": {"b": np.zeros((5,), np.int32)}}
    out, step = tmgr.restore(str(tmp_path), 7, like, device="cpu")
    assert step == 7
    assert torch.equal(out["w"], tree["w"])
    assert torch.equal(out["nested"]["b"], tree["nested"]["b"])
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tmgr.restore(str(tmp_path), 7, like)   # None: the card


def test_checkpoint_corruption_detected(tmp_path):
    tree = {"w": torch.ones((4, 4))}
    tmgr.save(str(tmp_path), 1, tree)
    leaf = os.path.join(str(tmp_path), "step_00000001", "leaf_00000.npy")
    arr = np.load(leaf)
    arr[0, 0] = 123.0
    np.save(leaf, arr)
    with pytest.raises(IOError):
        tmgr.restore(str(tmp_path), 1, tree)


def test_checkpoint_of_another_tree_refused(tmp_path):
    tmgr.save(str(tmp_path), 1, {"w": torch.ones((4, 4))})
    with pytest.raises(ValueError, match="holds no leaf 'embed'"):
        tmgr.restore(str(tmp_path), 1, {"embed": np.zeros((4, 4)),
                                        "w": np.zeros((4, 4))},
                     device="cpu")


def test_checkpoint_manager_rotation_and_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_=True)
    tree = {"w": torch.ones((8,))}
    for s in (1, 2, 3, 4):
        mgr.save(s, {"w": tree["w"] * s})
    mgr.wait()
    mgr._gc()
    assert mgr.latest() == 4
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step"))
    assert len(steps) == 2
    out, _ = mgr.restore_latest(tree)
    assert torch.equal(out["w"], torch.full((8,), 4.0))


def test_checkpoint_mesh_restore_refused(tmp_path):
    """The reference's elastic restore onto a mesh, as
    ``tests/test_substrates.py`` holds it: saved replicated, restored
    with a spec (and with a ``NamedSharding``) onto a mesh of one (gloo),
    the bytes as saved; a leaf given no sharding comes back plain."""
    from torch.distributed.tensor import DTensor

    from repro_torch.dist.sharding import NamedSharding, P
    from repro_torch.launch.mesh import destroy_host_mesh, make_host_mesh
    tree = {"w": torch.arange(16.0).reshape(4, 4), "b": torch.ones(3)}
    tmgr.save(str(tmp_path), 3, tree)
    assert latest_step(str(tmp_path)) == 3
    mesh = make_host_mesh("cpu")
    try:
        for shw in (P("data", None), NamedSharding(mesh, P(None, "model"))):
            specs = {"w": shw, "b": None}
            out, step = tmgr.restore(str(tmp_path), 3, tree, mesh=mesh,
                                     shardings=specs)
            assert step == 3 and isinstance(out["w"], DTensor)
            assert out["w"].device_mesh is mesh
            assert torch.equal(out["w"].full_tensor(), tree["w"])
            assert not isinstance(out["b"], DTensor)
            assert torch.equal(out["b"], tree["b"])
            got, _ = CheckpointManager(str(tmp_path)).restore_latest(
                tree, mesh=mesh, shardings=specs)
            assert torch.equal(got["w"].to_local(), tree["w"])
        with pytest.raises(ValueError, match="needs a mesh"):
            tmgr.restore(str(tmp_path), 3, tree,
                         shardings={"w": P(None, None), "b": None})
    finally:
        destroy_host_mesh()


def test_snapshot_isolated_from_later_writes(tmp_path):
    """``save`` snapshots synchronously: a write to the tensor right
    after it (as the next step's copy into the step's buffers) does not
    reach the checkpoint, async or not."""
    for async_ in (True, False):
        w = torch.arange(6.0)
        mgr = CheckpointManager(str(tmp_path / str(async_)), async_=async_)
        mgr.save(1, {"w": w,
                     "o": {"step": torch.tensor(1, dtype=torch.int32)}})
        w.copy_(torch.full((6,), -1.0))
        mgr.wait()
        out, _ = mgr.restore_latest({"w": w, "o": {"step": torch.zeros(
            (), dtype=torch.int32)}})
        assert torch.equal(out["w"], torch.arange(6.0))
        assert int(out["o"]["step"]) == 1
