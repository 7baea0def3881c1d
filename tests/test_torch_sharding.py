"""The port's logical sharding (``repro_torch/dist/sharding.py``) and the
optimizer's specs against the JAX package's, on the CPU.

- ``PARAM_RULES`` of every model equal the reference's, as tuples;
  ``logical_to_physical`` equals the reference's for every spec in every
  ``PARAM_RULES``, feed spec and cache spec, on the axis names of the
  host, single-pod and multi-pod meshes.
- ``specs_from_rules`` on each arch's full parameter tree (the
  reference's from ``jax.eval_shape``), leaf for leaf.
- ``opt_state_specs`` with and without q8 moments.
- ``NamedSharding``'s placements and shard shapes, ``constrain``,
  ``einsum`` and ``reshape`` on DTensors of a fake world's mesh.
"""
from types import SimpleNamespace

import jax
import pytest
import torch
from _blas_threads import _blas_two_threads  # noqa: F401 (autouse)
from jax.sharding import PartitionSpec as JP

from repro import configs as jconfigs
from repro.dist import sharding as jsh
from repro.models import recsys as jrec
from repro.models import transformer as jtr
from repro.models.gnn import dimenet as jdim
from repro.models.gnn import gatedgcn as jgg
from repro.models.gnn import graphsage as jgs
from repro.models.gnn import nequip as jnq
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim.adamw import opt_state_specs as jopt_state_specs
from repro_torch import configs as tconfigs
from repro_torch.dist import sharding as tsh
from repro_torch.models import recsys as trec
from repro_torch.models import transformer as ttr
from repro_torch.models.gnn import dimenet as tdim
from repro_torch.models.gnn import gatedgcn as tgg
from repro_torch.models.gnn import graphsage as tgs
from repro_torch.models.gnn import nequip as tnq
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import opt_state_specs

MESH_AXES = {"host": ("data", "model"), "single": ("data", "model"),
             "multi": ("pod", "data", "model")}
RULES = {
    "transformer": (ttr.PARAM_RULES, jtr.PARAM_RULES),
    "recsys": (trec.PARAM_RULES, jrec.PARAM_RULES),
    "gatedgcn": (tgg.PARAM_RULES, jgg.PARAM_RULES),
    "graphsage": (tgs.PARAM_RULES, jgs.PARAM_RULES),
    "dimenet": (tdim.PARAM_RULES, jdim.PARAM_RULES),
    "nequip": (tnq.PARAM_RULES, jnq.PARAM_RULES),
    "caloclusternet": (tconfigs.get_arch("caloclusternet").PARAM_RULES,
                       jconfigs.get_arch("caloclusternet").PARAM_RULES),
}


def _t(spec):
    return tuple(spec)


def _extra_specs():
    """Feed and cache specs the cells use, beyond PARAM_RULES."""
    from repro.configs import caloclusternet as jccn
    from repro.configs import gnn_common as jg
    out = [JP(jsh.DP, None), JP(jsh.DP), JP(None, jsh.DP), JP(),
           JP(None, None), JP(None, jsh.DP, None, None, jsh.TP),
           JP(None, None, jsh.DP, None, jsh.TP),
           JP(None, jsh.DP, None, None), JP(None, None, jsh.DP, None),
           JP((jsh.DP, jsh.TP), None), JP(("pod", jsh.TP), "model"),
           JP(jsh.DP, None, jsh.TP), JP(jsh.DP, None, None, jsh.TP, None)]
    for seq_shard in (False, True):
        cfg = jconfigs.get_arch("olmo-1b").smoke_config()
        out += list(jtr.cache_specs(cfg, seq_shard=seq_shard).values())
    meta = jg.SHAPES["full_graph_sm"]
    g = jg.graph_sds(meta, geometric=True, triplets=True)
    out += list(jg.graph_specs(g, edge_dp=True).values())
    out += list(jg.graph_specs(g, batch=True).values())
    out += list(jccn._feed_specs(jccn._feeds(jccn.full_config(), 8,
                                             train=True)).values())
    return out


@pytest.mark.parametrize("model", sorted(RULES))
def test_param_rules_match_reference(model):
    port, ref = RULES[model]
    assert [(p, _t(s)) for p, s in port] == [(p, _t(s)) for p, s in ref]
    assert all(isinstance(s, tsh.P) for _, s in port)


@pytest.mark.parametrize("mesh", sorted(MESH_AXES))
def test_logical_to_physical_matches_reference(mesh):
    names = MESH_AXES[mesh]
    tmesh = SimpleNamespace(mesh_dim_names=names)
    jmesh = SimpleNamespace(axis_names=names)
    specs = [s for _, ref in RULES.values() for _, s in ref]
    specs += _extra_specs()
    assert len(specs) > 40
    for spec in specs:
        got = tsh.logical_to_physical(tsh.P(*spec), tmesh)
        assert isinstance(got, tsh.P)
        assert _t(got) == _t(jsh.logical_to_physical(spec, jmesh)), spec
    assert tsh.logical_to_physical(tsh.P(tsh.DP, tsh.TP), None) == \
        (None, None)


def _ref_params(arch):
    """The reference's full parameter tree (ShapeDtypeStructs)."""
    mod = jconfigs.get_arch(arch)
    if mod.FAMILY == "lm":
        return jtr.abstract_params(mod.full_config())
    if arch == "mind":
        return jax.eval_shape(lambda: jrec.init(jax.random.PRNGKey(0),
                                                mod.full_config()))
    if arch == "caloclusternet":
        from repro.core import caloclusternet as jccn
        return jax.eval_shape(lambda: jccn.init(jax.random.PRNGKey(0),
                                                mod.full_config()))
    model = {"gatedgcn": jgg, "graphsage-reddit": jgs, "dimenet": jdim,
             "nequip": jnq}[arch]
    return jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                             mod.full_config()))


def _port_params(arch):
    mod = tconfigs.get_arch(arch)
    if mod.FAMILY == "lm":
        from repro_torch.configs import lm_common
        return lm_common.abstract_params(mod.full_config()), ttr.PARAM_RULES
    if arch == "mind":
        return mod.abstract_params(mod.full_config()), trec.PARAM_RULES
    if arch == "caloclusternet":
        return mod._params(mod.full_config()), mod.PARAM_RULES
    from repro_torch.configs import gnn_common as G
    model = {"gatedgcn": tgg, "graphsage-reddit": tgs, "dimenet": tdim,
             "nequip": tnq}[arch]
    return G.abstract_params(model, mod.full_config()), model.PARAM_RULES


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _named(tree[k],
                                                        f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [x for i, t in enumerate(tree)
                for x in _named(t, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def _ref_named_specs(params, rules):
    specs = jsh.specs_from_rules(params, rules)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, JP))[0]
    return {jsh._path_str(p): _t(s) for p, s in flat}


@pytest.mark.parametrize("arch", list(jconfigs._MODULES))
def test_specs_from_rules_matches_reference(arch):
    ref_params = _ref_params(arch)
    rules = dict(RULES)
    ref_rules = {"mind": jrec.PARAM_RULES,
                 "caloclusternet": rules["caloclusternet"][1],
                 "gatedgcn": jgg.PARAM_RULES,
                 "graphsage-reddit": jgs.PARAM_RULES,
                 "dimenet": jdim.PARAM_RULES,
                 "nequip": jnq.PARAM_RULES}.get(arch, jtr.PARAM_RULES)
    want = _ref_named_specs(ref_params, ref_rules)
    params, port_rules = _port_params(arch)
    got = {p: _t(s) for p, s in _named(tsh.specs_from_rules(params,
                                                            port_rules))}
    assert got == want
    # a leaf given as a bare shape tuple is a leaf too
    shapes = tsh.map_leaves(lambda x: tuple(x.shape), params,
                            is_leaf=lambda x: hasattr(x, "shape"))
    assert {p: _t(s) for p, s in _named(tsh.specs_from_rules(
        shapes, port_rules))} == want


@pytest.mark.parametrize("quantize", [False, True])
def test_opt_state_specs_match_reference(quantize):
    cfg = jconfigs.get_arch("granite-moe-1b-a400m").full_config()
    jspecs = jsh.specs_from_rules(jtr.abstract_params(cfg), jtr.PARAM_RULES)
    want = jopt_state_specs(jspecs, JAdamWConfig(quantize_states=quantize))
    from repro_torch.configs import lm_common
    tcfg = tconfigs.get_arch("granite-moe-1b-a400m").full_config()
    tspecs = tsh.specs_from_rules(lm_common.abstract_params(tcfg),
                                  ttr.PARAM_RULES)
    got = opt_state_specs(tspecs, AdamWConfig(quantize_states=quantize))
    flat = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, JP))[0]
    assert {p: _t(s) for p, s in _named(got)} == \
        {jsh._path_str(p): _t(s) for p, s in flat}
    assert got["step"] == () and isinstance(got["step"], tsh.P)


def test_named_sharding_on_a_fake_mesh():
    """Placements: Shard(d) on each mesh dim of extent > 1 that d maps
    to, major first; shard shapes; and the helpers on DTensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard, distribute_tensor)
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.mesh import fake_world, make_production_mesh
    with fake_world(512):
        mesh = make_production_mesh(multi_pod=True)
        sh = tsh.NamedSharding(mesh, tsh.logical_to_physical(
            tsh.P(tsh.DP, None, tsh.TP), mesh))
        assert sh.spec == (("pod", "data"), None, "model")
        assert sh.placements == (Shard(0), Shard(0), Shard(2))
        assert sh.shard_shape((64, 3, 32)) == (2, 3, 2)
        with FakeTensorMode(), implicit_replication():
            x = distribute_tensor(torch.empty(64, 8, 32), mesh, sh.placements)
            assert x.to_local().shape == (2, 8, 2)
            y = tsh.constrain(x, mesh, tsh.DP, None, None)
            assert y.placements == (Shard(0), Shard(0), Replicate())
            assert tsh.constrain(x, None, tsh.DP) is x
            w = distribute_tensor(torch.empty(32, 16), mesh,
                                  [Replicate(), Replicate(), Shard(0)])
            z = tsh.einsum("bsd,de->bse", x, w)
            # the model axis shards the contracted d: a partial sum
            assert z.placements == (Shard(0), Shard(0), Partial())
            r = tsh.reshape(x, 64, 8, 16, 2)       # 16 heads: stays sharded
            assert r.placements[2] == Shard(2)
            r = tsh.reshape(x, 64, 8, 4, 8)        # 4 heads over 16: gathered
            assert r.placements[2] == Replicate()
            assert isinstance(r, DTensor)
    host = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(1, 1))
    one = tsh.NamedSharding(host, tsh.P("data", "model"))
    assert one.placements == (Replicate(), Replicate())


def test_einsum_plain_tensors_is_torch_einsum():
    g = torch.Generator().manual_seed(0)
    a = torch.randn(3, 4, 5, generator=g)
    b = torch.randn(5, 6, generator=g)
    assert torch.equal(tsh.einsum("...d,de->...e", a, b),
                       torch.einsum("...d,de->...e", a, b))
    assert torch.equal(tsh.reshape(a, 12, 5), a.reshape(12, 5))
