"""CaloClusterNet in the port against the JAX package's, on the CPU:
the eager forward against ``ccn.apply`` on the same weights and events
(float32 row), CPS on identical head tensors (decisions bitwise), the
IR export, and the weight hand-off.
"""
import jax
import numpy as np
import pytest
import torch
from _numerics import assert_bitwise, assert_close

from repro.configs.caloclusternet import smoke_config
from repro.core import caloclusternet as jccn
from repro.data.belle2 import Belle2Config, generate
from repro_torch.convert import from_jax_params
from repro_torch.core import caloclusternet as tccn


def _tcfg(jcfg):
    fields = {f: getattr(jcfg, f) for f in tccn.CCNConfig.__dataclass_fields__}
    return tccn.CCNConfig(**fields)


@pytest.fixture(scope="module")
def smoke():
    jcfg = smoke_config()
    params = jccn.init(jax.random.PRNGKey(5), jcfg)
    params_np = jax.tree_util.tree_map(np.asarray, params)
    tcfg = _tcfg(jcfg)
    gen = Belle2Config(n_crystals=576, grid=(24, 24), n_hits=jcfg.n_hits,
                       noise_rate=4.0)
    ev = generate(gen, 8, seed=2)
    return jcfg, params, tcfg, from_jax_params(params_np, tcfg,
                                                device="cpu"), ev


def test_forward_matches_apply(smoke):
    jcfg, params, tcfg, tparams, ev = smoke
    want = jccn.apply(params, ev["feats"], ev["mask"], jcfg)
    model = tccn.CaloClusterNet(tparams, tcfg)
    with torch.no_grad():
        got = model(torch.from_numpy(ev["feats"]),
                    torch.from_numpy(ev["mask"]))
    assert set(got) == set(want)
    for k in want:
        assert_close(got[k].numpy(), np.asarray(want[k]), dtype="float32",
                     context=k)


def _heads(seed, b=6, n=24, n_saturated=0):
    """Head tensors with a spread of β, clustered coordinates (so the
    t_dist test rejects some hits) and padded hits; ``n_saturated``
    logits per event are large enough that σ(β) is exactly 1.0, so
    their order among themselves comes from the sort's tie rule."""
    rng = np.random.default_rng(seed)
    logit = rng.normal(0.0, 2.0, size=(b, n)).astype(np.float32)
    for e in range(b):
        logit[e, rng.choice(n, n_saturated, replace=False)] = \
            rng.uniform(20.0, 60.0, size=n_saturated)
    centres = rng.uniform(-1.5, 1.5, size=(b, 4, 2))
    pick = rng.integers(0, 4, size=(b, n))
    coords = (centres[np.arange(b)[:, None], pick]
              + rng.normal(0, 0.2, size=(b, n, 2))).astype(np.float32)
    energy = rng.exponential(0.3, size=(b, n)).astype(np.float32)
    mask = np.ones((b, n), np.float32)
    for e in range(b):
        mask[e, rng.integers(n // 2, n + 1):] = 0.0
    return {"beta_logit": logit, "coords": coords, "energy": energy}, mask


@pytest.mark.parametrize("seed,n_saturated", [(0, 0), (1, 0), (2, 5),
                                              (3, 12)])
def test_cps_decisions_bitwise_on_identical_heads(seed, n_saturated):
    cfg_j = jccn.CCNConfig()
    heads, mask = _heads(seed, n_saturated=n_saturated)
    want = jax.tree_util.tree_map(np.asarray, jccn.cps(
        {k: jax.numpy.asarray(v) for k, v in heads.items()}, mask, cfg_j))
    got = tccn.cps({k: torch.from_numpy(v) for k, v in heads.items()},
                   torch.from_numpy(mask), _tcfg(cfg_j))
    got = {k: v.numpy() for k, v in got.items()}
    assert set(got) == set(want)
    for k in ("n_clusters", "trigger", "cluster_valid"):
        assert got[k].dtype == want[k].dtype, k
        assert_bitwise(got[k], want[k], context=k)
    for k in ("cluster_xy", "cluster_e", "cluster_beta"):
        assert_close(got[k], want[k], dtype="float32", context=k)
    # the draw exercises both rejection rules and the k_max cap
    assert (want["n_clusters"] > 0).any()


def test_cps_caps_at_k_max_and_respects_t_dist():
    heads, mask = _heads(4, n=64)
    heads["coords"] = np.random.default_rng(9).uniform(
        -20, 20, size=heads["coords"].shape).astype(np.float32)
    heads["beta_logit"][:] = 5.0
    mask[:] = 1.0
    cfg = tccn.CCNConfig()
    got = tccn.cps({k: torch.from_numpy(v) for k, v in heads.items()},
                   torch.from_numpy(mask), cfg)
    assert (got["n_clusters"] == cfg.k_max).all()
    xy = got["cluster_xy"]
    d2 = ((xy[:, :, None] - xy[:, None]) ** 2).sum(-1)
    off = ~torch.eye(cfg.k_max, dtype=torch.bool)
    assert (d2[:, off] > cfg.t_dist ** 2).all()


def test_to_graph_matches_reference(smoke):
    jcfg, params, tcfg, tparams, _ = smoke
    jg, tg = jccn.to_graph(params, jcfg), tccn.to_graph(tparams, tcfg)
    assert [(o.name, o.op_type, o.inputs, o.out_dim, o.attrs)
            for o in tg] == [(o.name, o.op_type, o.inputs, o.out_dim,
                              o.attrs) for o in jg]


def test_from_jax_params_checks_shapes(smoke):
    jcfg, params, tcfg, _, _ = smoke
    params_np = jax.tree_util.tree_map(np.asarray, params)
    bad = dict(params_np, enc2={"w": params_np["enc2"]["w"][:, :-1],
                                "b": params_np["enc2"]["b"]})
    with pytest.raises(ValueError, match="enc2/w"):
        from_jax_params(bad, tcfg, device="cpu")
    missing = {k: v for k, v in params_np.items() if k != "dec1"}
    with pytest.raises(ValueError, match="dec1"):
        from_jax_params(missing, tcfg, device="cpu")


def test_init_draws_from_the_generator():
    cfg = tccn.CCNConfig(n_hits=16)
    a = tccn.init(torch.Generator().manual_seed(0), cfg)
    b = tccn.init(torch.Generator().manual_seed(0), cfg)
    c = tccn.init(torch.Generator().manual_seed(1), cfg)
    assert all(torch.equal(a[n]["w"], b[n]["w"]) for n in a)
    assert not torch.equal(a["enc2"]["w"], c["enc2"]["w"])
    w = a["enc2"]["w"]
    assert w.shape == (cfg.d_hidden, cfg.d_hidden)
    assert w.abs().max() <= 2.0 / np.sqrt(cfg.d_hidden) + 1e-6
