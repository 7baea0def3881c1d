"""CaloClusterNet's ``gravnet_impl`` and ``compute_dtype`` options in the
port against the JAX package's, on the CPU, at the smoke config.

The four forwards of ``apply``, (topk, onehot) × (f32, bf16), on the
same converted weights and events: the heads within the float32 row
(bf16: the bfloat16 row), CPS's integer outputs bitwise under f32; the
condensation loss and its gradient in every parameter likewise; the
trigger cell's ``model_flops`` under each option equal to the JAX
package's ``_serve_cell``'s (read from ``repro.configs.caloclusternet``,
not from the JAX hill-climb, which sets ``XLA_FLAGS`` at import).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _numerics import assert_bitwise, assert_close

import repro.configs.caloclusternet as jccncfg
import repro_torch.configs.caloclusternet as tccncfg
from repro.core import caloclusternet as jccn
from repro.core.condensation import condensation_loss as jloss
from repro.data.belle2 import Belle2Config, generate
from repro_torch.convert import from_jax_params
from repro_torch.core import caloclusternet as tccn
from repro_torch.core.condensation import condensation_loss as tloss
from repro_torch.kernels import ref as tref

OPTIONS = [(impl, dt) for impl in ("topk", "onehot") for dt in ("f32",
                                                                "bf16")]
LABELS = ("object_id", "energy", "cls")


def _row(dt):
    return "bfloat16" if dt == "bf16" else "float32"


@pytest.fixture(scope="module")
def smoke():
    jcfg = jccncfg.smoke_config()
    params = jccn.init(jax.random.PRNGKey(7), jcfg)
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                              tccncfg.smoke_config(), device="cpu")
    gen = Belle2Config(n_crystals=576, grid=(24, 24), n_hits=jcfg.n_hits,
                       noise_rate=4.0)
    return jcfg, params, tparams, generate(gen, 8, seed=4)


def _cfgs(jcfg, impl, dt):
    over = dict(gravnet_impl=impl, compute_dtype=dt)
    return (dataclasses.replace(jcfg, **over),
            dataclasses.replace(tccncfg.smoke_config(), **over))


@pytest.mark.parametrize("impl,dt", OPTIONS)
def test_forward_options_match_reference(smoke, impl, dt):
    jcfg0, params, tparams, ev = smoke
    jcfg, tcfg = _cfgs(jcfg0, impl, dt)
    want = jax.jit(lambda p, x, m: jccn.apply(p, x, m, jcfg))(
        params, ev["feats"], ev["mask"])
    feats, mask = torch.from_numpy(ev["feats"]), torch.from_numpy(ev["mask"])
    got = tccn.apply(tparams, feats, mask, tcfg)
    assert set(got) == set(want)
    for k in want:
        assert str(got[k].dtype)[6:] == str(want[k].dtype), k
        assert_close(got[k].float().numpy(),
                     np.asarray(want[k], np.float32), dtype=_row(dt),
                     context=k)
    if dt == "f32":
        jc = jax.tree_util.tree_map(np.asarray,
                                    jccn.cps(want, ev["mask"], jcfg))
        tc = tccn.cps(got, mask, tcfg)
        for k in ("n_clusters", "trigger", "cluster_valid"):
            assert_bitwise(tc[k].numpy(), jc[k], context=k)


@pytest.mark.parametrize("impl,dt", OPTIONS)
def test_loss_gradient_options_match_reference(smoke, impl, dt):
    """The condensation loss on the option's forward and its gradient
    in every weight and bias."""
    jcfg0, params, tparams, ev = smoke
    jcfg, tcfg = _cfgs(jcfg0, impl, dt)
    jlab = {k: jnp.asarray(ev[k]) for k in LABELS}

    def jl(p):
        out = jccn.apply(p, ev["feats"], ev["mask"], jcfg)
        out = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), out)
        return jloss(out, jlab, jnp.asarray(ev["mask"]),
                     k_max=jcfg.k_max)[0]
    want_loss, want = jax.jit(jax.value_and_grad(jl))(params)
    leaves = {n: {k: t.clone().requires_grad_(True) for k, t in p.items()}
              for n, p in tparams.items()}
    mask = torch.from_numpy(ev["mask"])
    out = tccn.apply(leaves, torch.from_numpy(ev["feats"]), mask, tcfg)
    out = {k: v.float() for k, v in out.items()}
    loss, _ = tloss(out, {k: torch.from_numpy(ev[k]) for k in LABELS},
                    mask, k_max=tcfg.k_max)
    flat = [(n, k, t) for n, p in leaves.items() for k, t in p.items()]
    grads = torch.autograd.grad(loss, [t for *_, t in flat])
    assert_close(loss.item(), float(want_loss), dtype=_row(dt))
    for (n, k, _), g in zip(flat, grads):
        w = np.asarray(want[n][k], np.float32)
        assert g.shape == w.shape
        assert_close(g.float().numpy(), w, dtype=_row(dt),
                     context=f"{n}/{k}")


def test_topk_oracle_matches_reference():
    """``gravnet_aggregate_topk_ref`` against the JAX package's top-k +
    gather oracle per event, fewer valid rows than k and k past n
    included (slots padded with d2 = 1e30, index 0), and the port's
    top-k on exact ties: the lowest column first, as ``lax.top_k``."""
    from repro.kernels import ref as jref
    rng = np.random.default_rng(0)
    for b, n, ds, df, k, nv in ((3, 20, 3, 5, 4, 20), (2, 12, 2, 4, 8, 5),
                                (2, 3, 2, 3, 6, 3)):
        s = np.round(rng.normal(size=(b, n, ds)) * 4) / 4   # ties
        f = rng.normal(size=(b, n, df))
        mask = np.ones((b, n))
        mask[:, nv:] = 0
        s, f, mask = (a.astype(np.float32) for a in (s, f, mask))
        want = np.stack([np.asarray(jref.gravnet_aggregate_ref(
            s[i], f[i], mask[i], k=k)) for i in range(b)])
        got = tref.gravnet_aggregate_topk_ref(
            torch.from_numpy(s), torch.from_numpy(f),
            torch.from_numpy(mask), k=k)
        assert got.shape == want.shape
        assert_close(got.numpy(), want, dtype="float32")
    # every distance equal: each row's lowest other columns, in order
    _, idx = tref.knn_topk_ref(torch.zeros(1, 5, 1), torch.ones(1, 5),
                               k=4)
    assert idx[0, 0].tolist() == [1, 2, 3, 4]
    assert idx[0, 4].tolist() == [0, 1, 2, 3]


@pytest.mark.parametrize("impl,dt", OPTIONS)
def test_trigger_cells_model_flops_match_reference(impl, dt):
    """The hill-climb's C cells (``launch/hillclimb._ccn_variant``):
    trigger_serve at 4096 events under the options, with the JAX
    package's ``model_flops``; the options change no FLOP count."""
    from repro_torch.launch import hillclimb
    over = dict(gravnet_impl=impl, compute_dtype=dt)
    want = jccncfg._serve_cell(dataclasses.replace(
        jccncfg.full_config("upgrade"), **over), "trigger_serve", 4096)
    got = hillclimb._ccn_variant(tccncfg, **over)
    assert got.model_flops == want.model_flops
    assert (got.arch, got.shape, got.kind) == (want.arch, want.shape,
                                               want.kind)


def test_unknown_options_raise(smoke):
    jcfg0, _, tparams, ev = smoke
    feats, mask = torch.from_numpy(ev["feats"]), torch.from_numpy(ev["mask"])
    for over in (dict(gravnet_impl="scan"), dict(compute_dtype="f16")):
        cfg = dataclasses.replace(tccncfg.smoke_config(), **over)
        with pytest.raises(ValueError, match=next(iter(over.values()))):
            tccn.apply(tparams, feats, mask, cfg)
