"""The port's LM transformer (``repro_torch/models/transformer.py``)
against the JAX package's on the CPU, at smoke widths, from the
reference's ``init_params`` carried across by
``convert.from_jax_lm_params`` and tokens from numpy seeds.

Tolerances (``tests/_numerics.py``): the ``float32`` row for f32
compute, the ``bfloat16`` row for bf16 compute; bitwise for integers
(the MoE's routing indices). The int8 KV cache: the scales within the
float32 row, every int8 entry bitwise except a flip by one where the
reference's quotient k/scale lies within ``HALF_TOL`` of a half-integer
(the two packages' float32 k, a few ulps apart, may round to either
side there); the test counts those flips.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _numerics import assert_bitwise, assert_close

from repro.models import transformer as jtr
from repro_torch import convert
from repro_torch.models import transformer as ttr
from repro_torch.nn.layers import top_k

HALF_TOL = 1e-3
#: the reference's decode step compiled once per config (called
#: unjitted, its layer scan would be traced and compiled every step)
_jdecode = jax.jit(jtr.decode_step, static_argnums=3)
_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads in this module (and in the LM, MIND and
    driver test modules that import it): the suite runs six workers on
    the host's cores, and torch's default of one thread per core then
    stalls every small op at its barrier."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _cfgs(compute="float32", moe=None, **kw):
    """The same config in both packages."""
    base = dict(name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                d_ff=96, vocab=97, block_q=8, loss_chunk=8, rope_theta=1e4)
    base.update(kw)
    jdt, tdt = _DT[compute]
    jm = tm = None
    if moe is not None:
        jm, tm = jtr.MoEConfig(**moe), ttr.MoEConfig(**moe)
    return (jtr.TransformerConfig(**base, compute_dtype=jdt, moe=jm),
            ttr.TransformerConfig(**base, compute_dtype=tdt, moe=tm))


def _params(jcfg, tcfg, seed=0):
    jp = jtr.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = convert.from_jax_lm_params(jax.tree_util.tree_map(np.asarray, jp),
                                    tcfg, device="cpu")
    return jp, tp


def _tokens(vocab, b=2, s=32, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)
                                                ).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _leaves(tree):
    if isinstance(tree, dict):
        return [(f"{k}/{n}".strip("/"), v) for k in sorted(tree)
                for n, v in _leaves(tree[k])]
    return [("", tree)]


MOE_CASES = {
    "einsum_top2": dict(n_experts=4, top_k=2, group_size=16),
    "scatter_top2": dict(n_experts=4, top_k=2, group_size=16,
                         dispatch="scatter"),
    "einsum_top1_shared": dict(n_experts=8, top_k=1, group_size=16,
                               shared_experts=1),
    "scatter_top8": dict(n_experts=16, top_k=8, group_size=32,
                         dispatch="scatter"),
    "einsum_top8_drops": dict(n_experts=16, top_k=8, group_size=32,
                              capacity_factor=0.25),
    "scatter_top1_drops": dict(n_experts=2, top_k=1, group_size=32,
                               capacity_factor=0.25, dispatch="scatter"),
}

FORWARD_CASES = {
    "gqa_silu_gated_scan": dict(),
    "full": dict(attn_mode="full"),
    "unrolled_tri": dict(attn_mode="unrolled_tri"),
    "unroll_layers": dict(unroll_layers=True),
    "olmo_nonparametric": dict(norm="nonparametric", gated_mlp=False,
                               n_kv_heads=4),
    "mqa_gelu_plain": dict(n_kv_heads=1, gated_mlp=False,
                           activation="gelu"),
    "relu": dict(activation="relu"),
    "moe_einsum": dict(moe=MOE_CASES["einsum_top2"], d_ff=32),
    "moe_scatter_shared": dict(moe=dict(MOE_CASES["scatter_top2"],
                                        shared_experts=1), d_ff=32),
}


@pytest.mark.parametrize("case", FORWARD_CASES)
def test_forward(case):
    """forward (hidden states and aux) in every attention mode, with the
    layers unrolled, both norms, every activation, dense and MoE."""
    jcfg, tcfg = _cfgs(**FORWARD_CASES[case])
    jp, tp = _params(jcfg, tcfg)
    toks = _tokens(jcfg.vocab)
    jx, jaux = jtr.forward(jp, jnp.asarray(toks), jcfg)
    tx, taux = ttr.forward(tp, _t(toks), tcfg)
    assert tx.dtype == torch.float32
    assert_close(_np(tx), np.asarray(jx), dtype="float32", context=case)
    assert_close(_np(taux), np.asarray(jaux), dtype="float32", context=case)


def test_activations_and_norms():
    """gelu is the tanh approximation (``jax.nn.gelu``'s default); the
    norms compute in f32 and cast back, with population variances."""
    from repro.nn import layers as jl
    from repro_torch.nn import layers as tl
    x = np.random.default_rng(3).normal(size=(4, 33)).astype(np.float32)
    for name in ("silu", "gelu", "relu"):
        jcfg, tcfg = _cfgs(activation=name)
        assert_close(_np(ttr._act(tcfg)(_t(x))),
                     np.asarray(jtr._act(jcfg)(jnp.asarray(x))),
                     dtype="float32", context=name)
    assert float(ttr._act(_cfgs(activation="gelu")[1])(
        torch.tensor(1.0))) == pytest.approx(0.841192, abs=1e-6)
    scale = np.linspace(0.5, 1.5, 33).astype(np.float32)
    bias = np.linspace(-1, 1, 33).astype(np.float32)
    for dt in ("float32", "bfloat16"):
        jdt, tdt = _DT[dt]
        xj, xt = jnp.asarray(x, jdt), _t(x).to(tdt)
        got = tl.rmsnorm_apply({"scale": _t(scale)}, xt)
        assert got.dtype == tdt
        assert_close(_np(got), np.asarray(jl.rmsnorm_apply(
            {"scale": jnp.asarray(scale)}, xj), np.float32), dtype=dt)
        assert_close(_np(tl.nonparametric_layernorm(xt)), np.asarray(
            jl.nonparametric_layernorm(xj), np.float32), dtype=dt)
    assert_close(_np(tl.layernorm_apply({"scale": _t(scale),
                                         "bias": _t(bias)}, _t(x))),
                 np.asarray(jl.layernorm_apply(
                     {"scale": jnp.asarray(scale),
                      "bias": jnp.asarray(bias)}, jnp.asarray(x))),
                 dtype="float32")


@pytest.mark.parametrize("case", ["dense", "moe_einsum", "moe_scatter"])
def test_loss_and_gradients(case):
    """loss_fn's loss, ce and aux, and the gradient of every leaf."""
    kw = {"dense": {},
          "moe_einsum": dict(moe=MOE_CASES["einsum_top1_shared"], d_ff=32),
          "moe_scatter": dict(moe=MOE_CASES["scatter_top2"], d_ff=32)}[case]
    jcfg, tcfg = _cfgs(**kw)
    jp, tp = _params(jcfg, tcfg, seed=2)
    toks = _tokens(jcfg.vocab, s=16, seed=4)
    labels = np.roll(toks, -1, 1)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    (jl, jm), jg = jax.value_and_grad(jtr.loss_fn, has_aux=True)(
        jp, jb, jcfg)
    from repro_torch.optim.step import value_and_grad
    tb = {"tokens": _t(toks), "labels": _t(labels)}
    (tl, tm), tg = value_and_grad(lambda p: ttr.loss_fn(p, tb, tcfg), tp)
    assert_close(_np(tl), np.asarray(jl), dtype="float32")
    for key in ("ce", "aux"):
        assert_close(_np(tm[key]), np.asarray(jm[key]), dtype="float32",
                     context=key)
    if kw:
        assert float(tm["aux"]) > 0
    jleaves = dict(_leaves(jax.tree_util.tree_map(np.asarray, jg)))
    for name, g in _leaves(tg):
        assert_close(_np(g), jleaves[name], dtype="float32", context=name)


def test_remat_policies_and_no_remat_agree():
    """remat (full or dots) recomputes; its gradients equal no remat's
    bitwise (the same ops in the same order)."""
    from repro_torch.optim.step import value_and_grad
    toks = _tokens(97, s=16, seed=5)
    tb = {"tokens": _t(toks), "labels": _t(np.roll(toks, -1, 1))}
    out = []
    for kw in (dict(remat=False), dict(remat=True),
               dict(remat=True, remat_policy="dots")):
        _, tcfg = _cfgs(**kw)
        _, tp = _params(*_cfgs(), seed=6)
        out.append(value_and_grad(lambda p: ttr.loss_fn(p, tb, tcfg), tp))
    for (l_, _), g in out[1:]:
        assert_bitwise(_np(l_), _np(out[0][0][0]))
        for (n, a), (_, b) in zip(_leaves(g), _leaves(out[0][1])):
            assert_bitwise(_np(a), _np(b), context=n)


@pytest.fixture(scope="module")
def decode_setup():
    jcfg, tcfg = _cfgs(n_layers=2)
    jp, tp = _params(jcfg, tcfg, seed=7)
    return jcfg, tcfg, jp, tp, _tokens(jcfg.vocab, s=16, seed=8)


def test_prefill_logits_and_cache(decode_setup):
    jcfg, tcfg, jp, tp, toks = decode_setup
    jl, jc = jtr.prefill(jp, jnp.asarray(toks), jcfg)
    tl, tc = ttr.prefill(tp, _t(toks), tcfg)
    assert_close(_np(tl), np.asarray(jl), dtype="float32")
    for key in ("k", "v"):
        assert tuple(tc[key].shape) == jc[key].shape
        assert_close(_np(tc[key]), np.asarray(jc[key]), dtype="float32",
                     context=key)
    assert_bitwise(tc["pos"].numpy(), np.asarray(jc["pos"]))


def _decode_both(jcfg, tcfg, jp, tp, toks, max_len, steps=None):
    """Decode the tokens one at a time from an empty cache in both
    packages; every step's logits and the final caches."""
    b, s = toks.shape
    jc = jtr.init_cache(jcfg, b, max_len, dtype=jcfg.compute_dtype)
    tc = ttr.init_cache(tcfg, b, max_len, device="cpu")
    logits = []
    for t in range(steps or s):
        tok = toks[:, t % s:t % s + 1]
        jl, jc = _jdecode(jp, jc, jnp.asarray(tok), jcfg)
        tl, tc = ttr.decode_step(tp, tc, _t(tok), tcfg)
        logits.append((tl, jl))
    return logits, tc, jc


def test_decode_incremental(decode_setup):
    """decode_step token by token against the reference (f32 cache),
    and the cache given to a step left as it was."""
    jcfg, tcfg, jp, tp, toks = decode_setup
    logits, tc, jc = _decode_both(jcfg, tcfg, jp, tp, toks, 20)
    for i, (tl, jl) in enumerate(logits):
        assert_close(_np(tl), np.asarray(jl), dtype="float32",
                     context=f"step {i}")
    for key in ("k", "v"):
        assert_close(_np(tc[key]), np.asarray(jc[key]), dtype="float32")
    assert_bitwise(tc["pos"].numpy(), np.asarray(jc["pos"]))
    empty = ttr.init_cache(tcfg, 2, 16, device="cpu")
    ttr.decode_step(tp, empty, _t(toks[:, :1]), tcfg)
    assert not empty["k"].any() and not empty["pos"].any()


def test_decode_update_clamped_past_max_len(decode_setup):
    """Past max_len the update lands on the last row (the reference's
    ``dynamic_update_slice`` clamps its start), the position keeps
    counting."""
    jcfg, tcfg, jp, tp, toks = decode_setup
    logits, tc, jc = _decode_both(jcfg, tcfg, jp, tp, toks, 6, steps=9)
    for i, (tl, jl) in enumerate(logits):
        assert_close(_np(tl), np.asarray(jl), dtype="float32",
                     context=f"step {i}")
    assert_close(_np(tc["k"]), np.asarray(jc["k"]), dtype="float32")
    assert tc["pos"].tolist() == [[9, 9], [9, 9]]


def test_decode_int8_cache(decode_setup):
    """The int8 cache: the scales within the float32 row, the entries
    bitwise but for counted half-way flips (module docstring); the
    logits within the float32 row."""
    jcfg, tcfg, jp, tp, toks = decode_setup
    import dataclasses
    jq = dataclasses.replace(jcfg, kv_cache_int8=True)
    tq = dataclasses.replace(tcfg, kv_cache_int8=True)
    logits, tc, jc = _decode_both(jq, tq, jp, tp, toks, 20)
    for i, (tl, jl) in enumerate(logits):
        assert_close(_np(tl), np.asarray(jl), dtype="float32",
                     context=f"step {i}")
    # the reference's float32 k/v at the same steps: the quotients
    _, _, jf = _decode_both(jcfg, tcfg, jp, tp, toks, 20)
    flips = 0
    for key in ("k", "v"):
        assert tc[key].dtype == torch.int8
        assert_close(tc[f"{key}_scale"].numpy(),
                     np.asarray(jc[f"{key}_scale"]), dtype="float32")
        got = tc[key].numpy().astype(np.int32)
        want = np.asarray(jc[key]).astype(np.int32)
        scale = np.asarray(jc[f"{key}_scale"], np.float64)[..., None]
        quot = np.abs(np.asarray(jf[key], np.float64)) / np.maximum(
            scale, 1e-30)
        near_half = np.abs(quot - np.floor(quot) - 0.5) < HALF_TOL
        diff = got != want
        assert np.all(np.abs(got - want) <= 1), key
        assert not np.any(diff & ~near_half), key
        flips += int(diff.sum())
    assert flips <= 8, flips


def test_bf16_compute_forward_and_decode():
    """bf16 compute (the full configs' default): forward and a few
    decode steps with the bf16 cache within the bfloat16 row."""
    jcfg, tcfg = _cfgs(compute="bfloat16")
    jp, tp = _params(jcfg, tcfg, seed=9)
    toks = _tokens(jcfg.vocab, s=16, seed=10)
    jx, _ = jtr.forward(jp, jnp.asarray(toks), jcfg)
    tx, _ = ttr.forward(tp, _t(toks), tcfg)
    assert tx.dtype == torch.bfloat16
    assert_close(_np(tx), np.asarray(jx, np.float32), dtype="bfloat16")
    logits, tc, jc = _decode_both(jcfg, tcfg, jp, tp, toks[:, :4], 8)
    assert tc["k"].dtype == torch.bfloat16
    for i, (tl, jl) in enumerate(logits):
        assert_close(_np(tl), np.asarray(jl), dtype="bfloat16",
                     context=f"step {i}")


# --------------------------------------------------------------------- MoE ----
def _moe_inputs(case, t=64, seed=11, zero_router=False):
    jcfg, tcfg = _cfgs(moe=MOE_CASES[case], d_ff=32)
    jp, tp = _params(jcfg, tcfg, seed=seed)
    jlp = {n: a[0] for n, a in jp["layers"].items()}
    tlp = {n: a[0] for n, a in tp["layers"].items()}
    if zero_router:             # every router logit 0: all experts tie
        jlp["router"] = jnp.zeros_like(jlp["router"])
        tlp["router"] = torch.zeros_like(tlp["router"])
    x = np.random.default_rng(seed).normal(size=(t, 64)).astype(np.float32)
    return jcfg, tcfg, jlp, tlp, x


@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_dispatch(case):
    """Each dispatch against the reference's: the routing indices
    bitwise, the output and aux within the float32 row; the dropped
    slots counted the same (tokens beyond capacity give zeros)."""
    jcfg, tcfg, jlp, tlp, x = _moe_inputs(case)
    jfn = jtr._moe_scatter if "scatter" in case else jtr._moe_einsum
    tfn = ttr._moe_scatter if "scatter" in case else ttr._moe_einsum
    jy, jaux = jfn(jnp.asarray(x), jlp, jcfg, None)
    ty, taux = tfn(_t(x), tlp, tcfg)
    assert_close(_np(ty), np.asarray(jy), dtype="float32", context=case)
    assert_close(_np(taux), np.asarray(jaux), dtype="float32", context=case)
    k = tcfg.moe.top_k
    probs = jax.nn.softmax(jnp.asarray(x) @ jlp["router"], axis=-1)
    _, ji = jax.lax.top_k(probs, k)
    _, _, ti = ttr._route(_t(x), tlp, k)
    assert_bitwise(ti.numpy(), np.asarray(ji), context=case)
    if "drops" in case:
        # some token got no expert output: its MoE output is all zeros
        assert np.any(np.all(np.asarray(jy) == 0, axis=-1))
        assert_bitwise(np.all(_np(ty) == 0, axis=-1),
                       np.all(np.asarray(jy) == 0, axis=-1))


@pytest.mark.parametrize("case", ["einsum_top2", "scatter_top8"])
def test_moe_ties_lower_index_first(case):
    """Every router logit 0: all experts tie and ``lax.top_k`` takes the
    lowest indices; so does the port (``torch.topk`` promises no order
    on ties)."""
    jcfg, tcfg, jlp, tlp, x = _moe_inputs(case, zero_router=True)
    k = tcfg.moe.top_k
    _, _, ti = ttr._route(_t(x), tlp, k)
    assert ti.tolist() == [list(range(k))] * x.shape[0]
    vals, idx = top_k(torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0]]), 3)
    assert idx.tolist() == [[1, 2, 4]]
    jfn = jtr._moe_scatter if "scatter" in case else jtr._moe_einsum
    tfn = ttr._moe_scatter if "scatter" in case else ttr._moe_einsum
    jy, _ = jfn(jnp.asarray(x), jlp, jcfg, None)
    ty, _ = tfn(_t(x), tlp, tcfg)
    assert_close(_np(ty), np.asarray(jy), dtype="float32", context=case)


def test_model_flops_equal():
    for kw in ({}, dict(moe=MOE_CASES["einsum_top1_shared"]),
               dict(gated_mlp=False, n_kv_heads=1)):
        jcfg, tcfg = _cfgs(**kw)
        for args in ((4, 128), (2, 16)):
            for mk in (dict(training=True), dict(training=False),
                       dict(training=False, decode=True, kv_len=1024)):
                assert ttr.model_flops(tcfg, *args, **mk) == \
                    jtr.model_flops(jcfg, *args, **mk)


def test_a_mesh_is_refused():
    """A mesh is taken: on a world of one (gloo) every placement is
    replicated, the attention takes ``mesh=None``'s branch, and the
    forward of DTensors equals the plain forward bitwise."""
    from repro_torch.configs.base import distribute
    from repro_torch.dist.sharding import (NamedSharding,
                                           logical_to_physical, map_leaves,
                                           specs_from_rules)
    from repro_torch.launch.mesh import destroy_host_mesh, make_host_mesh
    _, tcfg = _cfgs()
    params = ttr.init_params(torch.Generator().manual_seed(0), tcfg)
    toks = torch.randint(0, tcfg.vocab, (2, 8),
                         generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    want, _ = ttr.forward(params, toks, tcfg)
    mesh = make_host_mesh("cpu")
    try:
        shard = map_leaves(
            lambda s: NamedSharding(mesh, logical_to_physical(s, mesh)),
            specs_from_rules(params, ttr.PARAM_RULES))
        from torch.distributed.tensor.experimental import \
            implicit_replication
        with implicit_replication():
            got, _ = ttr.forward(distribute(params, shard), toks, tcfg,
                                 mesh=mesh)
        assert torch.equal(got.full_tensor(), want)
    finally:
        destroy_host_mesh()
