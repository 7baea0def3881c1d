"""The port's MIND (``repro_torch/models/recsys.py``, ``data/recsys.py``,
``nn/jax_prng.py``) against the JAX package's on the CPU, at the smoke
config's widths, from the reference's ``init`` carried across by
``convert.from_jax_mind_params`` and batches from ``mind_batch``.

Tolerances (``tests/_numerics.py``): the ``float32`` row for floats;
bitwise for integers (the batches, ``serve_topk``'s indices where no two
neighbours in the reference's order lie within ``TIE_REL`` of their size,
the float32 row's rtol). The JAX
random draw: its bits and its uniform bitwise, the normal within the
float32 row (JAX's float32 ``erfinv`` is XLA's polynomial; the port's
is float64 rounded, an ulp or two apart).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _numerics import assert_bitwise, assert_close
from test_torch_lm import _two_threads  # noqa: F401 (autouse)

from repro.configs import mind as jmind
from repro.data.recsys import mind_batch as jmind_batch
from repro.models import recsys as jrec
from repro_torch import convert
from repro_torch.configs import mind as tmind
from repro_torch.data.recsys import mind_batch, mind_stream
from repro_torch.models import recsys as trec
from repro_torch.nn import jax_prng

TIE_REL = 1e-5


def _leaves(tree):
    if isinstance(tree, dict):
        return [(f"{k}/{n}".strip("/"), v) for k in sorted(tree)
                for n, v in _leaves(tree[k])]
    return [("", tree)]


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = jmind.smoke_config(), tmind.smoke_config()
    jp = jrec.init(jax.random.PRNGKey(0), jcfg)
    tp = convert.from_jax_mind_params(
        jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")
    raw = mind_batch(n_items=tcfg.n_items, n_user_tags=tcfg.n_user_tags,
                     hist_len=tcfg.hist_len, tag_bag=tcfg.tag_bag,
                     batch=16, seed=3, step=0)
    return jcfg, tcfg, jp, tp, raw


def _jb(raw):
    return {k: jnp.asarray(v) for k, v in raw.items()}


def _tb(raw):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in raw.items()}


@pytest.mark.parametrize("kh", [(4, 8), (4, 50), (1, 1), (3, 17), (8, 64)])
def test_jax_prng_normal(kh):
    k, h = kh
    key = jax.random.PRNGKey(17)
    shape = (1, k, h)
    assert jax_prng.prng_key(17) == tuple(
        int(w) for w in jax.random.key_data(key))
    assert_bitwise(jax_prng.random_bits(jax_prng.prng_key(17), shape),
                   np.asarray(jax.random.bits(key, shape)))
    lo = np.nextafter(np.float32(-1), np.float32(np.inf))
    assert_bitwise(jax_prng.uniform(jax_prng.prng_key(17), shape, lo, 1.0),
                   np.asarray(jax.random.uniform(key, shape, minval=lo,
                                                 maxval=1.0)))
    got = jax_prng.normal(jax_prng.prng_key(17), shape)
    assert got.dtype == np.float32
    assert_close(got, np.asarray(jax.random.normal(key, shape)),
                 dtype="float32")
    # the routing constant is this draw, once per (K, H, device)
    t = trec.routing_init(k, h, "cpu")
    assert t is trec.routing_init(k, h, "cpu")
    assert_bitwise(t.numpy(), got)
    if kh == (4, 8):
        assert_close(got[0, 0, :4], np.array(
            [-0.66748405, 1.1928468, 0.7245219, -0.3257403], np.float32),
            dtype="float32")


def test_jax_prng_other_seeds():
    for seed in (0, 1, 2 ** 31 - 1):
        key = jax.random.PRNGKey(seed)
        assert_bitwise(jax_prng.random_bits(jax_prng.prng_key(seed),
                                            (3, 5)),
                       np.asarray(jax.random.bits(key, (3, 5))))


def test_embedding_bag_modes():
    """sum and mean, per-sample weights, a negative id weighs 0, bags
    not in order."""
    rng = np.random.default_rng(0)
    tbl = rng.normal(size=(20, 8)).astype(np.float32)
    ids = np.array([1, 2, -1, 4, 5, 6, 19, -3], np.int32)
    seg = np.array([0, 2, 0, 1, 1, 1, 2, 2], np.int32)
    w = np.array([2.0, 0.5, 1.0, 1.0, 0.0, 1.0, 3.0, 1.0], np.float32)
    for mode in ("sum", "mean"):
        for weights in (None, w):
            kw = dict(segment_ids=seg, num_segments=4, mode=mode)
            want = jrec.embedding_bag(
                jnp.asarray(tbl), jnp.asarray(ids),
                weights=None if weights is None else jnp.asarray(weights),
                **{**kw, "segment_ids": jnp.asarray(seg)})
            got = trec.embedding_bag(
                torch.from_numpy(tbl), torch.from_numpy(ids),
                weights=None if weights is None else torch.from_numpy(
                    weights), **{**kw, "segment_ids": torch.from_numpy(seg)})
            assert_close(got.numpy(), np.asarray(want), dtype="float32",
                         context=f"{mode} {weights is not None}")
    with pytest.raises(ValueError):
        trec.embedding_bag(torch.from_numpy(tbl), torch.from_numpy(ids),
                           segment_ids=torch.from_numpy(seg),
                           num_segments=4, mode="max")


def test_capsules(setup):
    """extract_interests and user_capsules; masked behaviours inert."""
    jcfg, tcfg, jp, tp, raw = setup
    jb, tb = _jb(raw), _tb(raw)
    for fn in ("extract_interests", "user_capsules"):
        if fn == "extract_interests":
            want = jrec.extract_interests(jp, jb["behav_ids"],
                                          jb["behav_mask"], jcfg)
            got = trec.extract_interests(tp, tb["behav_ids"],
                                         tb["behav_mask"], tcfg)
        else:
            want = jrec.user_capsules(jp, jb, jcfg)
            got = trec.user_capsules(tp, tb, tcfg)
        assert tuple(got.shape) == want.shape
        assert_close(got.numpy(), np.asarray(want), dtype="float32",
                     context=fn)
    ids2 = raw["behav_ids"].copy()
    m = raw["behav_mask"] == 0
    ids2[m] = (ids2[m] + 17) % tcfg.n_items
    u2 = trec.extract_interests(tp, torch.from_numpy(ids2),
                                tb["behav_mask"], tcfg)
    assert_close(u2.numpy(), trec.extract_interests(
        tp, tb["behav_ids"], tb["behav_mask"], tcfg).numpy(),
        dtype="float32")


def test_loss_and_gradients(setup):
    """loss_fn's loss and in-batch accuracy, and every leaf's gradient
    (the routing's first iterations carry none)."""
    jcfg, tcfg, jp, tp, raw = setup
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jrec.loss_fn(p, _jb(raw), jcfg), has_aux=True)(jp)
    from repro_torch.optim.step import value_and_grad
    (tl, tm), tg = value_and_grad(
        lambda p: trec.loss_fn(p, _tb(raw), tcfg), tp)
    assert_close(tl.numpy(), np.asarray(jl), dtype="float32")
    for key in ("loss", "in_batch_acc"):
        assert_close(tm[key].numpy(), np.asarray(jm[key]), dtype="float32",
                     context=key)
    jleaves = dict(_leaves(jax.tree_util.tree_map(np.asarray, jg)))
    for name, g in _leaves(tg):
        assert_close(g.numpy(), jleaves[name], dtype="float32", context=name)
        assert np.any(g.numpy() != 0), name


@pytest.mark.parametrize("shared", [True, False])
def test_score_candidates(setup, shared):
    jcfg, tcfg, jp, tp, raw = setup
    rng = np.random.default_rng(5)
    cands = (np.arange(tcfg.n_items, dtype=np.int32) if shared else
             rng.integers(0, tcfg.n_items, (16, 40)).astype(np.int32))
    want = jrec.score_candidates(jp, {**_jb(raw),
                                      "cand_ids": jnp.asarray(cands)}, jcfg)
    got = trec.score_candidates(tp, {**_tb(raw),
                                     "cand_ids": torch.from_numpy(cands)},
                                tcfg)
    assert tuple(got.shape) == want.shape
    assert_close(got.numpy(), np.asarray(want), dtype="float32")


def test_serve_topk(setup):
    """The values within the float32 row; the indices bitwise wherever
    the reference's neighbours are more than TIE_REL of their size apart
    (elsewhere the two packages' scores, an ulp apart, may swap them);
    exact ties lower index first."""
    jcfg, tcfg, jp, tp, raw = setup
    cands = np.arange(tcfg.n_items, dtype=np.int32)
    jv, ji = jrec.serve_topk(jp, {**_jb(raw), "cand_ids": jnp.asarray(
        cands)}, jcfg, k=20)
    tv, ti = trec.serve_topk(tp, {**_tb(raw), "cand_ids": torch.from_numpy(
        cands)}, tcfg, k=20)
    assert_close(tv.numpy(), np.asarray(jv), dtype="float32")
    jv = np.asarray(jv)
    apart = np.abs(np.diff(jv, axis=1)) > TIE_REL * np.maximum(
        np.abs(jv[:, 1:]), np.abs(jv[:, :-1]))
    sep = np.ones_like(jv, bool)
    sep[:, 1:] &= apart
    sep[:, :-1] &= apart
    assert sep.mean() > 0.5
    assert_bitwise(ti.numpy()[sep], np.asarray(ji)[sep])
    # exact ties: duplicate the item table's rows, every score repeats
    tp2 = dict(tp, item_emb=tp["item_emb"][:10].repeat(30, 1))
    jp2 = dict(jp, item_emb=jnp.tile(jp["item_emb"][:10], (30, 1)))
    _, ji2 = jrec.serve_topk(jp2, {**_jb(raw), "cand_ids": jnp.asarray(
        cands)}, jcfg, k=20)
    _, ti2 = trec.serve_topk(tp2, {**_tb(raw), "cand_ids": torch.from_numpy(
        cands)}, tcfg, k=20)
    s2 = trec.score_candidates(tp2, {**_tb(raw), "cand_ids":
                                     torch.from_numpy(cands)}, tcfg)
    assert bool((s2 == s2[:, :10].repeat(1, 30)).all())
    assert_bitwise(ti2.numpy(), np.asarray(ji2))
    assert bool((torch.diff(ti2, dim=-1)[:, 1:] > 0).any())


def test_mind_batch_byte_equal():
    for b, seed, step in ((16, 0, 0), (7, 3, 5), (64, 1, 2)):
        kw = dict(n_items=1000, n_user_tags=70, hist_len=12, tag_bag=5,
                  batch=b, seed=seed, step=step)
        got, want = mind_batch(**kw), jmind_batch(**kw)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert got[k].tobytes() == want[k].tobytes(), k
    stream = mind_stream(tmind.smoke_config(), 4, seed=2, start_step=3)
    first = next(stream)
    want = jmind_batch(n_items=300, n_user_tags=60, hist_len=8, tag_bag=4,
                       batch=4, seed=2, step=3)
    assert all(first[k].tobytes() == want[k].tobytes() for k in want)


def test_config_matches_reference():
    assert tmind.full_config().__dict__ == jmind.full_config().__dict__
    assert tmind.smoke_config().__dict__ == jmind.smoke_config().__dict__
    assert tmind._META == jmind._META and tmind.SHAPES == jmind.SHAPES
    assert tmind.OCFG == tmind.OCFG.__class__(**jmind.OCFG.__dict__)
    for step in (0, 50, 100, 5000, 20000):
        assert float(tmind.LR(step)) == float(jmind.LR(step))
    cfg = tmind.full_config()
    assert tmind._train_flops(cfg, 65536) == jmind._train_flops(
        jmind.full_config(), 65536)
    for shape in ("serve_p99", "serve_bulk", "retrieval_cand"):
        meta = tmind._META[shape]
        assert tmind._serve_flops(cfg, meta["batch"], meta["cands"]) == \
            jmind.cell(shape).model_flops
    for shape in tmind.SHAPES:
        cell, want = tmind.cell(shape), jmind.cell(shape)
        assert (cell.name, cell.kind, cell.model_flops) == \
            (want.name, want.kind, want.model_flops)


def test_smoke_run(setup):
    got = tmind.smoke_run(seed=0, device="cpu")
    assert tuple(got["scores"].shape) == (16, 300)
    assert bool(torch.isfinite(got["loss"]))
    assert 0.0 <= float(got["metrics"]["in_batch_acc"]) <= 1.0
