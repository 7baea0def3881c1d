"""The geometric GNNs' substrate in the port against the JAX package, on
the CPU: the spherical harmonics and intertwiners bit for bit (numpy
code kept as it is), NequIP's tensor-product paths, the geometric and
molecule generators and DimeNet's triplet builder byte for byte (the
triplet budget cut where the reference cuts it), and within the float32
row ``edge_vectors``, ``bessel_rbf``, ``cosine_cutoff`` and their
gradients (at padded edges, where r = 0, and where ``jnp.clip`` ties),
``scatter_max`` and ``scatter_softmax`` (masked edges, an empty
segment), the torch ``real_sph`` and the MLP's default activation.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _numerics import assert_bitwise, assert_close
from test_torch_lm import _two_threads  # noqa: F401 (autouse)

from repro.data import graphs as jgraphs
from repro.models.gnn import common as jC
from repro.models.gnn import nequip as jnequip
from repro.models.gnn import sph as jsph
from repro.nn import layers as jlayers
from repro_torch.data import graphs as tgraphs
from repro_torch.models.gnn import common as C
from repro_torch.models.gnn import nequip, sph
from repro_torch.nn import layers as tlayers
from repro_torch.optim.adamw import tree_map


# ------------------------------------------------------------------ sph ----
@pytest.mark.parametrize("l", [0, 1, 2, 3])
def test_real_sph_np_bitwise(l):
    rng = np.random.default_rng(l)
    u = rng.normal(size=(50, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    assert_bitwise(sph.real_sph_np(l, u), jsph.real_sph_np(l, u))


@pytest.mark.parametrize("l", [0, 1, 2])
def test_real_sph_torch_matches_jnp(l):
    rng = np.random.default_rng(10 + l)
    u = rng.normal(size=(4, 30, 3)).astype(np.float32)
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    got = sph.real_sph(l, torch.from_numpy(u))
    assert got.dtype == torch.float32
    assert_close(got.numpy(), np.asarray(jsph.real_sph(l, jnp.asarray(u))),
                 dtype="float32")


def test_wigner_and_rotation_bitwise():
    rot = sph._random_rotation(np.random.default_rng(3))
    assert_bitwise(rot, jsph._random_rotation(np.random.default_rng(3)))
    for l in range(4):
        assert_bitwise(sph.wigner_d_for(l, rot), jsph.wigner_d_for(l, rot))


@pytest.mark.parametrize("l_max", [0, 1, 2])
def test_paths_and_their_intertwiners_bitwise(l_max):
    """``_paths`` as the reference's (11 at l_max 2), and every path's
    intertwiner byte for byte, as numpy and as the cached f32 tensor."""
    cfg = nequip.NequIPConfig(l_max=l_max)
    got = nequip._paths(cfg)
    want = jnequip._paths(jnequip.NequIPConfig(l_max=l_max))
    assert got == want
    if l_max == 2:
        assert len(got[1]) == 11
    for (l1, _, l2, l3, _) in got[1]:
        w = sph.intertwiner(l1, l2, l3)
        assert_bitwise(w, jsph.intertwiner(l1, l2, l3))
        t = sph.intertwiner_tensor(l1, l2, l3, torch.device("cpu"))
        assert t.dtype == torch.float32
        assert_bitwise(t.numpy(), np.asarray(jsph.intertwiner_jnp(l1, l2,
                                                                  l3)))


def test_empty_intertwiners_are_none():
    for trip in [(0, 0, 2), (1, 0, 2), (2, 2, 5)]:
        assert sph.intertwiner(*trip) is None
        assert jsph.intertwiner(*trip) is None
        assert sph.intertwiner_tensor(*trip, torch.device("cpu")) is None


# --------------------------------------------------------------- graphs ----
@pytest.mark.parametrize("kw", [
    dict(n_nodes=24, cutoff=1.8, box=3.0, n_species=4, seed=0,
         max_edges=128),
    dict(n_nodes=20, cutoff=1.8, box=3.0, n_species=4, seed=3,
         max_edges=96),
    dict(n_nodes=16, cutoff=1.8, box=4.0, n_species=4, seed=5,
         max_edges=96),
    dict(n_nodes=30, cutoff=1.6, box=3.0, n_species=16, seed=7,
         max_edges=64)])
def test_geometric_graph_bytewise(kw):
    got, want = tgraphs.geometric_graph(**kw), jgraphs.geometric_graph(**kw)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert_bitwise(got[k], want[k], context=k)


@pytest.mark.parametrize("budget", [512, 100, 4096])
def test_build_triplets_bytewise_and_cut_where_the_reference_cuts(budget):
    """The smoke graph (24 atoms, 128 edges) fills a 512 budget, and 100;
    4096 leaves padding."""
    g = jgraphs.geometric_graph(24, cutoff=1.8, box=3.0, n_species=4,
                                seed=0, max_edges=128)
    got = tgraphs.build_triplets(g["edge_index"], g["edge_mask"],
                                 max_triplets=budget)
    want = jgraphs.build_triplets(g["edge_index"], g["edge_mask"],
                                  max_triplets=budget)
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype
        assert_bitwise(a, b)
    filled = int(want[1].sum())
    assert (filled == budget) == (budget <= 512)


@pytest.mark.parametrize("with_triplets", [True, False])
def test_molecule_batch_bytewise(with_triplets):
    kw = dict(n_nodes=30, max_edges=64, max_triplets=256, n_species=16,
              seed=2, with_triplets=with_triplets)
    got, want = tgraphs.molecule_batch(5, **kw), jgraphs.molecule_batch(5,
                                                                        **kw)
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape[0] == 5
        assert_bitwise(got[k], want[k], context=k)


# ---------------------------------------------------- geometric common ----
def _distances():
    """Lengths over the basis's range: the padded edge's sqrt(1e-9), the
    1e-6 floor's tie, the cutoff's tie, past the cutoff."""
    rng = np.random.default_rng(0)
    d = rng.uniform(0.05, 6.0, size=40).astype(np.float32)
    return np.concatenate([d, np.float32([np.sqrt(np.float32(1e-9)), 1e-6,
                                          5.0, 7.5, 2.5])])


#: below this length the gradient of sin(a·d)/d is the difference of two
#: terms of size a/d: float32 keeps none of its digits, in either package
ILL_CONDITIONED = 1e-3


@pytest.mark.parametrize("fn", ["bessel_rbf", "cosine_cutoff"])
def test_radial_bases_and_gradients_match_reference(fn):
    """Values and gradients within the float32 row of the reference's;
    the Bessel basis's gradient at lengths below ``ILL_CONDITIONED``
    (the padded edge's, the 1e-6 floor) is held, in both packages, to
    the float64 value within 64 float32 ulps of the cancelling terms."""
    d = _distances()
    if fn == "bessel_rbf":
        jf = lambda x: jC.bessel_rbf(x, n_rbf=6, cutoff=5.0)  # noqa: E731
        tf = lambda x: C.bessel_rbf(x, n_rbf=6, cutoff=5.0)  # noqa: E731
    else:
        jf = lambda x: jC.cosine_cutoff(x, 5.0)  # noqa: E731
        tf = lambda x: C.cosine_cutoff(x, 5.0)  # noqa: E731
    w = np.random.default_rng(1).normal(size=np.asarray(jf(d)).shape)
    w = w.astype(np.float32)
    jv, jg = jax.value_and_grad(lambda x: (jf(x) * w).sum())(jnp.asarray(d))
    x = torch.from_numpy(d).requires_grad_(True)
    tv = tf(x)
    (tg,) = torch.autograd.grad((tv * torch.from_numpy(w)).sum(), x)
    assert_close(tv.detach().numpy(), np.asarray(jf(d)), dtype="float32")
    ok = d >= ILL_CONDITIONED if fn == "bessel_rbf" else d >= 0
    assert_close(tg.numpy()[ok], np.asarray(jg)[ok], dtype="float32")
    if fn == "bessel_rbf":
        x64 = torch.from_numpy(d.astype(np.float64)).requires_grad_(True)
        (g64,) = torch.autograd.grad(
            (tf(x64) * torch.from_numpy(w).double()).sum(), x64)
        a = np.pi * np.arange(1, 7) / 5.0
        terms = (np.abs(w) * np.sqrt(2 / 5.0) * a * 2).sum(-1) / np.maximum(
            d.astype(np.float64), 1e-6)
        bound = 64 * 2.0 ** -24 * terms
        for got in (tg.numpy(), np.asarray(jg)):
            assert (np.abs(got - g64.numpy())[~ok] <= bound[~ok]).all()


def test_clip_and_maximum_split_the_gradient_at_a_tie():
    x = torch.tensor([1.0, 0.0, 0.5, 2.0], requires_grad=True)
    (g,) = torch.autograd.grad(C._clip(x, 0.0, 1.0).sum(), x)
    want = jax.grad(lambda v: jnp.clip(v, 0.0, 1.0).sum())(
        jnp.asarray([1.0, 0.0, 0.5, 2.0]))
    assert_bitwise(g.numpy(), np.asarray(want))
    assert g.tolist() == [0.5, 0.5, 1.0, 0.0]


def test_edge_vectors_and_gradient_at_padded_edges():
    """Padded edges (src = dst = 0) have r = 0: length sqrt(eps), unit
    0, and a finite gradient, as in the reference; a leading batch axis
    gives each graph's own vectors."""
    g = jgraphs.geometric_graph(16, cutoff=1.8, box=4.0, n_species=4,
                                seed=5, max_edges=96)
    assert g["edge_mask"].min() == 0.0
    pos, ei = g["positions"], g["edge_index"]
    w = np.random.default_rng(2).normal(size=(96, 3)).astype(np.float32)

    def jloss(p):
        r, d, u = jC.edge_vectors(p, jnp.asarray(ei))
        return (u * w).sum() + d.sum() + (r * w).sum()
    jg = jax.grad(jloss)(jnp.asarray(pos))
    p = torch.from_numpy(pos).requires_grad_(True)
    r, d, u = C.edge_vectors(p, torch.from_numpy(ei))
    jr, jd, ju = jC.edge_vectors(jnp.asarray(pos), jnp.asarray(ei))
    for got, want in ((r, jr), (d, jd), (u, ju)):
        assert_close(got.detach().numpy(), np.asarray(want), dtype="float32")
    (tg,) = torch.autograd.grad(
        (u * torch.from_numpy(w)).sum() + d.sum()
        + (r * torch.from_numpy(w)).sum(), p)
    assert bool(torch.isfinite(tg).all())
    assert_close(tg.numpy(), np.asarray(jg), dtype="float32")
    pb = torch.from_numpy(np.stack([pos, pos[::-1].copy()]))
    eb = torch.from_numpy(np.stack([ei, ei]))
    rb, _, _ = C.edge_vectors(pb, eb)
    assert_bitwise(rb[0].numpy(), r.detach().numpy())
    assert_bitwise(rb[1].numpy(), C.edge_vectors(
        torch.from_numpy(pos[::-1].copy()), torch.from_numpy(ei))[0].numpy())


def _scatter_case(seed):
    """Messages on 60 edges into 12 nodes; node 11 receives no edge and
    node 10 only masked ones."""
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, 10, size=(2, 60)).astype(np.int32)
    ei[1, :4] = 10
    mask = (rng.uniform(size=60) < 0.8).astype(np.float32)
    mask[:4] = 0.0
    msg = rng.normal(size=(60, 5)).astype(np.float32) * 3.0
    return msg, ei, mask


@pytest.mark.parametrize("masked", [True, False])
def test_scatter_max_matches_reference(masked):
    msg, ei, mask = _scatter_case(0)
    em = mask if masked else None
    want = jC.scatter_max(jnp.asarray(msg), jnp.asarray(ei), 12,
                          None if em is None else jnp.asarray(em))
    got = C.scatter_max(torch.from_numpy(msg), torch.from_numpy(ei), 12,
                        None if em is None else torch.from_numpy(em))
    assert_close(got.numpy(), np.asarray(want), dtype="float32")
    assert bool((got[11] == 0).all())
    if masked:
        assert bool((got[10] == 0).all())


@pytest.mark.parametrize("masked", [True, False])
def test_scatter_softmax_matches_reference(masked):
    msg, ei, mask = _scatter_case(1)
    scores = msg[:, 0]
    em = mask if masked else None
    want = jC.scatter_softmax(jnp.asarray(scores), jnp.asarray(ei), 12,
                              None if em is None else jnp.asarray(em))
    got = C.scatter_softmax(torch.from_numpy(scores), torch.from_numpy(ei),
                            12, None if em is None else torch.from_numpy(em))
    assert_close(got.numpy(), np.asarray(want), dtype="float32")
    sums = torch.zeros(12).index_add(0, torch.from_numpy(ei[1]).long(), got)
    live = sums > 0
    assert_close(sums[live].numpy(), np.ones(int(live.sum()), np.float32),
                 dtype="float32")
    if masked:
        assert bool((got[torch.from_numpy(mask) == 0] == 0).all())


def test_mlp_default_activation_is_relu():
    """``mlp_apply``'s default activation is relu (DimeNet's out_mlp
    takes it), none after the last layer; silu where asked."""
    jp = jlayers.mlp_init(jax.random.PRNGKey(0), [6, 8, 3])
    tp = tree_map(lambda a: torch.from_numpy(np.array(a)),
                  jax.tree_util.tree_map(np.asarray, jp))
    x = np.random.default_rng(0).normal(size=(5, 6)).astype(np.float32)
    for jkw, tkw in (({}, {}), ({"activation": jax.nn.silu},
                                {"activation": torch.nn.functional.silu})):
        want = jlayers.mlp_apply(jp, jnp.asarray(x), **jkw)
        got = tlayers.mlp_apply(tp, torch.from_numpy(x), **tkw)
        assert_close(got.numpy(), np.asarray(want), dtype="float32")
    shapes = [tuple(p["w"].shape) for p in tlayers.mlp_init(
        torch.Generator().manual_seed(0), [6, 8, 3])]
    assert shapes == [(6, 8), (8, 3)]
