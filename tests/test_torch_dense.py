"""The f32 dense kernel's launch plan and row-strided x, on the CPU.

``kernels/fused_dense.py:plan`` picks each launch's output tile; the
CUDA kernel (``csrc/fused_dense.cu``) cannot run here, so its tiling is
replayed in numpy: every output of every served shape and of the edge
shapes of ``kernels/f32_cases.py`` belongs to exactly one thread, and
every plan fits the card's shared memory. The executor's f32 dense reads
a lane-padded input's own K through a row-strided view, with the
unpadded w: the plain version gives the padded product's result on that
view bitwise, the entry points take the view as it is, and the GatedGCN
and GraphSAGE deployments stay within the float32 row of the JAX
package's. ``chip_smoke.py`` holds the kernel against the plain version
on the card, bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _numerics import assert_bitwise, assert_close
from test_torch_gnn import MODELS, _cfgs, _feeds, _req_kw

from repro.core.graph_ir import export_graph as jexport
from repro.core.passes.parallelize import Requirements as JReq
from repro.core.pipeline import deploy as jdeploy
from repro.kernels import ops as jops
from repro_torch.convert import from_jax_gnn_params
from repro_torch.core.graph_ir import export_graph
from repro_torch.core.pipeline import Requirements as TReq
from repro_torch.core.pipeline import deploy as tdeploy
from repro_torch.kernels import _build, f32_cases
from repro_torch.kernels import fused_dense as fd
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

#: (M, K, N) of the paths' launches: GatedGCN 16 x 70 (own K of the
#: lane-padded inputs), GraphSAGE 2 x 128, the CaloClusterNet fp and
#: ragged chunks, the attention graph's merged q, k, v dense
SERVED = [(256, 70, 70), (256, 70, 140), (64, 70, 70), (64, 8, 70),
          (256, 4, 70), (64, 70, 2), (512, 32, 128), (512, 256, 128),
          (512, 128, 5), (256, 4, 64), (256, 64, 64), (256, 64, 32),
          (256, 32, 7), (1024, 4, 64), (1024, 64, 4), (1024, 64, 22),
          (1024, 108, 64), (1024, 32, 7), (4096, 64, 192)]
EDGE = [(m, k, n) for m, k, n, *_ in f32_cases.DENSE_CASES.values()]


def _coverage(variant, m, n):
    """How many threads of the launch store each output: the kernel's
    grid (row tiles x column tiles), its threads' TR x TC blocks and its
    guards, replayed."""
    tr, tc, ty, tx = fd.TILES[variant]
    bm, bn = fd.tile(variant)
    hits = np.zeros((m, n), np.int64)
    gx, gy = -(-m // bm), -(-n // bn)
    assert gx * gy == fd.ctas(variant, m, n)
    for bx in range(gx):
        for by in range(gy):
            row0, col0 = bx * bm, by * bn
            rows, cols = min(bm, m - row0), min(bn, n - col0)
            r = (np.arange(ty)[:, None] * tr + np.arange(tr)).ravel()
            c = (np.arange(tx)[:, None] * tc + np.arange(tc)).ravel()
            r, c = r[r < rows], c[c < cols]
            np.add.at(hits, (row0 + r[:, None], col0 + c[None, :]), 1)
    return hits


@pytest.mark.parametrize("m,k,n", SERVED + EDGE)
def test_plan_covers_every_output_once_within_shared_memory(m, k, n):
    v = fd.plan(m, n)
    assert (_coverage(v, m, n) == 1).all()
    assert 0 < fd.smem_bytes(v, k) <= _build.SMEM_LIMIT


@pytest.mark.parametrize("variant", range(len(fd.TILES)))
def test_every_tile_covers_and_fits(variant):
    """Each tile, not only the planned one, at a shape off its edges and
    at K past the staging limit (two slab buffers)."""
    assert (_coverage(variant, 37, 75) == 1).all()
    for k in (1, fd.STAGE_K, fd.STAGE_K + 1, 4096):
        assert fd.smem_bytes(variant, k) <= _build.SMEM_LIMIT


def test_plan_runs_more_ctas_than_the_first_design():
    """The first design ran one 32 x 64 tile per CTA: 4 CTAs for
    (64, K) -> 70 and 16 for (256, K) -> 70."""
    assert fd.ctas(fd.plan(64, 70), 64, 70) > 4
    assert fd.ctas(fd.plan(256, 70), 256, 70) > 16
    assert fd.ctas(fd.plan(256, 70), 256, 70) <= fd.MAX_CTAS


@pytest.mark.parametrize("case", sorted(f32_cases.DENSE_CASES))
def test_plain_version_on_the_kernels_edge_inputs_matches_jax(case):
    """On the inputs that stress the kernel's design (K 1 to past the
    staging limit, row-strided x, N and M off every tile, with and
    without bias), the plain version the kernel is held to on the card
    agrees with the JAX package's dense within the float32 row."""
    m, k, n, ldx, act, bias = f32_cases.DENSE_CASES[case]
    x, w, b = f32_cases.dense_inputs(m, k, n, ldx=ldx, bias=bias,
                                     seed=len(case))
    got = tref.fused_dense_ref(torch.from_numpy(x)[:, :k],
                               torch.from_numpy(w),
                               None if b is None else torch.from_numpy(b),
                               activation=act)
    want = jops.fused_dense(jnp.asarray(x[:, :k]), jnp.asarray(w),
                            None if b is None else jnp.asarray(b),
                            activation=act, variant="flattened",
                            backend="xla")
    assert_close(got.numpy(), np.asarray(want), dtype="float32",
                 context=case)


def _padded(m, k, n, *, seed, kpad=128):
    """A lane-padded input (zeros past K, as the executor's retile pads)
    and w with and without its zero rows."""
    rng = np.random.default_rng(seed)
    xp = np.zeros((m, kpad), np.float32)
    xp[:, :k] = rng.normal(size=(m, k))
    w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    b = rng.normal(size=(n,)).astype(np.float32)
    wp = np.concatenate([w, np.zeros((kpad - k, n), np.float32)])
    return (torch.from_numpy(xp), torch.from_numpy(w), torch.from_numpy(wp),
            torch.from_numpy(b))


@pytest.mark.parametrize("act", ["relu", "none"])
@pytest.mark.parametrize("m,k,n", [(64, 70, 70), (256, 70, 140),
                                   (16, 32, 128), (8, 1, 5)])
def test_own_k_view_equals_the_padded_product(m, k, n, act):
    """The dropped terms are +0·+0 products: the own-K view with the
    unpadded w gives the padded product's outputs, bitwise on finite
    inputs."""
    xp, w, wp, b = _padded(m, k, n, seed=m + k + n)
    got = tref.fused_dense_ref(xp[:, :k], w, b, activation=act)
    want = tref.fused_dense_ref(xp, wp, b, activation=act)
    assert_bitwise(got.numpy(), want.numpy())
    assert_bitwise(tref.fused_dense_ref(xp[:, :k], w, None).numpy(),
                   tref.fused_dense_ref(xp, wp, None).numpy())


def test_entry_points_take_a_row_strided_view_without_a_copy(monkeypatch):
    """``ops.fused_dense`` and ``fused_dense_batched`` hand a column
    slice of a contiguous tensor to the plain version as the same
    storage, row stride 128, and give the contiguous copy's result."""
    xp, w, _, b = _padded(2 * 64, 70, 70, seed=3)
    seen = []
    plain = tref.fused_dense_ref

    def record(x, *args, **kw):
        seen.append((x.data_ptr(), x.stride()))
        return plain(x, *args, **kw)

    monkeypatch.setattr(tref, "fused_dense_ref", record)
    x2 = xp[:, :70]
    x3 = xp.view(2, 64, 128)[..., :70]
    assert fd.row_strided(x2)
    got2 = tops.fused_dense(x2, w, b)
    got3 = tops.fused_dense_batched(x3, w, b)
    assert seen == [(xp.data_ptr(), (128, 1))] * 2
    want = plain(x2.contiguous(), w, b)
    assert_bitwise(got2.numpy(), want.numpy())
    assert_bitwise(got3.reshape(128, 70).numpy(), want.numpy())


def test_wrapper_refuses_cpu_tensors_and_other_layouts():
    """The kernel takes a row-strided x (columns contiguous, rows at
    least K apart) and nothing else; the wrapper refuses CPU tensors
    before anything and counts no launch when it refuses."""
    xp, w, _, b = _padded(16, 70, 7, seed=4)
    assert fd.row_strided(xp) and fd.row_strided(xp[:, :70])
    assert fd.row_strided(xp[:1, :70].expand(1, 70))
    assert not fd.row_strided(xp[:, :70].t())          # last stride 128
    assert not fd.row_strided(xp[:1, :70].expand(16, 70))  # rows 0 apart
    assert not fd.row_strided(xp[:, ::2])              # columns apart
    before = fd.fused_dense_cuda.launches
    for x in (xp[:, :70], xp[:, :70].t().contiguous().t()):
        with pytest.raises(ValueError, match="CUDA"):
            fd.fused_dense_cuda(x, w, b)
    assert fd.fused_dense_cuda.launches == before


@pytest.mark.parametrize("name", sorted(MODELS))
def test_executor_dense_reads_its_own_k(name, monkeypatch):
    """On a lane-padded input the executor's f32 dense gets the own-K
    view (same storage, row stride 128) and the op's unpadded w, never a
    padded copy; the deployment's logits stay within the float32 row of
    the JAX package's (Pallas kernels interpreted)."""
    jcfg, tcfg = _cfgs(name)
    jm = MODELS[name][0]
    jparams = jm.init(jax.random.PRNGKey(1), jcfg)
    tparams = from_jax_gnn_params(jax.tree_util.tree_map(np.asarray,
                                                         jparams),
                                  tcfg, device="cpu")
    feeds = _feeds(name, seed=31)
    tpipe = tdeploy(export_graph(name, tparams, tcfg), TReq(**_req_kw(3)),
                    device="cpu")
    weights = [op.params["w"] for op in tpipe.graph
               if op.params and "w" in op.params]
    calls = []
    plain = tref.fused_dense_ref

    def record(x, w, *args, **kw):
        calls.append((x.shape[-1], x.stride(0), w))
        return plain(x, w, *args, **kw)

    monkeypatch.setattr(tref, "fused_dense_ref", record)
    got = tpipe(feeds)["logits"].numpy()
    assert calls
    for k, ldx, w in calls:
        assert w.shape[0] == k and any(w is w_ for w_ in weights)
    strided = [(k, ldx) for k, ldx, _ in calls if ldx > k]
    assert strided and all(ldx == 128 for _, ldx in strided)
    jpipe = jdeploy(jexport(name, jparams, jcfg), JReq(**_req_kw(3)),
                    kernel_backend="pallas_interpret")
    assert_close(got, np.asarray(jpipe(feeds)["logits"]), dtype="float32",
                 context=name)
