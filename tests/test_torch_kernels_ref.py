"""The port's plain kernel versions (``repro_torch/kernels/ref.py``) and
its kernel entry points on CPU tensors, against the JAX package's
kernels — run in interpret mode and through their jnp reference — on
the same numpy inputs. The CUDA kernels themselves are held against
these plain versions on the card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _numerics import assert_bitwise, assert_close

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.fused_dense import fused_dense_cuda
from repro_torch.kernels.gravnet_block import gravnet_block_cuda

BACKENDS = ("xla", "pallas_interpret")
# smoke widths (repro/configs/caloclusternet.py:smoke_config)
N, DH, DS, DF, K = 16, 24, 3, 8, 4


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------ fused dense ----
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("m,kdim,n,act,bias", [
    (48, 24, 24, "relu", True), (32, 4, 24, "relu", True),
    (37, 12, 7, "none", True), (16, 44, 24, "relu", False)])
def test_fused_dense_ref_matches_jax(backend, m, kdim, n, act, bias):
    rng = np.random.default_rng(m * 100 + n)
    x = rng.normal(size=(m, kdim)).astype(np.float32)
    w = (rng.normal(size=(kdim, n)) / np.sqrt(kdim)).astype(np.float32)
    b = rng.normal(size=(n,)).astype(np.float32) if bias else None
    want = jops.fused_dense(jnp.asarray(x), jnp.asarray(w),
                            None if b is None else jnp.asarray(b),
                            activation=act, variant="flattened",
                            backend=backend)
    got = tref.fused_dense_ref(_t(x), _t(w), None if b is None else _t(b),
                               activation=act)
    assert_close(got.numpy(), np.asarray(want), dtype="float32")


def test_fused_dense_ops_route_cpu_tensors_to_plain_version():
    rng = np.random.default_rng(1)
    x = _t(rng.normal(size=(2, 16, 24)).astype(np.float32))
    w = _t(rng.normal(size=(24, 7)).astype(np.float32))
    b = _t(rng.normal(size=(7,)).astype(np.float32))
    before = fused_dense_cuda.launches
    got = tops.fused_dense_batched(x, w, b)
    assert_bitwise(got.numpy(), tref.fused_dense_ref(x, w, b).numpy())
    assert_bitwise(tops.fused_dense(x[0], w, b).numpy(), got[0].numpy())
    assert fused_dense_cuda.launches == before


def test_kernel_wrappers_refuse_cpu_tensors():
    """A kernel wrapper takes CUDA tensors only; it never runs the plain
    version itself, and counts no launch when it refuses."""
    x = torch.zeros(4, 8)
    w = torch.zeros(8, 3)
    counts = fused_dense_cuda.launches, gravnet_block_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        fused_dense_cuda(x, w)
    with pytest.raises(ValueError, match="CUDA"):    # gelu has its code
        fused_dense_cuda(x, w, activation="gelu")
    o = _block_operands(b=1, seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        gravnet_block_cuda(*(_t(o[k]) for k in _BLOCK_ARGS), k=K)
    assert (fused_dense_cuda.launches,
            gravnet_block_cuda.launches) == counts


# ---------------------------------------------------------------- gravnet ----
_BLOCK_ARGS = ("x", "mask", "ws", "bs", "wf", "bf", "wo", "bo")


def _min_selection_gap(x, mask, ws, bs, k):
    """Smallest relative gap, over every query row of every event,
    between its k-th and (k+1)-th candidate distance (float64). A gap
    well above f32 rounding means both packages choose the same
    neighbour set."""
    s = x.astype(np.float64) @ ws + bs
    gap = np.inf
    for e in range(x.shape[0]):
        valid = np.flatnonzero(mask[e] > 0)
        for i in range(x.shape[1]):
            cand = valid[valid != i]
            if len(cand) <= k:
                continue
            d2 = np.sort(((s[e, cand] - s[e, i]) ** 2).sum(1))
            gap = min(gap, (d2[k] - d2[k - 1]) / max(d2[k], 1.0))
    return gap


def _block_operands(b, seed, n_valid=None, all_masked=None):
    """Block inputs at smoke widths whose neighbour choice is stable:
    resample until every row's k-th and (k+1)-th distances are
    separated by far more than f32 rounding. The Gaussian weight
    exp(-scale·d²) turns a rounding difference in the learned
    coordinates into a relative difference of scale·|s|²·ulp in the
    output, so the weights have the model's scale (|s|² of order 1),
    not a larger one, for the float32 row to be the right bound."""
    for attempt in range(50):
        rng = np.random.default_rng(seed * 1000 + attempt)
        o = dict(   # the model's scales: LeCun-normal weights
            x=rng.normal(size=(b, N, DH)).astype(np.float32),
            mask=np.ones((b, N), np.float32),
            ws=(rng.normal(size=(DH, DS)) / np.sqrt(DH)).astype(np.float32),
            bs=(rng.normal(size=(DS,)) * 0.1).astype(np.float32),
            wf=(rng.normal(size=(DH, DF)) / np.sqrt(DH)).astype(np.float32),
            bf=(rng.normal(size=(DF,)) * 0.1).astype(np.float32),
            wo=(rng.normal(size=(DH + 2 * DF, DH))
                / np.sqrt(DH + 2 * DF)).astype(np.float32),
            bo=(rng.normal(size=(DH,)) * 0.1).astype(np.float32))
        if n_valid is not None:      # padded rows at the end, as belle2
            o["mask"][:, n_valid:] = 0.0
            o["x"][:, n_valid:] = 0.0
        if all_masked is not None:
            o["mask"][all_masked] = 0.0
        if _min_selection_gap(o["x"], o["mask"], o["ws"], o["bs"],
                              K) > 1e-3:
            return o
    raise AssertionError("no well-separated draw in 50 attempts")


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("b,n_valid,all_masked", [
    (1, None, None), (3, 11, None), (3, 13, 1)])
def test_gravnet_block_ref_matches_jax(backend, b, n_valid, all_masked):
    o = _block_operands(b, seed=b + (n_valid or 0), n_valid=n_valid,
                        all_masked=all_masked)
    want = jops.gravnet_block_batched(
        *(jnp.asarray(o[k]) for k in _BLOCK_ARGS), k=K, backend=backend)
    got = tref.gravnet_block_ref(*(_t(o[k]) for k in _BLOCK_ARGS), k=K)
    assert got.shape == (b, N, DH)
    assert_close(got.numpy(), np.asarray(want), dtype="float32")
    # the port's entry points route CPU tensors to this plain version
    assert_bitwise(tops.gravnet_block_batched(
        *(_t(o[k]) for k in _BLOCK_ARGS), k=K).numpy(), got.numpy())
    assert_bitwise(tops.gravnet_block(
        *(_t(o[k][0]) if k in ("x", "mask") else _t(o[k])
          for k in _BLOCK_ARGS), k=K).numpy(), got[0].numpy())


@pytest.mark.parametrize("backend", BACKENDS)
def test_gravnet_cell_ref_matches_jax_aggregate(backend):
    """The cell alone (argmin/knockout schedule) against the JAX
    package's aggregation kernel, with padded rows."""
    o = _block_operands(3, seed=7, n_valid=12)
    s = o["x"] @ o["ws"] + o["bs"]
    f = o["x"] @ o["wf"] + o["bf"]
    want = jops.gravnet_aggregate_batched(
        jnp.asarray(s), jnp.asarray(f), jnp.asarray(o["mask"]), k=K,
        backend=backend)
    got = tref.gravnet_cell_ref(_t(s), _t(f), _t(o["mask"]), k=K)
    assert_close(got.numpy(), np.asarray(want), dtype="float32")


def test_all_masked_event_aggregates_to_zero():
    o = _block_operands(2, seed=5, all_masked=0)
    s = _t(o["x"] @ o["ws"] + o["bs"])
    f = _t(o["x"] @ o["wf"] + o["bf"])
    agg = tref.gravnet_cell_ref(s, f, _t(o["mask"]), k=K)
    assert not agg[0].any()
    assert agg[1].abs().sum() > 0
