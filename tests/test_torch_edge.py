"""The port's edge aggregation (``kernels/ref.py:edge_aggregate_ref`` and
the ``kernels/ops.py`` entry points on CPU tensors) against the JAX
package's ``ops.edge_aggregate`` / ``edge_aggregate_batched``, run as
the Pallas body in interpret mode and through its jnp reference, on the
same numpy inputs; and the plain version's order of summation against a
loop over the edges. The CUDA kernel is held against the plain version
on the card by ``chip_smoke.py`` (phase 7).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _numerics import assert_bitwise, assert_close

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.edge_aggregate import edge_aggregate_cuda

BACKENDS = ("xla", "pallas_interpret")
WIDTHS = (16, 32, 70, 128)      # the routes' and the published widths
N, E, B = 32, 128, 3            # tests/test_model_export.py's sizes


def _problem(d, *, seed, b=B, n=N, e=E):
    rng = np.random.default_rng(seed)
    msgs = rng.normal(size=(b, e, d)).astype(np.float32)
    ei = rng.integers(0, n, size=(b, 2, e)).astype(np.int32)
    mask = (rng.uniform(size=(b, e)) < 0.7).astype(np.float32)
    return msgs, ei, mask


def _jax(msgs, ei, n, mask, reduce, backend, batched=True):
    fn = jops.edge_aggregate_batched if batched else jops.edge_aggregate
    return np.asarray(fn(jnp.asarray(msgs), jnp.asarray(ei), n,
                         None if mask is None else jnp.asarray(mask),
                         reduce=reduce, backend=backend))


def _port(msgs, ei, n, mask, reduce, batched=True):
    fn = tops.edge_aggregate_batched if batched else tops.edge_aggregate
    return fn(torch.from_numpy(msgs), torch.from_numpy(ei), n,
              None if mask is None else torch.from_numpy(mask),
              reduce=reduce).numpy()


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("d", WIDTHS)
def test_batched_matches_jax(backend, reduce, d):
    msgs, ei, mask = _problem(d, seed=d)
    want = _jax(msgs, ei, N, mask, reduce, backend)
    got = _port(msgs, ei, N, mask, reduce)
    assert got.shape == (B, N, d)
    assert_close(got, want, dtype="float32", context=f"{backend}/{reduce}")


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_single_graph_and_none_mask_match_jax(backend, reduce):
    """``edge_aggregate`` (one graph, the batched kernel at B = 1) with
    no mask, on a node count and edge count that fill no tile."""
    msgs, ei, _ = _problem(6, seed=3, b=1, n=50, e=90)
    want = _jax(msgs[0], ei[0], 50, None, reduce, backend, batched=False)
    got = _port(msgs[0], ei[0], 50, None, reduce, batched=False)
    assert_close(got, want, dtype="float32", context=f"{backend}/{reduce}")


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_padded_edges_contribute_nothing(backend, reduce):
    """Padded edges point at node 0 with mask 0, as the model zoo pads
    its edge lists: node 0 gets neither their messages nor their count,
    and the result equals the unpadded graph's."""
    msgs, ei, mask = _problem(32, seed=5)
    pad = 40
    msgs_p = np.concatenate([msgs, 1e3 * np.ones((B, pad, 32), np.float32)],
                            axis=1)
    ei_p = np.concatenate([ei, np.zeros((B, 2, pad), np.int32)], axis=2)
    mask_p = np.concatenate([mask, np.zeros((B, pad), np.float32)], axis=1)
    want = _jax(msgs_p, ei_p, N, mask_p, reduce, backend)
    got = _port(msgs_p, ei_p, N, mask_p, reduce)
    assert_close(got, want, dtype="float32", context=f"{backend}/{reduce}")
    assert_bitwise(got, _port(msgs, ei, N, mask, reduce))


@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_out_of_range_destinations_contribute_nothing(reduce):
    """A dst outside [0, N) is dropped, as the TPU kernel's one-hot rows
    drop it (held against the Pallas body)."""
    msgs, ei, mask = _problem(16, seed=7)
    ei[:, 1, ::5] = np.array([-1, N, N + 9, -40, 2 * N])[
        np.arange(ei[:, 1, ::5].size) % 5].reshape(B, -1)
    want = _jax(msgs, ei, N, mask, reduce, "pallas_interpret")
    got = _port(msgs, ei, N, mask, reduce)
    assert_close(got, want, dtype="float32", context=reduce)


@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_batched_equals_per_graph_loop(reduce):
    """Aggregation is block-diagonal over the micro-batch: each graph of
    the batched call equals the same graph alone, bitwise."""
    msgs, ei, mask = _problem(70, seed=9)
    got = _port(msgs, ei, N, mask, reduce)
    for b in range(B):
        assert_bitwise(got[b], _port(msgs[b], ei[b], N, mask[b], reduce,
                                     batched=False), context=f"graph {b}")


@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_plain_version_replays_the_kernels_order(reduce):
    """The plain version equals, bitwise, a loop over the edges in
    increasing order that adds each ``mask·msg`` product to its node
    (and, for mean, each mask to its node's count), rounding every
    product and sum to f32 — the kernel's order. Fractional masks and
    stray destinations included."""
    rng = np.random.default_rng(11)
    n, e, d = 12, 60, 5
    msgs = rng.normal(size=(2, e, d)).astype(np.float32)
    dst = rng.integers(-2, n + 2, size=(2, e)).astype(np.int32)
    mask = rng.choice(np.float32([0, 0.25, 0.5, 1, 1.5]), size=(2, e))
    want = np.zeros((2, n, d), np.float32)
    cnt = np.zeros((2, n), np.float32)
    for b in range(2):
        for j in range(e):
            i = dst[b, j]
            if 0 <= i < n:
                want[b, i] = want[b, i] + mask[b, j] * msgs[b, j]
                cnt[b, i] = cnt[b, i] + mask[b, j]
    if reduce == "mean":
        want = want / np.maximum(cnt, np.float32(1))[..., None]
    got = tref.edge_aggregate_ref(torch.from_numpy(msgs),
                                  torch.from_numpy(dst),
                                  torch.from_numpy(mask), n_nodes=n,
                                  reduce=reduce)
    assert_bitwise(got.numpy(), want)


def test_ops_route_cpu_tensors_to_plain_version():
    msgs, ei, mask = _problem(16, seed=13)
    before = edge_aggregate_cuda.launches
    got = _port(msgs, ei, N, mask, "mean")
    want = tref.edge_aggregate_ref(
        torch.from_numpy(msgs), torch.from_numpy(ei[:, 1]),
        torch.from_numpy(mask), n_nodes=N, reduce="mean")
    assert_bitwise(got, want.numpy())
    assert edge_aggregate_cuda.launches == before


def test_wrapper_refuses_cpu_tensors_and_unknown_reduce():
    """The kernel wrapper takes CUDA tensors only, never runs the plain
    version itself and counts no launch when it refuses; an unknown
    reduction raises everywhere."""
    msgs = torch.zeros(1, 8, 4)
    dst = torch.zeros(1, 8, dtype=torch.int32)
    mask = torch.ones(1, 8)
    before = edge_aggregate_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        edge_aggregate_cuda(msgs, dst, mask, n_nodes=4)
    with pytest.raises(ValueError, match="reduce"):
        edge_aggregate_cuda(msgs, dst, mask, n_nodes=4, reduce="max")
    with pytest.raises(ValueError, match="reduce"):
        tref.edge_aggregate_ref(msgs, dst, mask, n_nodes=4, reduce="max")
    assert edge_aggregate_cuda.launches == before
