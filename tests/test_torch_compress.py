"""The port's int8 compressed all-reduce with error feedback
(``repro_torch/optim/compress.py``) against the JAX package's, on the
CPU: 4 gloo ranks, each compressing its own gradient tree for 3 rounds
of error feedback, equal bitwise on every rank to the reference's
``compressed_tree_psum`` under ``jax.vmap(..., axis_name="dp")`` of the
same 4 shards (``pmax`` and ``psum`` over a named vmap axis on one
device). One rank of the world is ``tests/_gloo_ranks.py compress``.
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _blas_threads import _blas_two_threads  # noqa: F401 (autouse)

from repro.optim.compress import compressed_tree_psum as jpsum
from repro.optim.compress import error_feedback_init as jinit
from repro_torch.optim import compress as tcompress

REPO = Path(__file__).resolve().parent.parent
WORLD = 4


def _port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_ranks(case, tmp_path, world=WORLD):
    """``tests/_gloo_ranks.py CASE`` started on ``world`` processes."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               OMP_NUM_THREADS="1")
    port = _port()
    return [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "_gloo_ranks.py"), case,
         str(r), str(world), str(port), str(tmp_path)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def run_ranks(case, tmp_path, world=WORLD, procs=None):
    """``tests/_gloo_ranks.py CASE`` on ``world`` processes (``procs``:
    those :func:`start_ranks` started), waited for."""
    procs = procs or start_ranks(case, tmp_path, world)
    outs = [p.communicate(timeout=240)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]


def _grads(rank):
    """The gradients rank ``rank`` draws (as ``_gloo_ranks.py``)."""
    rng = np.random.default_rng(100 + rank)
    return {"a": rng.normal(size=(6, 5)).astype(np.float32),
            "b": {"c": (rng.normal(size=(7,)) * 1e-3).astype(np.float32)}}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("compress")
    run_ranks("compress", out)
    return [dict(np.load(out / f"compress_{r}.npz")) for r in range(WORLD)]


def _reference():
    grads = jax.tree_util.tree_map(lambda *x: jnp.stack(x),
                                   *[_grads(r) for r in range(WORLD)])
    err = jinit(grads)
    f = jax.vmap(lambda g, e: jpsum(g, e, "dp", WORLD), axis_name="dp")
    rounds = []
    for rd in range(3):
        g = {"a": grads["a"] * (rd + 1), "b": {"c": grads["b"]["c"] - rd}}
        out, err = f(g, err)
        rounds.append((out, err))
    return rounds


@pytest.mark.parametrize("rank", range(WORLD))
def test_compressed_psum_bitwise_over_gloo(ranks, rank):
    got = ranks[rank]
    for rd, (out, err) in enumerate(_reference()):
        for part, tree in (("out", out), ("err", err)):
            for key, want in (("a", tree["a"][rank]),
                              ("b/c", tree["b"]["c"][rank])):
                np.testing.assert_array_equal(
                    got[f"{rd}/{part}/{key}"], np.asarray(want),
                    err_msg=f"round {rd} {part} {key}")
    # every rank holds the same reduced gradient
    for key in ("0/out/a", "2/out/b/c"):
        np.testing.assert_array_equal(got[key], ranks[0][key])


def test_error_feedback_init_and_world_of_one():
    """A world of one (gloo): the reduction is the rank's own quantized
    gradient, and the residual is what quantization dropped."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import destroy_host_mesh, make_host_mesh
    g = {"w": torch.linspace(-1.0, 1.0, 11), "b": [torch.ones(3)]}
    err = tcompress.error_feedback_init(g)
    assert torch.equal(err["w"], torch.zeros(11))
    assert err["b"][0].dtype == torch.float32
    make_host_mesh("cpu")
    try:
        out, new_err = tcompress.compressed_tree_psum(g, err,
                                                      dist.group.WORLD, 1)
    finally:
        destroy_host_mesh()
    for key in ("w",):
        assert torch.equal(out[key] + new_err[key], g[key])
    assert torch.allclose(out["b"][0], torch.ones(3))
