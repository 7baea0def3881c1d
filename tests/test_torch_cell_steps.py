"""The LM cells' steps in the port against the JAX package's, on the CPU:
``make_step(mesh)`` at smoke width on a world of one (gloo, the
arguments DTensors placed by ``resolve_shardings``) against the
reference's ``make_step`` on its (1, 1) host mesh (Auto axes, jitted)
on the same numpy inputs and weights, within the float32 row: train
(dense, MoE, q8 moments), prefill and decode; and
``lm_common.CapturedDecode`` against eager ``decode_step``s. The other
families' cells: ``test_torch_cell_steps_models.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _blas_threads import _blas_two_threads  # noqa: F401 (autouse)
from _numerics import assert_close
from test_torch_cells import _named
from test_torch_lm import _two_threads  # noqa: F401 (autouse)

from repro import configs as jconfigs
from repro.configs import lm_common as jlm
from repro.dist.sharding import _path_str
from repro.models import transformer as jtr
from repro.optim import adamw as jadamw
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.configs import lm_common as tlm
from repro_torch.configs.base import distribute
from repro_torch.launch.mesh import destroy_host_mesh, make_host_mesh


@pytest.fixture(scope="module")
def host():
    mesh = make_host_mesh("cpu")
    yield mesh
    destroy_host_mesh()


def jhost_mesh():
    """The reference's host mesh, (1, 1) ("data", "model"), with Auto
    axes: ``jax.make_mesh``'s default Explicit axes refuse the
    reference's ``with_sharding_constraint`` in this JAX."""
    from jax.sharding import AxisType
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))


def _jit(step):
    """The reference's step as its dry-run lowers it, jitted (its eager
    run retraces every scan and takes many times longer)."""
    return jax.jit(step)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  _np(tree))


def local(tree):
    """Each DTensor of ``tree`` gathered whole."""
    from torch.distributed.tensor import DTensor

    from repro_torch.dist.sharding import map_leaves
    return map_leaves(lambda x: x.full_tensor() if isinstance(x, DTensor)
                      else x, tree)


def _check(got, want, *, dtype="float32"):
    want = {_path_str(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(want)[0]}
    got = dict(_named(local(got)))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name].detach().numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            assert_close(g, w, dtype=dtype, context=name)


def _run(tcell, host, targs):
    return tcell.make_step(host)(*distribute(targs,
                                             tcell.resolve_shardings(host)))


def _lm(arch, kind, host, quantize=False):
    jcfg = jconfigs.get_arch(arch).smoke_config()
    tcfg = tconfigs.get_arch(arch).smoke_config()
    jmesh = jhost_mesh()
    params = _np(jtr.init_params(jax.random.PRNGKey(3), jcfg))
    tparams = convert.from_jax_lm_params(params, tcfg, device="cpu")
    toks = np.random.default_rng(3).integers(
        0, jcfg.vocab, (2, 16)).astype(np.int32)
    if kind == "train":
        batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
        jcell = jlm.train_cell(arch, jcfg, batch=2, seq=16,
                               quantize_opt=quantize)
        ocfg = jlm.opt_config(jcfg, quantize=quantize)
        opt = _np(jadamw.adamw_init(params, ocfg))
        want = _jit(jcell.make_step(jmesh))(params, opt, batch)
        tcell = tlm.train_cell(arch, tcfg, batch=2, seq=16,
                               quantize_opt=quantize)
        got = _run(tcell, host, (tparams, convert.from_jax_adamw_state(
            opt, tcfg, device="cpu"), _t(batch)))
    elif kind == "prefill":
        want = _jit(jlm.prefill_cell(arch, jcfg).make_step(jmesh))(
            params, toks)
        tcell = tlm.prefill_cell(arch, tcfg, batch=2, seq=16)
        got = _run(tcell, host, (tparams, torch.from_numpy(toks)))
    else:
        rng = np.random.default_rng(4)
        cache = _np(jtr.init_cache(jcfg, 2, 24, dtype=jnp.float32))
        cache = {k: (rng.normal(size=v.shape).astype(np.float32)
                     if k in ("k", "v") else np.full_like(v, 5))
                 for k, v in cache.items()}
        want = _jit(jlm.decode_cell(arch, jcfg, "decode_32k").make_step(
            jmesh))(params, cache, toks[:, :1])
        tcell = tlm.decode_cell(arch, tcfg, "decode_32k", batch=2, seq=24)
        got = _run(tcell, host, (tparams, convert.from_jax_kv_cache(
            cache, tcfg, device="cpu"), torch.from_numpy(toks[:, :1])))
    _check(got, want)


STEPS = {
    "lm-train": lambda h: _lm("olmo-1b", "train", h),
    "lm-prefill": lambda h: _lm("olmo-1b", "prefill", h),
    "lm-decode": lambda h: _lm("olmo-1b", "decode", h),
    "moe-train": lambda h: _lm("granite-moe-1b-a400m", "train", h),
    "moe-decode": lambda h: _lm("granite-moe-1b-a400m", "decode", h),
    "q8-train": lambda h: _lm("llama4-maverick-400b-a17b", "train", h,
                              quantize=True),
}


@pytest.mark.parametrize("case", list(STEPS))
def test_step_on_a_world_of_one_matches_reference(host, case):
    STEPS[case](host)


@pytest.mark.parametrize("arch,int8", [("olmo-1b", False),
                                       ("granite-moe-1b-a400m", True)])
def test_captured_decode_equals_eager_decode_steps(arch, int8):
    """``lm_common.CapturedDecode`` through a stand-in capture backend
    (capture runs the step, replay re-runs it into the same static
    storage): 5 steps, each step's logits and the cache at the end
    bitwise equal to 5 eager ``decode_step``s from the same cache; the
    warm-up and the capture advance nothing."""
    import dataclasses

    from test_torch_capture import FakeGraphs

    from repro_torch.models import transformer as ttr
    cfg = dataclasses.replace(tconfigs.get_arch(arch).smoke_config(),
                              kv_cache_int8=int8)
    gen = torch.Generator().manual_seed(8)
    params = ttr.init_params(gen, cfg)
    cache = ttr.init_cache(cfg, 2, 12, dtype=torch.float32, device="cpu")
    for n in ("k", "v"):
        if int8:
            cache[n].copy_(torch.randint(-127, 128, cache[n].shape,
                                         generator=gen, dtype=torch.int8))
            cache[f"{n}_scale"].copy_(torch.rand(cache[f"{n}_scale"].shape,
                                                 generator=gen))
        else:
            cache[n].copy_(torch.randn(cache[n].shape, generator=gen))
    cache["pos"].fill_(4)
    toks = torch.randint(0, cfg.vocab, (2, 5), generator=gen,
                         dtype=torch.int32)
    eager = {k: v.clone() for k, v in cache.items()}
    backend = FakeGraphs()
    cap = tlm.CapturedDecode(params, cache, cfg, backend=backend)
    for t in range(5):
        got = cap(toks[:, t:t + 1]).clone()
        want, eager = ttr.decode_step(params, eager, toks[:, t:t + 1], cfg)
        assert torch.equal(got, want), t
    assert cap.captured and backend.captured == 1
    for k in cache:
        assert torch.equal(cache[k], eager[k]), k
    assert int(cache["pos"][0, 0]) == 9
