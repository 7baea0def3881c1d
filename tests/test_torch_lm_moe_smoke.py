"""The port's two MoE LM configs (granite-moe-1b-a400m,
llama4-maverick-400b-a17b) against the JAX package's, on the CPU: each
``smoke_lm`` (as in ``test_torch_lm_smoke.py``), and llama4-maverick's
q8 AdamW state carried across and stepped on. Apart from the dense
configs' file so that the test workers run the two in parallel.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _numerics import assert_close
from test_torch_lm import _two_threads  # noqa: F401 (autouse)
from test_torch_lm_smoke import DELTA_RTOL

from repro import configs as jconfigs
from repro.configs import lm_common as jlm
from repro.models import transformer as jtr
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.checkpoint.manager import flatten
from repro_torch.configs import lm_common as tlm
from repro_torch.models import transformer as ttr
from repro_torch.optim import adamw_update as tadamw_update
from repro_torch.optim.step import value_and_grad

LM_ARCHS = ["granite-moe-1b-a400m", "llama4-maverick-400b-a17b"]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_smoke_lm_matches_reference(arch):
    ref, mod = jconfigs.get_arch(arch), tconfigs.get_arch(arch)
    jcfg, tcfg = ref.smoke_config(), mod.smoke_config()
    want = jlm.smoke_lm(jcfg, seed=0)
    key = jax.random.PRNGKey(0)
    params = convert.from_jax_lm_params(jax.tree_util.tree_map(
        np.asarray, jtr.init_params(key, jcfg)), tcfg, device="cpu")
    toks = torch.from_numpy(np.array(
        jax.random.randint(key, (2, 16), 0, jcfg.vocab)))
    got = tlm.smoke_lm(tcfg, 0, "cpu", params=params, tokens=toks)
    assert_close(got["loss"].numpy(), np.asarray(want["loss"]),
                 dtype="float32", context="loss")
    assert_close(got["logits"].numpy(), np.asarray(want["logits"]),
                 dtype="float32", context="logits")
    assert got["params_delta"] == pytest.approx(want["params_delta"],
                                                rel=DELTA_RTOL)


def test_adamw_q8_state_converts_and_steps():
    """llama4-maverick's cells train with q8 AdamW moments
    (``opt_config(quantize=True)``): the reference's state after one
    step, carried across by ``convert.from_jax_adamw_state``, steps on in
    the port as in the reference (parameters and moments within the
    float32 row; a q8 moment's int8 values within one step)."""
    arch = "llama4-maverick-400b-a17b"
    jcfg = jconfigs.get_arch(arch).smoke_config()
    tcfg = tconfigs.get_arch(arch).smoke_config()
    ocfg_j = jlm.opt_config(jcfg, quantize=True)
    ocfg_t = tlm.opt_config(tcfg, quantize=True)
    jp = jtr.init_params(jax.random.PRNGKey(5), jcfg)
    toks = np.random.default_rng(6).integers(0, jcfg.vocab, (2, 16)
                                             ).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    grad = jax.grad(lambda p: jtr.loss_fn(p, jb, jcfg)[0])
    jo = jadamw_init(jp, ocfg_j)
    jp, jo, _ = jadamw_update(grad(jp), jo, jp, lr=1e-3, cfg=ocfg_j)
    tp = convert.from_jax_lm_params(jax.tree_util.tree_map(np.asarray, jp),
                                    tcfg, device="cpu")
    to = convert.from_jax_adamw_state(jax.tree_util.tree_map(np.asarray, jo),
                                      tcfg, device="cpu")
    assert set(to["m"]["layers"]["wq"]) == {"q", "scale"}
    jp2, jo2, _ = jadamw_update(grad(jp), jo, jp, lr=1e-3,
                                 cfg=ocfg_j)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, tg = value_and_grad(lambda p: ttr.loss_fn(p, tb, tcfg), tp)
    tp2, to2, _ = tadamw_update(tg, to, tp, lr=1e-3, cfg=ocfg_t)
    jleaves = dict(flatten(jax.tree_util.tree_map(np.asarray,
                                                  {"p": jp2, "o": jo2})))
    for name, t in flatten({"p": tp2, "o": to2}):
        want = jleaves[name]
        if t.dtype == torch.int8:
            assert np.abs(t.numpy().astype(np.int32)
                          - want.astype(np.int32)).max() <= 1, name
        else:
            assert_close(t.numpy(), want, dtype="float32", context=name)
