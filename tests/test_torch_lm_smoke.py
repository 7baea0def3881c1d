"""Each of the port's three dense LM configs' ``smoke_lm`` (one AdamW train
step and one decode step, ``repro_torch/configs/lm_common.py``) against
the JAX package's, on the CPU, from the reference's params and tokens
(``PRNGKey(seed)``, carried across by ``convert.from_jax_lm_params``):
the loss and the decode logits within the float32 row, the summed
|Δparams| of the step within ``DELTA_RTOL`` of the reference's (a
parameter whose gradient is near zero steps by ``g / (|g| + eps)``,
which the last bits of g decide). The MoE configs' are in
``test_torch_lm_moe_smoke.py``: the reference's ``smoke_lm`` runs eagerly
(about 10 s an arch), and a file is the unit the test workers share out.
"""
import jax
import numpy as np
import pytest
import torch
from _numerics import assert_close
from test_torch_lm import _two_threads  # noqa: F401 (autouse)

from repro import configs as jconfigs
from repro.configs import lm_common as jlm
from repro.models import transformer as jtr
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.configs import lm_common as tlm

LM_ARCHS = ["olmo-1b", "yi-9b", "granite-34b"]
DELTA_RTOL = 1e-4


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
