"""The port's five LM configs (``repro_torch/configs/{olmo_1b, yi_9b,
granite_34b, granite_moe_1b_a400m, llama4_maverick_400b_a17b}.py``),
``configs/lm_common.py`` and ``data/lm.py`` against the JAX package's, on
the CPU.

- The configs field for field, the dtypes mapped; ``SHAPES``;
  ``opt_config``; each cell builder's cells (name, kind, MODEL_FLOPS;
  ``test_torch_cells.py`` holds them leaf for leaf).
- ``lm_batch`` and ``lm_stream`` byte-equal to the reference's.
- The converters: the reference's prefill cache decodes on in the port
  (``convert.from_jax_kv_cache``); its q8 AdamW state after one step
  (``opt_config(quantize=True)``, llama4-maverick's) steps on in the port
  (``convert.from_jax_adamw_state``): parameters and moments within the
  float32 row, a q8 moment's int8 values within one step of a rounding
  (in ``test_torch_lm_moe_smoke.py``, beside llama4-maverick's
  ``smoke_lm``, whose reference compiles the same ops).

Each arch's ``smoke_lm`` against the reference's is in
``test_torch_lm_smoke.py`` (the dense archs) and
``test_torch_lm_moe_smoke.py`` (the MoE archs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _numerics import assert_close
from test_torch_lm import _two_threads  # noqa: F401 (autouse)

from repro import configs as jconfigs
from repro.configs import lm_common as jlm
from repro.data.lm import lm_batch as jlm_batch
from repro.models import transformer as jtr
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.configs import lm_common as tlm
from repro_torch.data.lm import lm_batch, lm_stream
from repro_torch.models import transformer as ttr

LM_ARCHS = ["olmo-1b", "yi-9b", "granite-34b", "granite-moe-1b-a400m",
            "llama4-maverick-400b-a17b"]
_DT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _mapped(cfg):
    """A reference config's fields as the port's would read."""
    out = dict(cfg.__dict__)
    for k in ("param_dtype", "compute_dtype"):
        out[k] = _DT[out[k]]
    if cfg.moe is not None:
        out["moe"] = cfg.moe.__dict__
    return out


def _fields(cfg):
    out = dict(cfg.__dict__)
    if cfg.moe is not None:
        out["moe"] = cfg.moe.__dict__
    return out


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_configs_match_reference(arch):
    mod, ref = tconfigs.get_arch(arch), jconfigs.get_arch(arch)
    assert (mod.ARCH_ID, mod.FAMILY, mod.SHAPES) == \
        (ref.ARCH_ID, ref.FAMILY, ref.SHAPES)
    for fn in ("full_config", "smoke_config"):
        assert _fields(getattr(mod, fn)()) == _mapped(getattr(ref, fn)())
    full = mod.full_config()
    for args in ((256, 4096, True), (32, 32768, False)):
        assert mod.tr.model_flops(full, args[0], args[1],
                                  training=args[2]) == \
            jtr.model_flops(ref.full_config(), args[0], args[1],
                            training=args[2])
    for shape in mod.SHAPES:
        cell, want = mod.cell(shape), ref.cell(shape)
        assert (cell.name, cell.kind, cell.model_flops) == \
            (want.name, want.kind, want.model_flops)


def _same(cell, want):
    assert (cell.arch, cell.shape, cell.kind, cell.model_flops) == \
        (want.arch, want.shape, want.kind, want.model_flops)


def test_lm_common():
    assert tlm.SHAPES == jlm.SHAPES
    cfg = tconfigs.get_arch("olmo-1b").full_config()
    jcfg = jconfigs.get_arch("olmo-1b").full_config()
    for q in (False, True):
        assert tlm.opt_config(cfg, quantize=q).__dict__ == \
            jlm.opt_config(None, quantize=q).__dict__
    _same(tlm.train_cell("olmo-1b", cfg, batch=8, seq=512),
          jlm.train_cell("olmo-1b", jcfg, batch=8, seq=512))
    _same(tlm.prefill_cell("olmo-1b", cfg),
          jlm.prefill_cell("olmo-1b", jcfg))
    _same(tlm.decode_cell("olmo-1b", cfg, "long_500k"),
          jlm.decode_cell("olmo-1b", jcfg, "long_500k"))
    got, want = tlm.cells_for("olmo-1b", cfg), jlm.cells_for("olmo-1b", jcfg)
    assert list(got) == list(want)
    for shape in got:
        _same(got[shape](), want[shape]())
    (c, L), (jc, jL) = (tlm.cost_cells("olmo-1b", cfg, "train_4k"),
                        jlm.cost_cells("olmo-1b", jcfg, "train_4k"))
    assert L == jL == 16 and sorted(c) == sorted(jc) == [2, 4]
    for lred in (2, 4):
        _same(c[lred], jc[lred])
        assert _fields(tlm._cost_cfg(cfg, lred)) == _mapped(
            jlm._cost_cfg(jcfg, lred))


def test_smoke_run_draws_its_own_weights():
    got = tconfigs.get_arch("granite-moe-1b-a400m").smoke_run(seed=1,
                                                              device="cpu")
    assert tuple(got["logits"].shape) == (2, 128)
    assert bool(torch.isfinite(got["loss"])) and got["params_delta"] > 0


def test_lm_batch_byte_equal():
    for vocab, b, s, seed, step in ((128, 16, 64, 0, 0), (50304, 4, 33, 7, 3),
                                    (97, 1, 8, 2, 100)):
        got = lm_batch(vocab, b, s, seed=seed, step=step)
        want = jlm_batch(vocab, b, s, seed=seed, step=step)
        assert sorted(got) == sorted(want) == ["labels", "tokens"]
        for k in want:
            assert got[k].dtype == want[k].dtype == np.int32
            assert got[k].tobytes() == want[k].tobytes(), k
    stream = lm_stream(128, 2, 16, seed=3, start_step=5)
    for step in (5, 6):
        want = jlm_batch(128, 2, 16, seed=3, step=step)
        got = next(stream)
        assert all(got[k].tobytes() == want[k].tobytes() for k in want)


def test_kv_cache_converter_continues_the_reference_prefill():
    """The reference's prefill cache, carried across by
    ``convert.from_jax_kv_cache`` (padded to a longer cache), decodes on
    in the port as it does in the reference."""
    jcfg = jconfigs.get_arch("yi-9b").smoke_config()
    tcfg = tconfigs.get_arch("yi-9b").smoke_config()
    jp = jtr.init_params(jax.random.PRNGKey(3), jcfg)
    tp = convert.from_jax_lm_params(jax.tree_util.tree_map(np.asarray, jp),
                                    tcfg, device="cpu")
    toks = np.random.default_rng(4).integers(0, jcfg.vocab, (2, 16)
                                             ).astype(np.int32)
    _, jc = jtr.prefill(jp, jnp.asarray(toks), jcfg)
    jc = {k: (jnp.pad(v, [(0, 0), (0, 0), (0, 4), (0, 0), (0, 0)])
              if v.ndim == 5 else v) for k, v in jc.items()}
    tc = convert.from_jax_kv_cache(jax.tree_util.tree_map(np.asarray, jc),
                                   tcfg, device="cpu")
    assert tc["k"].dtype == torch.float32 and tc["pos"].dtype == torch.int32
    nxt = np.full((2, 1), 5, np.int32)
    jl, jc2 = jtr.decode_step(jp, jc, jnp.asarray(nxt), jcfg)
    tl, tc2 = ttr.decode_step(tp, tc, torch.from_numpy(nxt), tcfg)
    assert_close(tl.numpy(), np.asarray(jl), dtype="float32")
    assert_close(tc2["k"].numpy(), np.asarray(jc2["k"]), dtype="float32")
    with pytest.raises(ValueError, match="want"):
        convert.from_jax_kv_cache({"k": np.zeros((1, 2, 3, 4, 5))}, tcfg,
                                  device="cpu")
