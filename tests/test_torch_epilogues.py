"""The kernels' last epilogue forms, their plain versions against the JAX
package on the CPU: gelu and silu in both denses and both GravNet
blocks, the blocks whose output dense reads the aggregate alone
(``concat_x=False``), and the int8 block's requantized output.

The JAX side runs ``repro.kernels.ops`` with the Pallas kernels in
interpret mode, as ``tests/test_kernels_fused_dense.py`` and
``tests/test_fusion_block.py`` run them; the port's side runs
``kernels/ref.py``, which ``chip_smoke.py`` holds the CUDA kernels to on
the card (bitwise under none and relu; within the float32 row under gelu
and silu, whose tanhf and expf round as CUDA's do). The tolerances:
the float32 row for f32 outputs; for the int8 block the calibration
bound of ``int8_flip_tolerance`` (the two packages quantize h on the
same grid, and a value within an ulp of a step may land on either side);
an int8 output one step of ``out_scale`` on top. On the CPU every entry
point of ``kernels/ops.py`` runs the plain version and counts no launch.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _numerics import (assert_bitwise, assert_calibration_close,
                       assert_close, int8_flip_tolerance)

from repro.kernels import ops as jops
from repro_torch.kernels import f32_cases, int8_cases
from repro_torch.kernels import gravnet_block as bmod
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.fused_dense import (act_code, fused_dense_cuda,
                                             fused_dense_int8_cuda)

ACTS = ("none", "relu", "gelu", "silu")
#: events, hits, d_hidden, d_s, d_f, d_out of the block checks: the
#: reference's smoke widths, and the upgrade widths at a few hits
BLOCK_SHAPES = {"smoke": (2, 16, 24, 3, 8, 24), "upgrade": (2, 24, 64, 4,
                                                            22, 64)}
K = 4


def _t(a):
    return torch.from_numpy(np.array(a))


def _no_launch(wrapper, fn):
    """fn() on CPU tensors: the plain version, no launch counted."""
    before = wrapper.launches
    out = fn()
    assert wrapper.launches == before
    return out


@pytest.mark.parametrize("activation", ACTS)
def test_dense_activation_matches_jax(activation):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 48)).astype(np.float32) * 2
    w = rng.normal(size=(48, 16)).astype(np.float32) / 4
    b = rng.normal(size=(16,)).astype(np.float32)
    want = np.asarray(jops.fused_dense(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        activation=activation, backend="pallas_interpret", bm=16, bn=16,
        bk=16))
    got = tref.fused_dense_ref(_t(x), _t(w), _t(b), activation=activation)
    assert_close(got.numpy(), want, dtype="float32", context=activation)
    routed = _no_launch(fused_dense_cuda, lambda: tops.fused_dense_batched(
        _t(x)[None], _t(w), _t(b), activation=activation))
    assert_bitwise(routed[0].numpy(), got.numpy())


@pytest.mark.parametrize("out_int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("activation", ACTS)
def test_dense_int8_activation_matches_jax(activation, out_int8):
    (xq, wq, b, xs, ws), out_scale = int8_cases.dense_inputs(40, 64, 24,
                                                             seed=3)
    want = np.asarray(jops.fused_dense_int8(
        jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(b),
        jnp.asarray([[xs]], jnp.float32), jnp.asarray(ws),
        activation=activation, out_scale=out_scale,
        out_dtype=jnp.int8 if out_int8 else jnp.float32,
        backend="pallas_interpret", bm=16, bn=16, bk=32))
    args = (_t(xq), _t(wq), _t(b), xs, _t(ws))
    kw = dict(activation=activation, out_int8=out_int8, out_scale=out_scale)
    got = tref.fused_dense_int8_ref(*args, **kw)
    assert got.dtype == (torch.int8 if out_int8 else torch.float32)
    if out_int8:   # a quotient at a half step may round either way
        assert_calibration_close(got.numpy() * out_scale,
                                 want.astype(np.float64) * out_scale,
                                 quantum=out_scale, context=activation)
    else:
        assert_close(got.numpy(), want, dtype="float32", context=activation)
    routed = _no_launch(fused_dense_int8_cuda,
                        lambda: tops.fused_dense_int8(*args, **kw))
    assert_bitwise(routed.numpy(), got.numpy())


def _f32_block(shape, concat_x, seed=1):
    b, n, dh, ds, df, dout = shape
    ops = list(f32_cases.block_inputs(b, n, dh=dh, ds=ds, df=df, dout=dout,
                                      seed=seed, n_valid=n * 3 // 4))
    if not concat_x:   # the output dense's agg rows alone: (2·df, d_out)
        ops[6] = np.ascontiguousarray(ops[6][dh:])
    return ops


@pytest.mark.parametrize("concat_x", [True, False], ids=["concat", "agg"])
@pytest.mark.parametrize("activation", ACTS)
@pytest.mark.parametrize("shape", sorted(BLOCK_SHAPES))
def test_block_forms_match_jax(shape, activation, concat_x):
    """The f32 block: x, ws and bs on dyadic grids make every distance
    exact in both packages, so both pick the same neighbours."""
    ops = _f32_block(BLOCK_SHAPES[shape], concat_x)
    kw = dict(k=K, activation=activation, concat_x=concat_x)
    want = np.asarray(jops.gravnet_block_batched(
        *(jnp.asarray(a) for a in ops), **kw, backend="pallas_interpret"))
    targs = [_t(a) for a in ops]
    got = tref.gravnet_block_ref(*targs, **kw)
    assert got.shape == want.shape
    assert_close(got.numpy(), want, dtype="float32",
                 context=f"{activation} concat_x={concat_x}")
    routed = _no_launch(bmod.gravnet_block_cuda,
                        lambda: tops.gravnet_block(*(t[0] if i < 2 else t
                                                     for i, t in
                                                     enumerate(targs)),
                                                   **kw))
    assert_bitwise(routed.numpy(), got[0].numpy())


def _int8_block(shape, concat_x, seed=2):
    b, n, dh, ds, df, dout = shape
    ops, scales = int8_cases.block_inputs(b, n, dh=dh, ds=ds, df=df,
                                          dout=dout, seed=seed,
                                          n_valid=n * 3 // 4, dup=2)
    ops = list(ops)
    if not concat_x:
        ops[6] = np.ascontiguousarray(ops[6][dh:])
    return ops, scales


OUTS = {"f32": (False, 1.0), "int8": (True, 0.05),
        "int8_subnormal_quotients": (True, 1e38)}


@pytest.mark.parametrize("out", sorted(OUTS))
@pytest.mark.parametrize("concat_x", [True, False], ids=["concat", "agg"])
@pytest.mark.parametrize("activation", ["relu", "gelu", "silu"])
def test_int8_block_forms_match_jax(activation, concat_x, out):
    """The quantized block: concat_x, the int8 output (at a scale whose
    quotients are subnormal too, the kernels' division path), the
    activations; held to the calibration bound of the two packages'
    grids, the int8 output to one step more."""
    out_int8, out_scale = OUTS[out]
    ops, sc = _int8_block(BLOCK_SHAPES["upgrade"], concat_x)
    kw = dict(sc, k=K, activation=activation, concat_x=concat_x)
    want = np.asarray(jops.gravnet_block_int8_batched(
        *(jnp.asarray(a) for a in ops), **kw, out_scale=out_scale,
        out_dtype=jnp.int8 if out_int8 else jnp.float32,
        backend="pallas_interpret"))
    targs = [_t(a) for a in ops]
    tkw = dict(kw, out_int8=out_int8, out_scale=out_scale)
    got = tref.gravnet_block_int8_ref(*targs, **tkw)
    assert got.dtype == (torch.int8 if out_int8 else torch.float32)
    assert got.shape == want.shape
    quantum = int8_flip_tolerance(sc["h_scale"], ops[10])
    scale = out_scale if out_int8 else 1.0
    assert_calibration_close(got.numpy() * np.float64(scale),
                             want.astype(np.float64) * scale,
                             quantum=quantum + (out_scale if out_int8
                                                else 0.0),
                             context=f"{activation} {out}")
    routed = _no_launch(bmod.gravnet_block_int8_cuda,
                        lambda: tops.gravnet_block_int8_batched(*targs,
                                                                **tkw))
    assert_bitwise(routed.numpy(), got.numpy())


def test_int8_output_subnormal_quotients_round_to_zero():
    """At out_scale 1e38 every quotient of the block's outputs lies below
    the normal range: the plain version's division rounds each to 0, as
    the kernel's division fallback must."""
    ops, sc = _int8_block(BLOCK_SHAPES["smoke"], True)
    got = tref.gravnet_block_int8_ref(*(_t(a) for a in ops), **sc, k=K,
                                      activation="none", out_int8=True,
                                      out_scale=1e38)
    assert got.dtype == torch.int8 and not bool(got.any())


@pytest.mark.parametrize("concat_x", [True, False])
def test_block_wrappers_check_the_output_dense(concat_x):
    """Each block wrapper wants wo of (d_h + 2·d_f) rows, or 2·d_f
    without concat_x, and refuses CPU tensors without counting a
    launch."""
    ops = [_t(a) for a in _f32_block(BLOCK_SHAPES["smoke"], concat_x)]
    before = bmod.gravnet_block_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        bmod.gravnet_block_cuda(*ops, k=K, concat_x=concat_x)
    with pytest.raises(ValueError, match="wo"):
        bmod.gravnet_block_cuda(*ops, k=K, concat_x=not concat_x)
    qops, sc = _int8_block(BLOCK_SHAPES["smoke"], concat_x)
    qops = [_t(a) for a in qops]
    with pytest.raises(ValueError, match="CUDA"):
        bmod.gravnet_block_int8_cuda(*qops, **sc, k=K, concat_x=concat_x,
                                     out_int8=True, out_scale=0.1)
    with pytest.raises(ValueError, match="wo_q"):
        bmod.gravnet_block_int8_cuda(*qops, **sc, k=K,
                                     concat_x=not concat_x)
    assert bmod.gravnet_block_cuda.launches == before


def test_plans_take_the_smaller_output_dense():
    """Without concat_x the f32 block stages a Wo and an h of 2·d_f
    columns: its shared memory shrinks by d_h rows of Wo and columns of
    h, and the register cell takes a shape whose concat form does not
    fit (128 hits, d_hidden 128, d_f 64, d_out 128)."""
    for n, dh, ds, df, dout in ((128, 64, 4, 22, 64), (512, 192, 4, 22, 64),
                                (600, 24, 3, 8, 24)):
        for cell in ("register", "shared"):
            cat = bmod.smem_bytes(n, dh, ds, df, dout, 16, cell)
            agg = bmod.smem_bytes(n, dh, ds, df, dout, 16, cell,
                                  concat_x=False)
            if cell == "register":
                assert cat - agg == 4 * (dh * ((dout + 3) // 4 * 4)
                                         + 16 * (((2 * df + dh + 3) // 4 * 4)
                                                 - (2 * df + 3) // 4 * 4))
            else:
                assert cat - agg == 4 * dh * dout
    assert bmod.plan(128, 128, 4, 64, 128) == (32, "shared")
    assert bmod.plan(128, 128, 4, 64, 128, concat_x=False) == (16,
                                                              "register")
    assert bmod.plan(600, 24, 3, 8, 24, concat_x=False) == (32, "shared")


@pytest.mark.parametrize("activation,code", [(None, 0), ("none", 0),
                                             ("linear", 0), ("relu", 1),
                                             ("gelu", 2), ("silu", 3)])
def test_act_codes(activation, code):
    """The epilogue codes of csrc/activation.cuh; an unknown name raises
    before any launch."""
    assert act_code(activation) == code


def test_unknown_activation_raises():
    with pytest.raises(ValueError, match="tanh"):
        act_code("tanh")
    with pytest.raises(ValueError, match="tanh"):
        tref.fused_dense_ref(torch.zeros(2, 3), torch.zeros(3, 4),
                             activation="tanh")
