"""The port's quantizers and the plain versions of its int8 and
aggregation kernels (``repro_torch/kernels/ref.py``) against the JAX
package's, on the same numpy inputs: integer parts (int8 weights, int32
accumulators) bitwise, f32 parts to the ``float32`` row, requantized
int8 outputs to one quantization step, and the quantized block to
``int8_flip_tolerance``. The JAX kernels run in interpret mode and
through their jnp reference; the CUDA kernels are held against these
plain versions on the card by ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _numerics import (assert_bitwise, assert_calibration_close,
                       assert_close, int8_flip_tolerance)

from repro.core.quantization import activation_scale as j_activation_scale
from repro.core.quantization import quantize_weight as j_quantize_weight
from repro.kernels import ops as jops
from repro_torch.core.quantization import activation_scale, quantize_weight
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.fused_dense import fused_dense_int8_cuda
from repro_torch.kernels.gravnet import gravnet_aggregate_cuda
from repro_torch.kernels.gravnet_block import gravnet_block_int8_cuda

BACKENDS = ("xla", "pallas_interpret")
# smoke widths (repro/configs/caloclusternet.py:smoke_config)
N, DH, DS, DF, K = 16, 24, 3, 8, 4


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------ quantizers ----
@pytest.mark.parametrize("shape,spread", [
    ((24, 24), 1.0), ((4, 64), 30.0), ((108, 7), 0.01), ((44, 1), 1.0)])
def test_quantize_weight_matches_jax(shape, spread):
    rng = np.random.default_rng(shape[0] * 7 + shape[1])
    w = (rng.normal(size=shape) * spread).astype(np.float32)
    if shape[1] > 1:
        w[:, 0] = 0.0          # an all-zero channel
    jq, js = j_quantize_weight(jnp.asarray(w))
    tq, ts = quantize_weight(_t(w))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert_bitwise(tq.numpy(), np.asarray(jq), context="w_q")
    assert_bitwise(ts.numpy(), np.asarray(js), context="w_scale")


@pytest.mark.parametrize("absmax", [0.0, 1e-12, 0.123, 3.0, 127.0,
                                    np.float32(0.0117)])
def test_activation_scale_matches_jax(absmax):
    got = activation_scale(absmax)
    assert isinstance(got, float)
    assert got == j_activation_scale(absmax)


# --------------------------------------------------------- int8 dense ----
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("m,kdim,n,act,out_int8", [
    (48, 24, 24, "relu", True), (32, 4, 24, "relu", False),
    (37, 44, 7, "none", True), (16, 108, 24, "relu", False)])
def test_fused_dense_int8_ref_matches_jax(backend, m, kdim, n, act,
                                          out_int8):
    rng = np.random.default_rng(m * 100 + kdim)
    x_q = rng.integers(-127, 128, (m, kdim)).astype(np.int8)
    w = (rng.normal(size=(kdim, n)) / np.sqrt(kdim)).astype(np.float32)
    b = (rng.normal(size=(n,)) * 0.1).astype(np.float32)
    w_q, w_scale = j_quantize_weight(jnp.asarray(w))
    x_scale, out_scale = 0.0123456789, 0.0371
    want = np.asarray(jops.fused_dense_int8(
        jnp.asarray(x_q), w_q, jnp.asarray(b),
        jnp.asarray(x_scale, jnp.float32).reshape(1, 1), w_scale,
        activation=act, out_dtype=jnp.int8 if out_int8 else jnp.float32,
        out_scale=out_scale, backend=backend))
    args = (_t(x_q), _t(w_q), _t(b), x_scale, _t(w_scale))
    kw = dict(activation=act, out_int8=out_int8, out_scale=out_scale)
    got = tref.fused_dense_int8_ref(*args, **kw)
    # the int32 accumulators are exact on both sides
    acc = jax.lax.dot_general(jnp.asarray(x_q), w_q, (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    assert_bitwise(tref._int_dot(_t(x_q), _t(w_q)).numpy(), np.asarray(acc),
                   context="int32 accumulators")
    if out_int8:
        assert got.dtype == torch.int8
        # XLA may contract acc·scale + b into one FMA: a value on a
        # requantization boundary may then land one step away
        d = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() <= 0.01
    else:
        assert_close(got.numpy(), want, dtype="float32")
    # CPU tensors route to the plain version through the entry point
    before = fused_dense_int8_cuda.launches
    assert_bitwise(tops.fused_dense_int8(*args, **kw).numpy(), got.numpy())
    assert fused_dense_int8_cuda.launches == before


def test_int8_requant_rounds_half_to_even():
    """y / out_scale exactly on .5 rounds to the even step, as
    jnp.round does; the clip is at ±127."""
    x_q = torch.tensor([[1], [3], [5], [-5], [127]], dtype=torch.int8)
    w_q = torch.tensor([[1]], dtype=torch.int8)
    y = tref.fused_dense_int8_ref(x_q, w_q, None, 1.0, torch.ones(1),
                                  activation="none", out_int8=True,
                                  out_scale=2.0)
    assert y[:, 0].tolist() == [0, 2, 2, -2, 64]
    y = tref.fused_dense_int8_ref(x_q, w_q, None, 4.0, torch.ones(1),
                                  activation="none", out_int8=True,
                                  out_scale=1.0)
    assert y[:, 0].tolist() == [4, 12, 20, -20, 127]


# ------------------------------------------------------ gravnet aggregate ----
def _events(b, seed, n_valid=None):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, N, DH)).astype(np.float32)
    mask = np.ones((b, N), np.float32)
    if n_valid is not None:   # padded rows at the end, as belle2
        mask[:, n_valid:] = 0.0
        x[:, n_valid:] = 0.0
    ws = (rng.normal(size=(DH, DS)) / np.sqrt(DH)).astype(np.float32)
    wf = (rng.normal(size=(DH, DF)) / np.sqrt(DH)).astype(np.float32)
    return x, mask, ws, wf, rng


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("b,n_valid", [(1, None), (3, 12), (2, 5)])
def test_gravnet_aggregate_ref_matches_jax(backend, b, n_valid):
    x, mask, ws, wf, _ = _events(b, seed=b * 10 + (n_valid or 0),
                                 n_valid=n_valid)
    s, f = x @ ws, x @ wf
    want = np.asarray(jops.gravnet_aggregate_batched(
        jnp.asarray(s), jnp.asarray(f), jnp.asarray(mask), k=K,
        backend=backend))
    got = tref.gravnet_aggregate_ref(_t(s), _t(f), _t(mask), k=K)
    assert got.shape == (b, N, 2 * DF)
    assert_close(got.numpy(), want, dtype="float32")
    before = gravnet_aggregate_cuda.launches
    assert_bitwise(tops.gravnet_aggregate_batched(
        _t(s), _t(f), _t(mask), k=K).numpy(), got.numpy())
    assert_bitwise(tops.gravnet_aggregate(
        _t(s[0]), _t(f[0]), _t(mask[0]), k=K).numpy(), got[0].numpy())
    assert gravnet_aggregate_cuda.launches == before


# ------------------------------------------------------ quantized block ----
def _int8_block(b, seed, n_valid=None):
    """Quantized block operands and scales calibrated on the inputs, as
    calibrate derives them."""
    x, mask, ws, wf, rng = _events(b, seed, n_valid)
    x = np.maximum(x, 0.0)          # the block's producer is a relu
    bs = (rng.normal(size=(DS,)) * 0.1).astype(np.float32)
    bf = (rng.normal(size=(DF,)) * 0.1).astype(np.float32)
    wo = (rng.normal(size=(DH + 2 * DF, DH))
          / np.sqrt(DH + 2 * DF)).astype(np.float32)
    bo = (rng.normal(size=(DH,)) * 0.1).astype(np.float32)
    agg = np.asarray(jops.gravnet_aggregate_batched(
        jnp.asarray(x @ ws + bs), jnp.asarray(x @ wf + bf),
        jnp.asarray(mask), k=K, backend="xla"))
    scales = dict(x_scale=j_activation_scale(np.abs(x).max()),
                  agg_scale=j_activation_scale(np.abs(agg).max()),
                  h_scale=j_activation_scale(max(np.abs(x).max(),
                                                 np.abs(agg).max())))
    q = {nm: tuple(np.asarray(a) for a in j_quantize_weight(jnp.asarray(w)))
         for nm, w in (("ws", ws), ("wf", wf), ("wo", wo))}
    args = (x, mask, q["ws"][0], bs, q["wf"][0], bf, q["wo"][0], bo,
            q["ws"][1], q["wf"][1], q["wo"][1])
    return args, scales


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("b,n_valid", [(1, None), (3, 11)])
def test_gravnet_block_int8_ref_matches_jax(backend, b, n_valid):
    args, scales = _int8_block(b, seed=40 + b, n_valid=n_valid)
    want = np.asarray(jops.gravnet_block_int8_batched(
        *(jnp.asarray(a) for a in args), **scales, k=K, backend=backend))
    got = tref.gravnet_block_int8_ref(*(_t(a) for a in args), **scales, k=K)
    assert got.shape == (b, N, DH) and got.dtype == torch.float32
    quantum = int8_flip_tolerance(scales["h_scale"], args[10], flips=2)
    assert_calibration_close(got.numpy(), want, quantum=quantum,
                             context=backend)
    before = gravnet_block_int8_cuda.launches
    targs = [_t(a) for a in args]
    assert_bitwise(tops.gravnet_block_int8_batched(
        *targs, **scales, k=K).numpy(), got.numpy())
    assert_bitwise(tops.gravnet_block_int8(
        targs[0][0], targs[1][0], *targs[2:], **scales, k=K).numpy(),
        got[0].numpy())
    assert gravnet_block_int8_cuda.launches == before


def test_int8_kernel_wrappers_refuse_cpu_tensors():
    """The new kernel wrappers take CUDA tensors only and count no
    launch when they refuse; a CPU tensor reaches the plain version only
    through ``kernels/ops.py``."""
    args, scales = _int8_block(1, seed=3)
    targs = [_t(a) for a in args]
    counts = (fused_dense_int8_cuda.launches,
              gravnet_aggregate_cuda.launches,
              gravnet_block_int8_cuda.launches)
    with pytest.raises(ValueError, match="CUDA"):
        fused_dense_int8_cuda(torch.zeros(4, 8, dtype=torch.int8),
                              torch.zeros(8, 3, dtype=torch.int8), None, 1.0,
                              torch.ones(3))
    with pytest.raises(ValueError, match="CUDA"):
        gravnet_aggregate_cuda(torch.zeros(1, N, DS), torch.zeros(1, N, DF),
                               torch.ones(1, N), k=K)
    with pytest.raises(ValueError, match="CUDA"):
        gravnet_block_int8_cuda(*targs, **scales, k=K)
    assert (fused_dense_int8_cuda.launches, gravnet_aggregate_cuda.launches,
            gravnet_block_int8_cuda.launches) == counts
