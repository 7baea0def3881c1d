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
from repro_torch.core.quantization import (activation_scale, quantize_act,
                                           quantize_weight)
from repro_torch.kernels import int8_cases
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


# ------------------------------------------- int8_quant.cuh, in numpy ----
# The int8 kernels quantize without an f32 division per value:
# csrc/int8_quant.cuh takes (float)((double)v * (1.0 / (double)s)),
# falls back to v / s wherever quotient_exact says no, and rounds and
# clips by the 1.5 * 2^23 shift. Here the same steps in numpy (IEEE
# double and float32, round to nearest even, no flush to zero, as the
# kernels are built) are held bitwise against the f32 division and
# clip(rint(.)) on the quotients where a second rounding could go wrong.
F32_MAX = np.float32(np.finfo(np.float32).max)


def _header_quotient(v, s):
    v, s = np.asarray(v, np.float32), np.asarray(s, np.float32)
    with np.errstate(all="ignore"):
        q = (v.astype(np.float64) * (1.0 / s.astype(np.float64))).astype(
            np.float32)
        exact = (v == 0) | ~(np.abs(q) < np.float32(2.0 ** -125))
        return np.where(exact, q, v / s)


def _header_round_clip_s8(q):
    with np.errstate(all="ignore"):
        c = np.fmin(np.fmax(q, np.float32(-127)), np.float32(127))
        w = (c + np.float32(12582912.0)).astype(np.float32)
    return (w.view(np.int32) - 0x4B400000).astype(np.int8)


def _divided(v, s):
    v, s = np.asarray(v, np.float32), np.asarray(s, np.float32)
    with np.errstate(all="ignore"):
        q = v / s
        return q, np.fmin(np.fmax(np.rint(q), np.float32(-127)),
                          np.float32(127)).astype(np.int8)


def _neighbours(v):
    v = np.asarray(v, np.float32)
    return np.concatenate([v, np.nextafter(v, np.float32(np.inf)),
                           np.nextafter(v, np.float32(-np.inf))])


def _log_uniform(rng, lo, hi, n):
    return np.exp2(rng.uniform(lo, hi, n)).astype(np.float32)


def _quotient_pairs(family, rng, n=200_000):
    """(v, s) float32 pairs of one family of hard quotients."""
    if family == "random_bits":
        v = rng.integers(0, 2 ** 32, n, dtype=np.uint32).view(np.float32)
        s = rng.integers(0, 2 ** 32, n, dtype=np.uint32).view(np.float32)
        return v, s
    if family == "near_float_midpoints":
        # v / s within an ulp of v of the midpoint of two floats
        s = _log_uniform(rng, -100, 100, n)
        q = _log_uniform(rng, -120, 120, n) * rng.choice(
            np.float32([-1, 1]), n)
        m = q.astype(np.float64) + np.spacing(q).astype(np.float64) / 2
        with np.errstate(all="ignore"):
            v = (m * s.astype(np.float64)).astype(np.float32)
        return _neighbours(v), np.tile(s, 3)
    if family == "half_integers":
        # rint's ties: v / s at and next to j + 1/2, |j| up to 200
        s = _log_uniform(rng, -30, 30, n)
        j = rng.integers(-200, 200, n) + 0.5
        v = (j * s.astype(np.float64)).astype(np.float32)
        return _neighbours(v), np.tile(s, 3)
    if family == "subnormal":
        # subnormal v (quotients below the normal range: the division
        # fallback), subnormal s, and v / s exactly halfway between two
        # subnormals: (2j + 1) 2^-150 with s = t 2^a, t odd, whose
        # reciprocal is inexact in double
        sub = rng.integers(1, 2 ** 23, n, dtype=np.uint32).view(np.float32)
        sub = sub * rng.choice(np.float32([-1, 1]), n)
        s = _log_uniform(rng, -30, 30, n)
        v = _log_uniform(rng, -30, 30, n)
        t = 2 * rng.integers(1, 2 ** 10, n) + 1
        j = 2 * rng.integers(0, 2 ** 10, n) + 1
        a = rng.integers(1, 40, n)
        s_mid = np.ldexp(t.astype(np.float64), a).astype(np.float32)
        v_mid = np.ldexp((j * t).astype(np.float64), a - 150).astype(
            np.float32)
        return (np.concatenate([sub, v, _neighbours(v_mid)]),
                np.concatenate([s, sub, np.tile(s_mid, 3)]))
    if family == "overflow":
        # v / s next to 2^128 - 2^103, where the f32 rounding overflows
        s = rng.uniform(0.5, 1.0, n).astype(np.float32)
        v = ((2.0 ** 128 - 2.0 ** 103) * s.astype(np.float64)).astype(
            np.float32)
        return _neighbours(v), np.tile(s, 3)
    if family == "specials":
        vals = np.float32([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0,
                           1e-45, F32_MAX, 127.5, -127.5, 0.5, -0.5])
        v, s = np.meshgrid(vals, vals)
        return v.ravel(), s.ravel()
    raise ValueError(family)


QUOTIENT_FAMILIES = ("random_bits", "near_float_midpoints", "half_integers",
                     "subnormal", "overflow", "specials")


@pytest.mark.parametrize("family", QUOTIENT_FAMILIES)
def test_division_free_quotient_is_the_ieee_division(family):
    rng = np.random.default_rng(QUOTIENT_FAMILIES.index(family))
    v, s = _quotient_pairs(family, rng)
    want_q, want = _divided(v, s)
    got_q = _header_quotient(v, s)
    nan = np.isnan(want_q)
    assert (np.isnan(got_q) == nan).all()
    assert_bitwise(got_q[~nan], want_q[~nan], context=f"quotient {family}")
    assert_bitwise(_header_round_clip_s8(got_q), want,
                   context=f"clip(rint(q)) {family}")
    if family in ("near_float_midpoints", "half_integers"):
        # the family is sharp: an f32 reciprocal multiply, the shortcut
        # the header does not take, misses some of its quotients
        with np.errstate(all="ignore"):
            recip = v * (np.float32(1.0) / s)
        assert not np.array_equal(recip[~nan], want_q[~nan])


@pytest.mark.parametrize("s", [0.0123456789, 1.0 / 127, 3.0, 2e-38])
def test_quotient_edges_quantize_as_the_plain_version(s):
    """On kernels/int8_cases.py's quotient values, the header's steps
    give quantize_act's int8 values (the plain versions' quantizer)."""
    vals = int8_cases.quotient_values(s, seed=3)
    want = quantize_act(_t(vals), s).numpy()
    got = _header_round_clip_s8(_header_quotient(vals, np.float32(s)))
    assert_bitwise(got, want, context="x quantization")


# --------------------------------------------------------- int8 dense ----
# (M, K, N, activation, int8 out, case of kernels/int8_cases.py or None)
DENSE_PARAMS = [
    *(pytest.param(*c, None, id="-".join(map(str, c))) for c in (
        (48, 24, 24, "relu", True), (32, 4, 24, "relu", False),
        (37, 44, 7, "none", True), (16, 108, 24, "relu", False))),
    *(pytest.param(*c, name, id=name)
      for name, c in int8_cases.DENSE_CASES.items())]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("m,kdim,n,act,out_int8,case", DENSE_PARAMS)
def test_fused_dense_int8_ref_matches_jax(backend, m, kdim, n, act,
                                          out_int8, case):
    if case is None:
        rng = np.random.default_rng(m * 100 + kdim)
        x_q = rng.integers(-127, 128, (m, kdim)).astype(np.int8)
        w = (rng.normal(size=(kdim, n)) / np.sqrt(kdim)).astype(np.float32)
        b = (rng.normal(size=(n,)) * 0.1).astype(np.float32)
        w_q, w_scale = j_quantize_weight(jnp.asarray(w))
        x_scale, out_scale = 0.0123456789, 0.0371
    else:
        (x_q, w_q, b, x_scale, w_scale), out_scale = int8_cases.dense_inputs(
            m, kdim, n, seed=len(case))
        w_q, w_scale = jnp.asarray(w_q), jnp.asarray(w_scale)
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


def _assert_lowest_column_on_ties(args, scales):
    """The plain version's selection (the cell's, through knn_build_ref's
    same rounds) takes the lowest column among exactly tied distances,
    and the inputs hold such ties for some valid row's valid slot."""
    x, mask, ws_q, bs = (_t(a) for a in args[:4])
    s = tref._dequant(tref._int_dot(quantize_act(x, scales["x_scale"]),
                                    ws_q), bs, scales["x_scale"],
                      _t(args[8]))
    valid = mask > 0
    idx, d2 = tref.knn_build_ref(s, torch.where(valid, 0, -1), k=K)
    n = s.shape[1]
    col = torch.arange(n)
    full = torch.where(valid[:, None, :] & (col[None, :] != col[:, None]),
                       tref._pairwise_d2(s), tref.BIG)
    tied = 0
    for e, i in zip(*torch.nonzero(valid, as_tuple=True)):
        taken = []
        for slot in range(K):
            dmin = d2[e, i, slot]
            if dmin >= tref.BIG * 0.5:
                break
            same = [j for j in range(n) if full[e, i, j] == dmin
                    and j not in taken]
            tied += len(same) > 1
            assert int(idx[e, i, slot]) == min(same)
            taken.append(int(idx[e, i, slot]))
    assert tied > 0, "the tie case has no exact tie"


# (events, valid rows or None, case of kernels/int8_cases.py or None)
BLOCK_PARAMS = [
    pytest.param(1, None, None, id="1-None"),
    pytest.param(3, 11, None, id="3-11"),
    *(pytest.param(None, None, name, id=name)
      for name in int8_cases.BLOCK_CASES)]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("b,n_valid,case", BLOCK_PARAMS)
def test_gravnet_block_int8_ref_matches_jax(backend, b, n_valid, case):
    if case is None:
        args, scales = _int8_block(b, seed=40 + b, n_valid=n_valid)
        n = N
    else:   # at the smoke widths
        b, n, n_valid, dup = int8_cases.BLOCK_CASES[case]
        args, scales = int8_cases.block_inputs(
            b, n, dh=DH, ds=DS, df=DF, dout=DH, seed=len(case),
            n_valid=n_valid, dup=dup)
        if dup:
            _assert_lowest_column_on_ties(args, scales)
    want = np.asarray(jops.gravnet_block_int8_batched(
        *(jnp.asarray(a) for a in args), **scales, k=K, backend=backend))
    got = tref.gravnet_block_int8_ref(*(_t(a) for a in args), **scales, k=K)
    assert got.shape == (b, n, DH) and got.dtype == torch.float32
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
