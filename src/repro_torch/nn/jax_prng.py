"""``jax.random.normal`` of the default threefry key, in numpy.

MIND seeds its capsule routing logits with ``jax.random.normal(
jax.random.PRNGKey(17), (1, K, H))`` (``repro/models/recsys.py``): a
constant of the model, not a weight, so the port draws the same numbers
without JAX. The draw, as JAX makes it with ``jax_threefry_partitionable``
on (the default of current JAX):

- the key of ``PRNGKey(seed)`` for a 32-bit seed is ``(0, seed)``;
- element i of the shape (row-major) takes the counter ``(i >> 32,
  i & 0xffffffff)`` through threefry2x32 (20 rounds) and its bits are
  the two output words xor-ed;
- the uniform in ``[nextafter(-1, inf), 1)``: the top 23 bits as the
  mantissa of a float in [1, 2), minus 1, times ``1 - lo``, plus ``lo``,
  at least ``lo``, all in float32;
- the normal: ``sqrt(2) * erfinv(u)``.

The bits and the uniform are JAX's bit for bit. JAX's float32 ``erfinv``
is XLA's polynomial, so the normal is computed as ``erfinv`` in float64
rounded to float32, then the float32 product: within an ulp or two of
JAX's (the tests hold it to the float32 row).
"""
from __future__ import annotations

import math

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def prng_key(seed: int) -> tuple[int, int]:
    """The two words of ``jax.random.PRNGKey(seed)`` (threefry)."""
    seed = int(seed)
    return ((seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 with 20 rounds of the counters ``(x0, x1)`` (uint32
    arrays) under ``key`` (two words), as ``jax.random`` computes it."""
    k0, k1 = (np.uint32(k) for k in key)
    ks = (k0, k1, np.uint32(k0 ^ k1 ^ np.uint32(0x1BD11BDA)))
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r)
            x[1] = x[0] ^ x[1]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def random_bits(key, shape) -> np.ndarray:
    """``jax.random.bits(key, shape)`` (uint32), partitionable layout."""
    n = math.prod(shape)
    i = np.arange(n, dtype=np.uint64)
    hi = (i >> np.uint64(32)).astype(np.uint32)
    lo = (i & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32(key, hi, lo)
    return (b0 ^ b1).reshape(shape)


def uniform(key, shape, minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = random_bits(key, shape)
    one = np.array(1.0, np.float32).view(np.uint32)
    f = ((bits >> np.uint32(32 - 23)) | one).view(np.float32) - np.float32(1)
    return np.maximum(lo, f * (hi - lo) + lo)


def normal(key, shape) -> np.ndarray:
    """``jax.random.normal(key, shape)`` (float32), to within an ulp or
    two (see the module's note)."""
    lo = np.nextafter(np.float32(-1), np.float32(np.inf))
    u = uniform(key, shape, lo, 1.0)
    e = torch.erfinv(torch.from_numpy(u.astype(np.float64))).numpy()
    e = e.astype(np.float32)
    return np.float32(np.sqrt(2)) * e
