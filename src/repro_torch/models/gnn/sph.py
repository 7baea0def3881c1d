"""Real spherical harmonics (l ≤ 3) and SO(3) intertwiners (CG tensors).

Counterpart of ``repro/models/gnn/sph.py``, with its numpy code kept as
it is, so that the port's intertwiners are the reference's bit for bit.
The Clebsch-Gordan intertwiners are derived numerically: w[i,j,k] must
satisfy, for every rotation R,

    Σ_{i',j'} D^{l1}(R)[i',i] · D^{l2}(R)[j',j] · w[i',j',k]
        = Σ_{k'} D^{l3}(R)[k,k'] · w[i,j,k']

The Wigner-D matrices in the *real* SH basis are solved by least squares
from Y_l(R·x) = D^l(R) · Y_l(x) over sampled directions; stacking the
linear constraint for six random rotations (seed 42) and taking the SVD
null space gives the intertwiner, unique up to sign and scale: unit
norm, first nonzero entry positive. :func:`real_sph` is the torch form
NequIP evaluates on edge directions, :func:`intertwiner_tensor` a
cached tensor of an intertwiner on a device.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

_SQ = np.sqrt


def real_sph_np(l: int, u: np.ndarray) -> np.ndarray:  # noqa: E741
    """Orthonormal real spherical harmonics on unit vectors u (..., 3)."""
    x, y, z = u[..., 0], u[..., 1], u[..., 2]
    if l == 0:
        return np.full(u.shape[:-1] + (1,), 0.5 / _SQ(np.pi))
    if l == 1:
        c = _SQ(3.0 / (4 * np.pi))
        return np.stack([c * y, c * z, c * x], axis=-1)
    if l == 2:
        c1 = 0.5 * _SQ(15.0 / np.pi)
        c2 = 0.25 * _SQ(5.0 / np.pi)
        c3 = 0.25 * _SQ(15.0 / np.pi)
        r2 = x * x + y * y + z * z
        return np.stack([
            c1 * x * y, c1 * y * z, c2 * (3 * z * z - r2),
            c1 * x * z, c3 * (x * x - y * y)], axis=-1)
    if l == 3:
        c = [0.25 * _SQ(35 / (2 * np.pi)), 0.5 * _SQ(105 / np.pi),
             0.25 * _SQ(21 / (2 * np.pi)), 0.25 * _SQ(7 / np.pi),
             0.25 * _SQ(21 / (2 * np.pi)), 0.25 * _SQ(105 / np.pi),
             0.25 * _SQ(35 / (2 * np.pi))]
        return np.stack([
            c[0] * y * (3 * x * x - y * y), c[1] * x * y * z,
            c[2] * y * (5 * z * z - 1), c[3] * z * (5 * z * z - 3),
            c[4] * x * (5 * z * z - 1), c[5] * z * (x * x - y * y),
            c[6] * x * (x * x - 3 * y * y)], axis=-1)
    raise NotImplementedError(l)


def real_sph(l: int, u: torch.Tensor) -> torch.Tensor:  # noqa: E741
    """:func:`real_sph_np` for l ≤ 2 on a tensor of unit vectors
    (..., 3), in its dtype."""
    x, y, z = u[..., 0], u[..., 1], u[..., 2]
    if l == 0:
        return u.new_full(u.shape[:-1] + (1,), float(0.5 / _SQ(np.pi)))
    if l == 1:
        c = float(_SQ(3.0 / (4 * np.pi)))
        return torch.stack([c * y, c * z, c * x], dim=-1)
    if l == 2:
        c1 = float(0.5 * _SQ(15.0 / np.pi))
        c2 = float(0.25 * _SQ(5.0 / np.pi))
        c3 = float(0.25 * _SQ(15.0 / np.pi))
        r2 = x * x + y * y + z * z
        return torch.stack([
            c1 * x * y, c1 * y * z, c2 * (3 * z * z - r2),
            c1 * x * z, c3 * (x * x - y * y)], dim=-1)
    raise NotImplementedError(l)


def _random_rotation(rng) -> np.ndarray:
    a = rng.normal(size=(3, 3))
    q, r = np.linalg.qr(a)
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


def wigner_d_for(l: int, rot: np.ndarray) -> np.ndarray:  # noqa: E741
    """Real-basis Wigner D: Y_l(R·x) = D @ Y_l(x), solved by lstsq."""
    rng = np.random.default_rng(1234 + l)
    xs = rng.normal(size=(max(64, 8 * (2 * l + 1)), 3))
    xs /= np.linalg.norm(xs, axis=1, keepdims=True)
    a = real_sph_np(l, xs)                       # (M, 2l+1)
    b = real_sph_np(l, xs @ rot.T)               # (M, 2l+1)
    d, *_ = np.linalg.lstsq(a, b, rcond=None)    # a @ d ≈ b  -> D = d.T
    return d.T


@functools.lru_cache(maxsize=None)
def intertwiner(l1: int, l2: int, l3: int) -> np.ndarray | None:
    """w[i,j,k] (unit-norm, sign-fixed) or None if the triple is empty.
    Cached: every caller gets the same array, which must not be
    written."""
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        return None
    n1, n2, n3 = 2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1
    rng = np.random.default_rng(42)
    rows = []
    for _ in range(6):
        rot = _random_rotation(rng)
        d1 = wigner_d_for(l1, rot)
        d2 = wigner_d_for(l2, rot)
        d3 = wigner_d_for(l3, rot)
        # constraint on vec(w) with index order (i,j,k):
        #   [ (D1⊗D2)^T ⊗ I_n3  -  I_{n1·n2} ⊗ D3 ] vec(w) = 0
        d12 = np.kron(d1, d2)                    # [(i',j'),(i,j)]
        m = np.kron(d12.T, np.eye(n3)) - np.kron(np.eye(n1 * n2), d3)
        rows.append(m)
    m = np.concatenate(rows, axis=0)
    _, s, vt = np.linalg.svd(m)
    rank = int(np.sum(s > 1e-8 * max(s[0], 1.0)))
    null = vt[rank:]
    if null.shape[0] == 0:
        return None
    w = null[0].reshape(n1, n2, n3)
    w = w / np.linalg.norm(w)
    # deterministic sign: first nonzero entry positive
    nz = w.flat[np.argmax(np.abs(w) > 1e-10)]
    if nz < 0:
        w = -w
    return w


@functools.lru_cache(maxsize=None)
def intertwiner_tensor(l1: int, l2: int, l3: int, device: torch.device,
                       dtype: torch.dtype = torch.float32):
    """:func:`intertwiner` as a tensor on ``device`` (f32 unless asked),
    cached per device and dtype; None if the triple is empty. Made
    outside any CUDA graph capture before a captured step reads it (a
    capture may not copy host memory): a forward run eagerly first, as
    ``optim/step.CompiledStep``'s warm-up is, does it."""
    w = intertwiner(l1, l2, l3)
    return None if w is None else torch.tensor(w, dtype=dtype,
                                               device=device)
