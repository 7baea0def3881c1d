"""Dense layer in the reference's ``(d_in, d_out)`` weight layout, the
MLP built of them, the norms of ``repro/nn/layers.py``, and a top-k that
breaks ties as ``jax.lax.top_k`` does.

``repro/nn/layers.py`` keeps ``w`` as ``(d_in, d_out)`` and computes
``x @ w + b``; the port keeps that layout (not ``nn.Linear``'s
``(out, in)``) so that weights move between the packages unchanged.
The variances are population variances (``jnp.var``), hence
``correction=0``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.nn.init import lecun_normal, zeros_init


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = True) -> dict:
    p = {"w": lecun_normal(gen, (d_in, d_out))}
    if bias:
        p["b"] = zeros_init((d_out,))
    return p


def dense_shape(d_in: int, d_out: int, *, bias: bool = True) -> dict:
    """The array shapes of :func:`dense_init`'s params."""
    return {"w": (d_in, d_out), "b": (d_out,)} if bias else {
        "w": (d_in, d_out)}


def dense_apply(params, x, *, activation=None):
    y = x @ params["w"]
    if "b" in params:
        y = y + params["b"]
    if activation is not None:
        y = activation(y)
    return y


def mlp_init(gen: torch.Generator, dims) -> list:
    """dims = [d_in, h1, ..., d_out] -> a list of dense params."""
    return [dense_init(gen, a, b) for a, b in zip(dims[:-1], dims[1:])]


def mlp_apply(params, x, *, activation=torch.relu):
    """The denses in turn, ``activation`` after each but the last (relu
    by default, as the reference's), nothing after the last."""
    for i, p in enumerate(params):
        x = dense_apply(p, x, activation=activation
                        if i < len(params) - 1 else None)
    return x


def layernorm_apply(params, x, *, eps: float = 1e-5):
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    y = (x - mu) * torch.rsqrt(var + eps)
    return y * params["scale"] + params["bias"]


def rmsnorm_apply(params, x, *, eps: float = 1e-6):
    """RMSNorm computed in f32 whatever the activation dtype, the result
    cast back to it."""
    xf = x.to(torch.float32)
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps)
    return (y * params["scale"].to(torch.float32)).to(x.dtype)


def nonparametric_layernorm(x, *, eps: float = 1e-5):
    """OLMo-style LayerNorm with no learnable affine parameters, in
    f32."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def top_k(x, k: int):
    """(values, indices) of the ``k`` largest entries along the last
    axis, in descending order, ties broken lower index first as
    ``jax.lax.top_k`` breaks them (``torch.topk`` promises no order on
    ties): a stable descending sort keeps equal entries in index
    order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class Dense(nn.Module):
    """``y = x @ w + b`` with ``w: (d_in, d_out)``."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor | None = None):
        super().__init__()
        self.w = nn.Parameter(w, requires_grad=False)
        self.b = None if b is None else nn.Parameter(b,
                                                      requires_grad=False)

    def params(self) -> dict:
        p = {"w": self.w.data}
        if self.b is not None:
            p["b"] = self.b.data
        return p

    def forward(self, x):
        # the Parameters themselves (not .data), so that a caller that
        # sets requires_grad gets gradients through the layer
        p = {"w": self.w} if self.b is None else {"w": self.w, "b": self.b}
        return dense_apply(p, x)
