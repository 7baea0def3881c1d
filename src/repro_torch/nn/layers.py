"""Dense layer in the reference's ``(d_in, d_out)`` weight layout.

``repro/nn/layers.py`` keeps ``w`` as ``(d_in, d_out)`` and computes
``x @ w + b``; the port keeps that layout (not ``nn.Linear``'s
``(out, in)``) so that weights move between the packages unchanged.
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


def dense_apply(params, x, *, activation=None):
    y = x @ params["w"]
    if "b" in params:
        y = y + params["b"]
    if activation is not None:
        y = activation(y)
    return y


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
