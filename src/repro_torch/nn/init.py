"""Parameter initializers drawing from an explicit ``torch.Generator``.

They follow ``repro/nn/init.py`` in distribution, not in bits: a
``torch.Generator`` and a ``jax.random`` key give different numbers from
the same seed. Tests that compare the two packages load the JAX
package's weights instead (``repro_torch.convert.from_jax_params``).
"""
from __future__ import annotations

import math

import torch


def lecun_normal(gen: torch.Generator, shape, dtype=torch.float32):
    """LeCun-normal (fan-in) init, truncated at two standard deviations."""
    fan_in = shape[-2] if len(shape) > 1 else shape[0]
    std = math.sqrt(1.0 / max(1, fan_in))
    t = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (std * t).to(dtype)


def zeros_init(shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)
