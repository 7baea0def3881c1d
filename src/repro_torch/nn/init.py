"""Parameter initializers drawing from an explicit ``torch.Generator``,
on the generator's device.

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
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (std * t).to(dtype)


def normal_init(gen: torch.Generator, shape, std=0.02, dtype=torch.float32):
    """``std`` times a standard normal draw, on the generator's device."""
    t = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (std * t).to(dtype)


def truncated_normal(gen: torch.Generator, shape, std=0.02,
                     dtype=torch.float32):
    """``std`` times a standard normal truncated at ±2, on the
    generator's device."""
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (std * t).to(dtype)


def zeros_init(shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)
