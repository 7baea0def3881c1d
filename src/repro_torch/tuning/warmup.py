"""Serving warm-up from the tuning cache.

Counterpart of ``repro/tuning/warmup.py``. A deployment's first request
would otherwise pay every first use: a kernel library's build and load,
the allocator's first blocks at each shape. The tuning cache knows which
(kernel, shape, dtype, backend) problems the deployment launches, so
``warm_from_cache`` replays each cached winner once on synthetic inputs
before the timed dispatches. The reference's warm-up also fills its jit
cache; the port's counterpart, the capture of a chunk as CUDA graphs
(``core/pipeline.py``), happens at a deployment's first call, which
``launch/serve.py`` makes once per route before traffic.

Warm-up is best-effort: an entry that no longer matches the installed
kernels (an unknown knob, an impossible shape) is skipped, and serving
starts regardless — the cache can make startup faster, never break it.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from repro_torch.tuning.autotune import device_of, float_dtype
from repro_torch.tuning.cache import TuningCache


def _replay(key, config) -> None:
    """One call of the cached winner ``config`` at ``key``'s problem, on
    the device of ``key.backend``, its float operands in the key's dtype
    (``"bf16"`` or f32); the replay dims that ride in the config (d_s,
    d_out, activation, concat_x, reduce, scale) are used, every other
    entry is a launch knob, handed to the ``ops`` entry point as the
    executor hands it (one the kernel does not take, or cannot run,
    raises)."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng(0)
    dev = device_of(key.backend)
    fdt = float_dtype(key.dtype)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    def normal(*shape, scale=1.0):
        return t(rng.normal(size=shape) * scale, fdt)

    def int8(*shape):
        return t(rng.integers(-127, 128, size=shape), torch.int8)

    cfg = dict(config)
    shape = key.shape
    if key.kernel == "fused_dense":
        rows, d_in, d_out = shape
        if key.dtype == "int8":
            ops.fused_dense_int8(int8(rows, d_in), int8(d_in, d_out),
                                 normal(d_out), 0.02,
                                 t(rng.uniform(1e-3, 5e-2, size=(d_out,))),
                                 **cfg)
        else:
            ops.fused_dense(normal(rows, d_in), normal(d_in, d_out),
                            normal(d_out), **cfg)
    elif key.kernel == "gravnet":
        batch = shape[0] if len(shape) == 5 else 1
        n, d_s, d_f, k = shape[-4:]
        ops.gravnet_aggregate_batched(normal(batch, n, d_s),
                                      normal(batch, n, d_f),
                                      t(np.ones((batch, n))), k=k, **cfg)
    elif key.kernel in ("gravnet_block", "gravnet_block_int8"):
        d_s = int(cfg.pop("d_s", 4))
        d_out = int(cfg.pop("d_out", 0))
        activation = cfg.pop("activation", "relu")
        concat_x = bool(cfg.pop("concat_x", True))
        batch = shape[0] if len(shape) == 5 else 1
        n, dh, d_f, k = shape[-4:]
        d_out = d_out or dh
        dcat = dh + 2 * d_f if concat_x else 2 * d_f
        x = normal(batch, n, dh)
        mask = t(np.ones((batch, n)))
        if key.kernel == "gravnet_block_int8":
            ops.gravnet_block_int8_batched(
                x, mask, int8(dh, d_s), normal(d_s), int8(dh, d_f),
                normal(d_f), int8(dcat, d_out), normal(d_out),
                *(t(rng.uniform(1e-3, 5e-2, size=(m,)))
                  for m in (d_s, d_f, d_out)),
                x_scale=0.02, agg_scale=0.01, h_scale=0.02, k=k,
                activation=activation, concat_x=concat_x, **cfg)
        else:
            ops.gravnet_block_batched(
                x, mask, normal(dh, d_s, scale=0.3), normal(d_s),
                normal(dh, d_f, scale=0.3), normal(d_f),
                normal(dcat, d_out, scale=0.3), normal(d_out), k=k,
                activation=activation, concat_x=concat_x, **cfg)
    elif key.kernel == "edge_aggregate":
        reduce = cfg.pop("reduce", "sum")
        batch = shape[0] if len(shape) == 4 else 1
        n, e, d = shape[-3:]
        ops.edge_aggregate_batched(
            normal(batch, e, d),
            t(rng.integers(0, n, size=(batch, 2, e)), torch.int32), n,
            t(np.ones((batch, e))), reduce=reduce, **cfg)
    elif key.kernel == "knn_build":
        batch = shape[0] if len(shape) == 4 else 1
        n, d_s, k = shape[-3:]
        ops.knn_build_batched(normal(batch, n, d_s),
                              t(np.zeros((batch, n)), torch.int32), k=k,
                              **cfg)
    elif key.kernel == "knn_aggregate":
        scale = float(cfg.pop("scale", 10.0))
        batch = shape[0] if len(shape) == 4 else 1
        n, d_f, k = shape[-3:]
        ops.knn_aggregate_batched(
            normal(batch, n, d_f),
            t(rng.integers(0, n, size=(batch, n, k)), torch.int32),
            t(rng.uniform(0.0, 4.0, size=(batch, n, k))), scale=scale,
            **cfg)
    elif key.kernel == "flash_attention":
        bh, s, tt, d = shape
        ops.flash_attention(normal(bh, s, d), normal(bh, tt, d),
                            normal(bh, tt, d), **cfg)
    else:
        raise ValueError(f"no replay for kernel {key.kernel!r}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def warm_from_cache(cache: TuningCache, *, backend: str | None = None,
                    kernels: tuple[str, ...] | None = None) -> int:
    """Replay every cached winner (optionally filtered by backend and
    kernel family) once; returns how many entries were warmed. A stale
    entry is skipped with a ``RuntimeWarning`` that names it."""
    warmed = 0
    for key, entry in sorted(cache.entries().items(),
                             key=lambda kv: kv[0].encode()):
        if backend is not None and key.backend != backend:
            continue
        if kernels is not None and key.kernel not in kernels:
            continue
        try:
            _replay(key, entry.config)
        except Exception as e:   # noqa: BLE001 — a stale entry must not block
            warnings.warn(f"tuning warm-up skipped {key.encode()}: {e!r}",
                          RuntimeWarning, stacklevel=2)
            continue
        warmed += 1
    return warmed


def make_warmup(cache: TuningCache, *, backend: str | None = None,
                kernels: tuple[str, ...] | None = None):
    """A no-argument callable that warms from ``cache``."""
    def _warm():
        return warm_from_cache(cache, backend=backend, kernels=kernels)
    return _warm
