"""The train step as the reference jits it: gradients by autograd, and
on the card the whole step captured as one CUDA graph.

- :func:`value_and_grad` is ``jax.value_and_grad(has_aux=True)`` over a
  parameter tree (nested dicts and lists of tensors).
- :class:`CompiledStep` holds a functional step ``step(params, opt,
  batch) -> (new params, new opt, metrics)`` and the training state in
  static buffers. On ``cuda`` its first call captures forward,
  ``torch.autograd.grad``, the AdamW update and the copies of the new
  parameters and state into their buffers as one CUDA graph (the
  counterpart of ``jax.jit``); every later call copies the batch in and
  replays. On the CPU the same body runs eagerly. Either way the state
  lives in the buffers: a restore copies into them (:meth:`load`), it
  never rebinds them, since a graph reads the tensors it captured.
"""
from __future__ import annotations

import torch

from repro_torch.checkpoint.manager import flatten, unflatten
from repro_torch.kernels import ops as kops


def value_and_grad(loss_fn, params):
    """((loss, aux), grads) of ``loss_fn(params) -> (loss, aux)``: the
    value and the metrics detached, the gradient of every leaf (zeros
    where the loss does not reach it) in ``params``' structure."""
    leaves = [t.detach().requires_grad_(True) for _, t in flatten(params)]
    with torch.enable_grad():
        loss, aux = loss_fn(unflatten(params, iter(leaves)))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for g, t in zip(grads, leaves)]
    aux = {k: v.detach() for k, v in aux.items()}
    return (loss.detach(), aux), unflatten(params, iter(grads))


def _copy_tree(dst, src) -> None:
    """Every leaf of ``src`` into the same leaf of ``dst`` (same
    structure and shapes), in place."""
    d, s = flatten(dst), flatten(src)
    if [n for n, _ in d] != [n for n, _ in s]:
        raise ValueError("the trees differ: "
                         f"{sorted({n for n, _ in d} ^ {n for n, _ in s})}")
    with torch.no_grad():
        for (name, a), (_, b) in zip(d, s):
            if tuple(a.shape) != tuple(b.shape):
                raise ValueError(f"{name}: shape {tuple(b.shape)}, the "
                                 f"buffer's {tuple(a.shape)}")
            a.copy_(b)


def _signature(batch) -> list:
    return [(n, tuple(t.shape), t.dtype) for n, t in flatten(batch)]


class CompiledStep:
    """``step`` bound to its training state. ``params`` and ``opt`` are
    the state's buffers (copies on ``device`` of the trees given);
    ``self(batch)`` runs one step on them and returns its metrics (0-dim
    tensors; on ``cuda`` the graph's static outputs, overwritten by the
    next step). ``backend`` is the capture backend (``core/pipeline._CudaGraphs`` on ``cuda``, None on
    the CPU: eager); a test injects a stand-in.

    The capture: the batch is copied into static buffers; the body runs
    once on the backend's side stream to warm up and the state is put
    back as it was (a warm-up advances nothing); the body is captured
    and the state put back again (a stand-in that runs what it
    captures); then the graph replays once for this step. A batch of
    another signature raises (no silent re-capture). Each replay adds
    the launches its capture recorded (``launches``, keyed as
    ``kernels.ops.launch_counts``) to the kernel counters."""

    def __init__(self, step, params, opt, *, device, backend=None):
        self.step = step
        self.device = torch.device(device)
        self.params = _to(params, self.device, copy=True)
        self.opt = _to(opt, self.device, copy=True)
        if backend is None and self.device.type == "cuda":
            from repro_torch.core.pipeline import _CudaGraphs
            backend = _CudaGraphs(self.device)
        self.backend = backend
        self._graph = None
        self._batch = None
        self._sig = None
        self._metrics = None
        self.launches: dict = {}

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def load(self, params, opt) -> None:
        """Copy ``params`` and ``opt`` into the state's buffers."""
        _copy_tree(self.params, params)
        _copy_tree(self.opt, opt)

    def _body(self, params, opt, batch):
        new_p, new_o, metrics = self.step(params, opt, batch)
        _copy_tree(params, new_p)
        _copy_tree(opt, new_o)
        return metrics

    def __call__(self, batch):
        if self.backend is None:
            return self._body(self.params, self.opt, batch)
        if self._graph is None:
            return self._capture(batch)
        sig = _signature(batch)
        if sig != self._sig:
            raise ValueError(f"the step was captured for batch {self._sig}"
                             f", got {sig}")
        _copy_tree(self._batch, batch)
        self.backend.replay(self._graph)
        kops.add_launches(self.launches)
        return self._metrics

    def _capture(self, batch):
        params, opt = self.params, self.opt
        static = _to(batch, self.device, copy=True)
        state = [t for _, t in flatten((params, opt))]
        saved = [t.clone() for t in state]

        def put_back():
            with torch.no_grad():
                for t, s in zip(state, saved):
                    t.copy_(s)

        def body():
            return self._body(params, opt, static)
        self.backend.warmup(body)
        put_back()
        with kops.COUNTS_LOCK:
            before = kops.launch_counts()
            try:
                graph, metrics = self.backend.capture(body)
                after = kops.launch_counts()
            finally:
                # a capture records its launches without running them
                kops.set_launch_counts(before)
        put_back()
        self.launches = {k: n - before.get(k, 0) for k, n in after.items()
                          if n != before.get(k, 0)}
        self._graph, self._batch, self._metrics = graph, static, metrics
        self._sig = _signature(static)
        self.backend.replay(graph)
        kops.add_launches(self.launches)
        return metrics


def _to(tree, device, copy=False):
    """``tree`` with every leaf a tensor on ``device`` (a copy where
    ``copy``, or where it lay elsewhere)."""
    leaves = [torch.as_tensor(t).to(device, copy=copy)
              for _, t in flatten(tree)]
    return unflatten(tree, iter(leaves))
