"""AdamW with optional int8 block-quantized moments (bitsandbytes-style).

Counterpart of ``repro/optim/adamw.py``. Parameters, gradients and the
moments are nested dicts (and lists) of tensors, as the reference's
pytrees are, walked in the reference's leaf order (dict keys sorted).
The int8 states keep, per block of 256 values, an f32 absmax scale and
the values rounded to int8; the second moment is stored in the sqrt
domain. The update is functional: it returns new tensors and leaves its
arguments as they are.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import is_distributed

BLOCK = 256


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    quantize_states: bool = False


def _is_q8(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "scale"}


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts and lists (a q8 state
    ``{"q", "scale"}`` is one leaf), the structure of ``tree`` kept."""
    if isinstance(tree, dict) and not _is_q8(tree):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, list):
        return [tree_map(fn, t, *(r[i] for r in rest))
                for i, t in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in the reference's order: dict keys sorted, lists in
    order."""
    if isinstance(tree, dict) and not _is_q8(tree):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


# ------------------------------------------------------- int8 block quant ----
def _q8_pack(x):
    if is_distributed(x):
        return _q8_sharded(_q8_pack, x, like=x)
    flat = x.reshape(-1).to(torch.float32)
    n = flat.numel()
    nb = -(-n // BLOCK)
    flat = F.pad(flat, (0, nb * BLOCK - n)).reshape(nb, BLOCK)
    scale = torch.clamp_min(flat.abs().amax(dim=1), 1e-12) / 127.0
    q = torch.clamp(torch.round(flat / scale[:, None]), -127, 127
                    ).to(torch.int8)
    return {"q": q.reshape(-1), "scale": scale}


def _q8_unpack(s, shape):
    if is_distributed(s["q"], s["scale"]):
        return _q8_sharded(lambda t: _q8_unpack(t, shape), s)
    n = 1
    for d in shape:
        n *= d
    nb = s["scale"].shape[0]
    flat = (s["q"].reshape(nb, BLOCK).to(torch.float32)
            * s["scale"][:, None]).reshape(-1)[:n]
    return flat.reshape(shape)


def _q8_sharded(fn, tree, like=None):
    """``fn`` (the q8 pack or unpack) on DTensors: the blocks of a
    flattened tensor straddle its shards, so the inputs are gathered and
    ``fn`` runs on each device's whole copy; a packed state is then
    split on its only dim over the mesh dims that split ``like``'s first
    sharded dim (``opt_state_specs``: a local slice), an unpacked one
    left replicated."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    leaves = [tree] if isinstance(tree, DTensor) else list(tree.values())
    mesh = leaves[0].device_mesh
    rep = [Replicate()] * mesh.ndim

    def whole(t):
        return t.redistribute(mesh, rep).to_local()
    out = fn(whole(tree) if isinstance(tree, DTensor)
             else {k: whole(v) for k, v in tree.items()})
    if like is None:
        return DTensor.from_local(out, mesh, rep, run_check=False)
    dims = [pl.dim for pl in like.placements if isinstance(pl, Shard)]
    split = [Shard(0) if dims and pl == Shard(min(dims)) else Replicate()
             for pl in like.placements]
    packed = {}
    for k, v in out.items():
        t = DTensor.from_local(v, mesh, rep, run_check=False)
        n = 1
        for m, pl in enumerate(split):
            n *= mesh.size(m) if pl == Shard(0) else 1
        packed[k] = t.redistribute(mesh, split) if v.shape[0] % n == 0 \
            else t
    return packed


# ------------------------------------------------------------- optimizer ----
def adamw_init(params, cfg: AdamWConfig):
    """Zero moments shaped like ``params`` (q8-packed under
    ``cfg.quantize_states``) and step 0 (int32), on the params'
    devices."""
    def zeros(p):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return _q8_pack(z) if cfg.quantize_states else z
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": step}


def global_norm(tree):
    """sqrt of the sum of squares of every leaf, in f32."""
    total = 0
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(total)


def adamw_update(grads, state, params, *, lr, cfg: AdamWConfig):
    """One AdamW step: clip the gradients to a global norm of
    ``cfg.clip_norm``, update the moments, bias-correct, bound the step
    per coordinate to ±20, decay the weights of matrices only, and step
    by ``lr`` (a float or a 0-dim tensor). Returns (new params, new
    state, {"grad_norm"}); nothing is updated in place."""
    step = state["step"] + 1
    gn = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gn, 1e-12), 1.0)
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - b1 ** step.to(torch.float32)
    c2 = 1.0 - b2 ** step.to(torch.float32)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        if cfg.quantize_states:
            mf = _q8_unpack(m, p.shape)
            vf = _q8_unpack(v, p.shape) ** 2   # v stored in sqrt domain
        else:
            mf, vf = m, v
        mf = b1 * mf + (1 - b1) * g
        vf = b2 * vf + (1 - b2) * g * g
        u = (mf / c1) / (torch.sqrt(vf / c2) + cfg.eps)
        # bound the per-coordinate step (guards against quantization
        # underflow in the int8 second moment; near-no-op for fp32)
        u = torch.clamp(u, -20.0, 20.0)
        if p.ndim >= 2:  # decoupled weight decay on matrices only
            u = u + cfg.weight_decay * p.to(torch.float32)
        newp = (p.to(torch.float32) - lr * u).to(p.dtype)
        if cfg.quantize_states:
            return newp, _q8_pack(mf), _q8_pack(torch.sqrt(vf))
        return newp, mf, vf

    out = tree_map(upd, params, grads, state["m"], state["v"])

    def part(i):
        return tree_map(lambda o: o[i], out)
    return part(0), {"m": part(1), "v": part(2), "step": step}, \
        {"grad_norm": gn}


def opt_state_specs(param_specs, cfg: AdamWConfig):
    """Partition specs (``dist.sharding.P``) mirroring the optimizer
    state tree: the moments as the params, or under q8 each flat
    ``{"q", "scale"}`` pair sharded on its only dim by the param's first
    sharded axis (if any)."""
    from repro_torch.dist.sharding import P, map_leaves
    if cfg.quantize_states:
        def qspec(ps):
            first = next((a for a in ps if a is not None), None)
            return {"q": P(first), "scale": P(first)}
        m = map_leaves(qspec, param_specs)
    else:
        m = param_specs
    return {"m": m, "v": m, "step": P()}
