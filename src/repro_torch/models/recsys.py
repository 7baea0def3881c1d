"""MIND: Multi-Interest Network with Dynamic routing (arXiv:1904.08030).

Counterpart of ``repro/models/recsys.py``. Config: embed_dim=64,
n_interests=4, capsule_iters=3, multi-interest interaction. Pipeline:

  item/user-tag embedding lookup (``embedding_bag``: a gather and
      ``index_add`` per bag, multi-hot with per-sample weights)
  → B2I dynamic capsule routing (3 iterations, squash nonlinearity,
      behavior-masked, softmax over capsules; the routing logits start
      from ``jax.random.normal(PRNGKey(17), (1, K, H))``, drawn by
      ``nn/jax_prng.py``)
  → label-aware attention (training; pow-2 sharpened)
  → sampled-softmax over in-batch negatives (training)
  → retrieval scoring: max over interests of capsule·candidate
      (one user against 10⁶ candidates is one batched product).

``PARAM_RULES`` are the reference's logical sharding specs.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.dist.sharding import DP, TP, P, embedding
from repro_torch.nn import jax_prng
from repro_torch.nn.init import normal_init
from repro_torch.nn.layers import dense_apply, dense_init, top_k


@dataclasses.dataclass(frozen=True)
class MINDConfig:
    name: str = "mind"
    n_items: int = 1_000_000
    n_user_tags: int = 100_000
    embed_dim: int = 64
    n_interests: int = 4
    capsule_iters: int = 3
    hist_len: int = 50
    tag_bag: int = 16
    label_pow: float = 2.0


def param_shapes(cfg: MINDConfig) -> dict:
    d = cfg.embed_dim
    return {"item_emb": (cfg.n_items, d), "tag_emb": (cfg.n_user_tags, d),
            "bilinear_s": (d, d), "proj": {"w": (2 * d, d), "b": (d,)}}


def init(gen: torch.Generator, cfg: MINDConfig) -> dict:
    """Random weights on the generator's device: the embeddings normal
    of std 0.02, the bilinear map 0.05, the projection LeCun-normal with
    a zero bias."""
    d = cfg.embed_dim
    proj = dense_init(gen, 2 * d, d)
    return {
        "item_emb": normal_init(gen, (cfg.n_items, d), std=0.02),
        "tag_emb": normal_init(gen, (cfg.n_user_tags, d), std=0.02),
        "bilinear_s": normal_init(gen, (d, d), std=0.05),
        "proj": {k: t.to(gen.device) for k, t in proj.items()},
    }


# logical sharding specs of the parameters (``dist/sharding.py``)
PARAM_RULES = [
    (r"item_emb", P(TP, None)),
    (r"tag_emb", P(TP, None)),
    (r"bilinear_s", P(None, None)),
    (r"proj/w", P(DP, TP)),
]


# ---------------------------------------------------------- embedding bag ----
def _lookup(table, ids):
    """``table`` rows at ``ids``; F.embedding, whose gradient sums each
    row's lookups in a fixed order (an indexing's accumulating backward
    on the CPU does not); on DTensors, on each shard
    (``dist.sharding.embedding``)."""
    return embedding(table, ids)


def embedding_bag(table, ids, *, weights=None, segment_ids=None,
                  num_segments=None, mode="mean"):
    """EmbeddingBag: ragged multi-hot gather-reduce.

    ids: (L,) flat indices into table; segment_ids: (L,) bag assignment
    (monotonic not required); weights: optional per-sample weights.
    Padding convention: weight 0 (or id < 0 -> treated as weight 0).
    """
    valid = (ids >= 0).to(table.dtype)
    w = valid if weights is None else weights * valid
    rows = _lookup(table, torch.clamp_min(ids, 0))               # (L, D)
    rows = rows * w[:, None]
    seg = segment_ids.to(torch.long)
    s = torch.zeros((num_segments, table.shape[1]), dtype=rows.dtype,
                    device=rows.device).index_add(0, seg, rows)
    if mode == "sum":
        return s
    cnt = torch.zeros((num_segments,), dtype=w.dtype,
                      device=w.device).index_add(0, seg, w)
    if mode == "mean":
        return s / torch.clamp_min(cnt, 1.0)[:, None]
    raise ValueError(mode)


# --------------------------------------------------------- capsule routing ----
def _squash(z, axis=-1, eps=1e-9):
    n2 = torch.sum(z * z, dim=axis, keepdim=True)
    return (n2 / (1.0 + n2)) * z / torch.sqrt(n2 + eps)


_ROUTING_INIT: dict = {}


def routing_init(k: int, h: int, device) -> torch.Tensor:
    """The routing logits' start, ``jax.random.normal(PRNGKey(17), (1,
    K, H))``, as a tensor on ``device``, made once per (K, H, device)
    (so a CUDA graph captured after the first call copies nothing from
    the host)."""
    key = (k, h, str(torch.device(device)))
    if key not in _ROUTING_INIT:
        # host arithmetic on real tensors, also when a fake or
        # distributed run is tracing the caller
        from torch.utils._python_dispatch import _disable_current_modes
        with _disable_current_modes():
            _ROUTING_INIT[key] = torch.from_numpy(jax_prng.normal(
                jax_prng.prng_key(17), (1, k, h))).to(device)
    return _ROUTING_INIT[key]


def extract_interests(params, behav_ids, behav_mask, cfg: MINDConfig):
    """B2I dynamic routing. behav_ids: (B, H) -> capsules (B, K, D)."""
    b, h = behav_ids.shape
    k = cfg.n_interests
    e = _lookup(params["item_emb"], torch.clamp_min(behav_ids, 0))
    e = e * behav_mask[..., None]
    e_hat = e @ params["bilinear_s"]                             # (B,H,D)
    e_hat_sg = e_hat.detach()        # paper: routing w/o gradient
    blogit = routing_init(k, h, e_hat.device).expand(b, k, h)
    for _ in range(cfg.capsule_iters - 1):
        w = torch.softmax(blogit, dim=1)                         # over K
        w = w * behav_mask[:, None, :]
        u = _squash(torch.einsum("bkh,bhd->bkd", w, e_hat_sg))
        blogit = blogit + torch.einsum("bkd,bhd->bkh", u, e_hat_sg)
    # final iteration WITH gradient to the embeddings
    w = torch.softmax(blogit, dim=1) * behav_mask[:, None, :]
    return _squash(torch.einsum("bkh,bhd->bkd", w, e_hat))      # (B,K,D)


def user_capsules(params, batch, cfg: MINDConfig):
    """Interests conditioned on profile tags (embedding-bag side
    input)."""
    u = extract_interests(params, batch["behav_ids"], batch["behav_mask"],
                          cfg)                                   # (B,K,D)
    b = u.shape[0]
    tags = embedding_bag(
        params["tag_emb"], batch["tag_ids"].reshape(-1),
        segment_ids=torch.arange(b, device=u.device).repeat_interleave(
            cfg.tag_bag),
        num_segments=b, mode="mean")                             # (B,D)
    tagk = tags[:, None, :].expand(u.shape)
    return dense_apply(params["proj"], torch.cat([u, tagk], dim=-1),
                       activation=torch.relu)                    # (B,K,D)


# ---------------------------------------------------------------- training ----
def label_aware_attention(u, target_e, cfg: MINDConfig):
    """u: (B,K,D), target_e: (B,D) -> user vector (B,D)."""
    scores = torch.einsum("bkd,bd->bk", u, target_e)
    attn = torch.softmax(cfg.label_pow * scores, dim=-1)
    return torch.einsum("bk,bkd->bd", attn, u)


def loss_fn(params, batch, cfg: MINDConfig, mesh=None):
    """In-batch sampled softmax. batch: behav_ids (B,H), behav_mask,
    tag_ids (B,tag_bag), target (B,). Returns (loss, {'loss',
    'in_batch_acc'}). ``mesh`` is taken and unused, as the reference's
    is."""
    u = user_capsules(params, batch, cfg)
    tgt = _lookup(params["item_emb"], batch["target"])           # (B,D)
    uv = label_aware_attention(u, tgt, cfg)                      # (B,D)
    logits = (uv @ tgt.T).to(torch.float32)                      # (B,B)
    labels = torch.arange(uv.shape[0], device=uv.device)
    logp = torch.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, -1, labels[:, None])[:, 0]
    loss = ce.mean()
    acc = (logits.argmax(-1) == labels).to(torch.float32).mean()
    return loss, {"loss": loss, "in_batch_acc": acc}


# ----------------------------------------------------------------- serving ----
def score_candidates(params, batch, cfg: MINDConfig):
    """Multi-interest retrieval scoring (serve shapes).

    batch: behav_ids (B,H), behav_mask, tag_ids, cand_ids (B, C) or a
    shared candidate set (C,). Returns (B, C) scores = max over
    interests.
    """
    u = user_capsules(params, batch, cfg)                        # (B,K,D)
    ce = _lookup(params["item_emb"], batch["cand_ids"])          # (C,D)/(B,C,D)
    if ce.ndim == 2:
        scores = torch.einsum("bkd,cd->bkc", u, ce)
    else:
        scores = torch.einsum("bkd,bcd->bkc", u, ce)
    return scores.amax(dim=1)                                    # (B,C)


def serve_topk(params, batch, cfg: MINDConfig, *, k: int = 100):
    """The ``k`` best candidates of each user: (values, indices), ties
    lower index first as ``jax.lax.top_k``."""
    return top_k(score_candidates(params, batch, cfg), k)
