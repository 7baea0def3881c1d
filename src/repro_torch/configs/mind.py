"""mind [recsys]: embed_dim=64 n_interests=4 capsule_iters=3
interaction=multi-interest [arXiv:1904.08030; unverified].

Counterpart of ``repro/configs/mind.py``; ``cell()`` (a mesh Cell) waits
for ``ROADMAP.md`` queue 1 item 7.

Shapes: train_batch B=65,536 (in-batch sampled softmax), serve_p99 B=512
(online re-rank, 1,024 candidates each), serve_bulk B=262,144 (offline
scoring, 128 candidates each), retrieval_cand B=1 vs 1,000,000 candidates
(single batched matmul + top-k, never a loop)."""
import torch

from repro_torch.models import recsys as model
from repro_torch.optim import AdamWConfig, cosine_warmup

ARCH_ID = "mind"
FAMILY = "recsys"
SHAPES = ["train_batch", "serve_p99", "serve_bulk", "retrieval_cand"]

_META = {
    "train_batch": {"kind": "train", "batch": 65536},
    "serve_p99": {"kind": "serve", "batch": 512, "cands": 1024},
    "serve_bulk": {"kind": "serve", "batch": 262144, "cands": 128},
    "retrieval_cand": {"kind": "serve", "batch": 1, "cands": 1_000_000,
                       "shared_cands": True, "topk": 100},
}

OCFG = AdamWConfig(weight_decay=0.0)
LR = cosine_warmup(peak_lr=1e-3, warmup_steps=100, total_steps=20000)


def full_config():
    return model.MINDConfig(n_items=1_000_000, n_user_tags=100_000,
                            embed_dim=64, n_interests=4, capsule_iters=3,
                            hist_len=50, tag_bag=16)


def smoke_config():
    return model.MINDConfig(n_items=300, n_user_tags=60, embed_dim=16,
                            n_interests=4, capsule_iters=3, hist_len=8,
                            tag_bag=4)


def _train_flops(cfg, b):
    d, k, h = cfg.embed_dim, cfg.n_interests, cfg.hist_len
    routing = b * (2 * h * d * d + cfg.capsule_iters * 4 * k * h * d)
    proj = b * k * 2 * 2 * d * d
    logits = 2.0 * b * b * d
    return 3.0 * (routing + proj + logits)


def _serve_flops(cfg, b, c):
    """The reference's serve cells' MODEL_FLOPS: the user tower and the
    candidates' products."""
    d, k, h = cfg.embed_dim, cfg.n_interests, cfg.hist_len
    user_tower = b * (2 * h * d * d
                      + cfg.capsule_iters * 4 * k * h * d
                      + k * 2 * 2 * d * d)
    return 2.0 * b * k * c * d + user_tower


def cell(shape):
    raise NotImplementedError("the MIND cells are mesh sharding specs for "
                              "the multi-device tools: ROADMAP.md queue 1 "
                              "item 7")


def smoke_run(seed=0, device=None):
    """The smoke config's loss on 16 users and every item's score,
    random weights from ``torch.Generator`` seed ``seed``, on ``device``
    (None: the card)."""
    from repro_torch.data.recsys import mind_batch
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    cfg = smoke_config()
    p = model.init(torch.Generator().manual_seed(seed), cfg)
    p = {k: ({n: t.to(dev) for n, t in v.items()} if isinstance(v, dict)
             else v.to(dev)) for k, v in p.items()}
    batch = {k: torch.from_numpy(v).to(dev) for k, v in mind_batch(
        n_items=cfg.n_items, n_user_tags=cfg.n_user_tags,
        hist_len=cfg.hist_len, tag_bag=cfg.tag_bag, batch=16,
        seed=seed, step=0).items()}
    loss, m = model.loss_fn(p, batch, cfg)
    batch["cand_ids"] = torch.arange(cfg.n_items, dtype=torch.int32,
                                     device=dev)
    scores = model.score_candidates(p, batch, cfg)
    return {"loss": loss, "scores": scores, "metrics": m}
