"""Synthetic MIND data: users with latent multi-interest structure —
each user draws 1..K interests; behaviors are items clustered by
interest, so multi-interest capsules genuinely help (single-vector
models mix interests). Deterministic per (seed, step).

The port's copy of ``repro/data/recsys.py`` (numpy only): its batches are
the reference's byte for byte. ``mind_batch`` is a Python loop over the
users: make large batches ahead of a timed run."""
from __future__ import annotations

import numpy as np


def mind_batch(*, n_items: int, n_user_tags: int, hist_len: int,
               tag_bag: int, batch: int, n_interest_clusters: int = 64,
               seed: int, step: int):
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    items_per = n_items // n_interest_clusters
    n_user_interests = rng.integers(1, 4, size=batch)
    behav = np.zeros((batch, hist_len), np.int32)
    target = np.zeros((batch,), np.int32)
    for u in range(batch):
        ints = rng.choice(n_interest_clusters, size=n_user_interests[u],
                          replace=False)
        which = rng.choice(ints, size=hist_len + 1)
        offs = rng.integers(0, items_per, size=hist_len + 1)
        seq = which * items_per + offs
        behav[u] = seq[:-1]
        target[u] = seq[-1]
    behav_mask = (rng.uniform(size=(batch, hist_len)) < 0.9
                  ).astype(np.float32)
    tags = rng.integers(0, n_user_tags, size=(batch, tag_bag)
                        ).astype(np.int32)
    return {"behav_ids": behav, "behav_mask": behav_mask,
            "tag_ids": tags, "target": target}


def mind_stream(cfg, batch: int, *, seed: int = 0, start_step: int = 0):
    step = start_step
    while True:
        yield mind_batch(n_items=cfg.n_items, n_user_tags=cfg.n_user_tags,
                         hist_len=cfg.hist_len, tag_bag=cfg.tag_bag,
                         batch=batch, seed=seed, step=step)
        step += 1
