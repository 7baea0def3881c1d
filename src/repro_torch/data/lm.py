"""Synthetic LM token pipeline: Zipf-distributed tokens with a Markov
flavor so the loss has learnable structure; deterministic per (seed, step)
so checkpoint-resume replays the exact stream (fault-tolerance invariant).

The port's copy of ``repro/data/lm.py`` (numpy only): its batches are the
reference's byte for byte.
"""
from __future__ import annotations

import numpy as np


def lm_batch(vocab: int, batch: int, seq: int, *, seed: int, step: int):
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    # zipf-ish marginal
    base = rng.zipf(1.3, size=(batch, seq + 1)).astype(np.int64)
    toks = (base % vocab).astype(np.int32)
    # inject local structure: with p=0.3, next token = (prev*7+3) % vocab
    rep = rng.uniform(size=(batch, seq)) < 0.3
    nxt = (toks[:, :-1] * 7 + 3) % vocab
    toks[:, 1:] = np.where(rep, nxt, toks[:, 1:])
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def lm_stream(vocab: int, batch: int, seq: int, *, seed: int = 0,
              start_step: int = 0):
    step = start_step
    while True:
        yield lm_batch(vocab, batch, seq, seed=seed, step=step)
        step += 1
