"""The benchmark's own inputs, made from the seed with numpy.

- :func:`belle2_events`: synthetic Belle II calorimeter events, a vectorised
  rewrite of the program's ``data/belle2.py:generate``, summed over the hit
  crystals alone rather than the whole grid (the same
  distributions: Poisson clusters of Dirichlet-shared energy deposits on the
  crystal grid, exponential beam-background noise, the ``n_hits``
  highest-energy crystals above 10 MeV, energy-sorted and zero-padded; the
  draws come in another order, so the events differ from the program's for
  one seed);
- :func:`arrival_gaps`: the open loop's inter-arrival gaps.

Every function takes a ``numpy.random.Generator``; :func:`rng` derives one
per purpose from the run's seed, so that the weights, the calibration events,
the traffic pool and the arrivals do not share a stream.
"""
from __future__ import annotations

import numpy as np

STREAMS = {"weights": 1, "calibration": 2, "pool": 3, "arrivals": 4}


def rng(seed: int, purpose: str) -> np.random.Generator:
    return np.random.default_rng([STREAMS[purpose], int(seed) % 2 ** 64])


def derived_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for a torch generator, from the run's seed."""
    return int(rng(seed, purpose).integers(0, 2 ** 63 - 1))


def belle2_events(p: dict, n: int, gen: np.random.Generator,
                  chunk: int = 512) -> dict:
    """``n`` events of the detector ``p`` (the configuration's "events"):
    feats (n, n_hits, 4) float32 = (E in GeV, theta and phi of the crystal
    in [-0.5, 0.5), time), mask (n, n_hits) float32 and the number of
    clusters per event."""
    parts = [_belle2_chunk(p, min(chunk, n - s), gen)
             for s in range(0, n, chunk)]
    return {k: np.concatenate([q[k] for q in parts]) for k in parts[0]}


def _belle2_chunk(p, b, gen):
    nt, nph = p["grid"]
    ncell = nt * nph
    nh = p["n_hits"]
    k = np.minimum(gen.poisson(p["mean_clusters"], b), p["max_clusters"])
    cl_ev = np.repeat(np.arange(b), k)
    c = len(cl_ev)
    ct = gen.uniform(2, nt - 2, c)
    cp = gen.uniform(0, nph, c)
    e_c = p["e_min"] + gen.exponential(p["e_scale"], c)
    hadron = gen.uniform(size=c) < p["hadron_frac"]
    sig = p["cluster_sigma"] * np.where(hadron, 1.6, 1.0)
    n_dep = gen.poisson(np.where(hadron, 9, 7)) + 3
    dep = np.repeat(np.arange(c), n_dep)
    dt = gen.normal(size=len(dep)) * sig[dep]
    dp = gen.normal(size=len(dep)) * sig[dep]
    g = gen.gamma(np.where(hadron, 0.5, 1.5)[dep])      # Dirichlet shares
    frac = g / np.bincount(dep, g, minlength=c)[dep]
    t_i = np.clip(np.rint(ct[dep] + dt), 0, nt - 1).astype(np.int64)
    p_i = np.rint(cp[dep] + dp).astype(np.int64) % nph
    n_noise = gen.poisson(p["noise_rate"], b)
    ev_n = np.repeat(np.arange(b), n_noise)
    tn = gen.integers(0, nt, len(ev_n))
    pn = gen.integers(0, nph, len(ev_n))
    en = gen.exponential(0.02, len(ev_n))
    cell = np.concatenate([cl_ev[dep] * ncell + t_i * nph + p_i,
                           ev_n * ncell + tn * nph + pn])
    energy = np.concatenate([e_c[dep] * frac, en])
    # each hit crystal's energy (summed in draw order), then per event the
    # n_hits highest above 10 MeV, energy-sorted
    hit, inv = np.unique(cell, return_inverse=True)
    e_hit = np.bincount(inv, energy)
    keep = e_hit > 0.01
    hit, e_hit = hit[keep], e_hit[keep]
    ev = hit // ncell
    order = np.lexsort((-e_hit, ev))
    hit, e_hit, ev = hit[order], e_hit[order], ev[order]
    rank = np.arange(len(ev)) - np.searchsorted(ev, np.arange(b))[ev]
    top = rank < nh
    ev, rank, hit, e_hit = ev[top], rank[top], hit[top] % ncell, e_hit[top]
    feats = np.zeros((b, nh, 4), np.float32)
    valid = np.zeros((b, nh), bool)
    valid[ev, rank] = True
    feats[ev, rank, 0] = e_hit
    feats[ev, rank, 1] = (hit // nph) / nt - 0.5
    feats[ev, rank, 2] = (hit % nph) / nph - 0.5
    feats[..., 3] = np.where(valid, gen.normal(0, p["time_jitter"], (b, nh)),
                             0.0)
    return {"feats": feats, "mask": valid.astype(np.float32),
            "clusters": k.astype(np.int32)}


def arrival_gaps(rate: float, n: int, gen: np.random.Generator) -> np.ndarray:
    """``n`` inter-arrival gaps of a Poisson stream of ``rate`` a second:
    the exponential distribution's quantiles at (i + 1/2) / n, in an order
    drawn from ``gen``. Every seed gets the same gaps, so the load is the
    same and only the bursts move."""
    q = (np.arange(n) + 0.5) / n
    return gen.permutation(-np.log1p(-q) / rate)
