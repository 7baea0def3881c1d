"""Synthetic Belle II ECL trigger events.

A copy of ``repro/data/belle2.py`` (numpy only), so that the same seed
gives byte-identical events in both packages, padded or ragged (CSR,
``generate_ragged`` and ``event_stream_ragged``).

The detector is modeled as a cylindrical crystal grid (θ × φ); the current
trigger reads 576 cells (24×24), the upgraded detector 8736 (56×156).
Each event contains 0..max_clusters electromagnetic clusters (photon- or
hadron-like transverse profiles) over beam-background noise hits; the
trigger front-end reads out the ``n_hits`` highest-energy crystals
(zero-padded when fewer fire — matching the paper's zero-padding of up to
128 of 8736 sparse non-zero inputs).

Per-hit features: (E, θ_norm, φ_norm, t). Per-hit labels for object
condensation: object_id (cluster idx or −1 for noise), true cluster
energy, class (0 photon, 1 hadron, 2 background).

Occupancy knob: by default an event's non-zero hit count is whatever
physics produced (clusters + noise, capped at ``n_hits``) — with the
default cluster/noise rates that clusters tightly near the cap, so
every event looks like a maximum-occupancy event and an
occupancy-bucketed serving path (``deploy_bucketed``) is untestable.
``Belle2Config.occupancy`` fixes that: a tuple of ``(max_hits, weight)``
pairs defines a per-event distribution over occupancy caps; each event
draws a cap (weights normalized) and keeps only its ``cap``
highest-energy hits, emulating the real detector's occupancy spread
(most trigger events fire a small fraction of the readout). Example::

    cfg = dataclasses.replace(current_detector(),
                              occupancy=((8, 0.5), (16, 0.3), (32, 0.2)))

``occupancy=None`` (default) preserves the legacy behavior exactly;
``with_occupancy(cfg, buckets, weights)`` builds the tuple for a
bucket list. Draws consume the same seeded generator as the rest of
the event, so generation stays deterministic per seed.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data.ragged import pack_events


@dataclasses.dataclass(frozen=True)
class Belle2Config:
    n_crystals: int = 8736
    grid: tuple = (56, 156)          # θ × φ; 24×24 for the 576-cell trigger
    n_hits: int = 128
    max_clusters: int = 6
    mean_clusters: float = 2.0
    noise_rate: float = 40.0         # expected background hits / event
    e_min: float = 0.05              # GeV
    e_scale: float = 0.8
    cluster_sigma: float = 1.1       # crystals
    hadron_frac: float = 0.3
    time_jitter: float = 0.2
    # per-event occupancy-cap distribution: ((max_hits, weight), ...);
    # None = legacy behavior (no cap below n_hits). See module docstring.
    occupancy: tuple | None = None


def current_detector() -> Belle2Config:
    return Belle2Config(n_crystals=576, grid=(24, 24), n_hits=32,
                        noise_rate=8.0)


def with_occupancy(cfg: Belle2Config, buckets, weights=None) -> Belle2Config:
    """Config copy whose events spread over ``buckets`` occupancy caps
    (uniform weights unless given) — the natural companion of an
    occupancy-bucketed deployment over the same bucket list."""
    bs = [int(b) for b in buckets]
    ws = [1.0] * len(bs) if weights is None else [float(w) for w in weights]
    if len(ws) != len(bs):
        raise ValueError(f"{len(bs)} buckets but {len(ws)} weights")
    return dataclasses.replace(cfg, occupancy=tuple(zip(bs, ws)))


def generate(cfg: Belle2Config, batch: int, seed: int):
    """Returns dict of numpy arrays: feats (B,N,4), mask (B,N),
    object_id (B,N), energy (B,N), cls (B,N), trigger_truth (B,)."""
    rng = np.random.default_rng(seed)
    nt, nph = cfg.grid
    b, n = batch, cfg.n_hits
    caps, cap_p = None, None
    if cfg.occupancy is not None:
        caps = np.asarray([c for c, _ in cfg.occupancy], np.int64)
        w = np.asarray([w for _, w in cfg.occupancy], np.float64)
        if caps.size == 0 or (w < 0).any() or w.sum() <= 0:
            raise ValueError(f"invalid occupancy profile {cfg.occupancy!r}")
        cap_p = w / w.sum()
    feats = np.zeros((b, n, 4), np.float32)
    mask = np.zeros((b, n), np.float32)
    obj = np.full((b, n), -1, np.int32)
    energy = np.zeros((b, n), np.float32)
    cls = np.full((b, n), 2, np.int32)
    trigger = np.zeros((b,), np.float32)

    for ev in range(b):
        e_grid = np.zeros((nt, nph), np.float32)
        id_grid = np.full((nt, nph), -1, np.int32)
        cls_grid = np.full((nt, nph), 2, np.int32)
        eobj_grid = np.zeros((nt, nph), np.float32)
        k = min(rng.poisson(cfg.mean_clusters), cfg.max_clusters)
        for c in range(k):
            ct = rng.uniform(2, nt - 2)
            cp = rng.uniform(0, nph)
            e_c = cfg.e_min + rng.exponential(cfg.e_scale)
            is_hadron = rng.uniform() < cfg.hadron_frac
            sig = cfg.cluster_sigma * (1.6 if is_hadron else 1.0)
            n_dep = rng.poisson(9 if is_hadron else 7) + 3
            dts = rng.normal(0, sig, size=n_dep)
            dps = rng.normal(0, sig, size=n_dep)
            fr = rng.dirichlet(np.ones(n_dep) * (0.5 if is_hadron else 1.5))
            for d in range(n_dep):
                t_i = int(np.clip(round(ct + dts[d]), 0, nt - 1))
                p_i = int(round(cp + dps[d])) % nph
                e_grid[t_i, p_i] += e_c * fr[d]
                if e_c * fr[d] > eobj_grid[t_i, p_i]:
                    id_grid[t_i, p_i] = c
                    cls_grid[t_i, p_i] = 1 if is_hadron else 0
                    eobj_grid[t_i, p_i] = e_c
        # beam background noise
        n_noise = rng.poisson(cfg.noise_rate)
        tn = rng.integers(0, nt, size=n_noise)
        pn = rng.integers(0, nph, size=n_noise)
        np.add.at(e_grid, (tn, pn), rng.exponential(0.02, size=n_noise))

        flat = e_grid.reshape(-1)
        nz = np.flatnonzero(flat > 0.01)
        cap = n if caps is None else min(n, int(rng.choice(caps, p=cap_p)))
        order = nz[np.argsort(-flat[nz])][:cap]
        m = order.size
        t_idx, p_idx = np.unravel_index(order, (nt, nph))
        feats[ev, :m, 0] = flat[order]
        feats[ev, :m, 1] = t_idx / nt - 0.5
        feats[ev, :m, 2] = p_idx / nph - 0.5
        feats[ev, :m, 3] = rng.normal(0, cfg.time_jitter, size=m)
        mask[ev, :m] = 1.0
        obj[ev, :m] = id_grid.reshape(-1)[order]
        energy[ev, :m] = eobj_grid.reshape(-1)[order]
        cls[ev, :m] = cls_grid.reshape(-1)[order]
        trigger[ev] = float(k > 0)

    return {"feats": feats, "mask": mask, "object_id": obj,
            "energy": energy, "cls": cls, "trigger_truth": trigger}


def event_stream(cfg: Belle2Config, batch: int, *, seed0: int = 0):
    step = 0
    while True:
        yield generate(cfg, batch, seed0 + step)
        step += 1



def generate_ragged(cfg: Belle2Config, batch: int, seed: int):
    """One ragged (CSR) batch: the padded batch with its padding
    stripped. Returns ``{"ragged": RaggedBatch, "trigger_truth": (B,)}``
    plus the per-hit truth arrays concatenated in the same CSR order
    (``object_id``, ``energy``, ``cls`` — each ``(R,)``).

    ``ragged.unpack_events(out["ragged"], cfg.n_hits)`` reproduces
    ``generate(...)``'s feats/mask bit for bit, because generated
    events are hit-prefix-packed already.
    """
    data = generate(cfg, batch, seed)
    rb = pack_events(data["feats"], data["mask"])
    ev, hit = np.nonzero(data["mask"] > 0)
    return {"ragged": rb,
            "object_id": data["object_id"][ev, hit],
            "energy": data["energy"][ev, hit],
            "cls": data["cls"][ev, hit],
            "trigger_truth": data["trigger_truth"]}


def event_stream_ragged(cfg: Belle2Config, batch: int, *, seed0: int = 0):
    """Ragged (CSR) companion of :func:`event_stream`: yields
    :func:`generate_ragged` batches. Seeded identically, so stream step
    ``t`` here is the padded stream's step ``t`` minus its padding."""
    step = 0
    while True:
        yield generate_ragged(cfg, batch, seed0 + step)
        step += 1
