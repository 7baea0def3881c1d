"""CSR ragged-event utilities: padding-free event batches.

A copy of ``repro/data/ragged.py`` (numpy only), so that the same
events pack into byte-identical bins in both packages.

- **CSR stream layout** — the wire format a ragged event stream emits
  (``belle2.event_stream_ragged``): one concatenated hit matrix
  ``feats (R, d)`` plus monotone per-event ``offsets (B+1,)`` with
  ``offsets[e]..offsets[e+1]`` delimiting event ``e``'s hits.
  Zero-hit events are legal (empty slices); within-event hit order is
  preserved exactly (events are energy-sorted upstream).

- **Binned device layout** — what the ragged executable launches on.
  Events are first-fit packed *whole* into bins of ``capacity`` rows
  (the detector's ``n_hits`` max, so every event fits one bin).
  Companion index planes make the packing reversible and let kernels
  keep selection block-diagonal *per event* even when several events
  share a bin:

      feats  (n_bins, capacity, d)   packed hit features
      mask   (n_bins, capacity)      1.0 on real hits
      segids (n_bins, capacity) i32  global event index; −1 on padding
      slots  (n_bins, capacity) i32  hit index within its event

  Because events are packed contiguously and never split, a hit's
  within-event neighbors occupy the same bin with their relative
  order intact — the property the kNN kernel's lowest-index tie-break
  relies on for ragged-vs-padded agreement.

Packing runs on the host: it maps arbitrary occupancy mixes onto one
fixed ``(n_bins, capacity, ·)`` launch shape.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


# ------------------------------------------------------------ CSR helpers ----
def offsets_from_counts(counts) -> np.ndarray:
    """Monotone CSR offsets (len+1,) from per-segment counts."""
    counts = np.asarray(counts, np.int64)
    if counts.ndim != 1 or (counts < 0).any():
        raise ValueError(f"counts must be 1-D non-negative, got "
                         f"shape {counts.shape}")
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)


def group_by_segment(values, segments, n_segments: int):
    """Stable-group ``values`` rows by their segment id.

    Returns ``(grouped, offsets)``: ``grouped`` is ``values`` reordered
    so each segment's rows are contiguous (original relative order
    preserved — stable sort), ``offsets`` the CSR delimiters.
    """
    values = np.asarray(values)
    segments = np.asarray(segments)
    if segments.shape[0] != values.shape[0]:
        raise ValueError(f"{values.shape[0]} values vs "
                         f"{segments.shape[0]} segment ids")
    order = np.argsort(segments, kind="stable")
    counts = np.bincount(segments, minlength=n_segments)
    if len(counts) > n_segments:
        raise ValueError(f"segment id {segments.max()} >= "
                         f"n_segments {n_segments}")
    return values[order], offsets_from_counts(counts)


# ----------------------------------------------------------- CSR batches ----
class RaggedBatch(NamedTuple):
    """Concatenated hits + per-event CSR offsets (the stream layout)."""
    feats: np.ndarray      # (R, d)
    offsets: np.ndarray    # (B+1,) monotone, offsets[0]=0, offsets[-1]=R

    @property
    def n_events(self) -> int:
        return self.offsets.shape[0] - 1

    def counts(self) -> np.ndarray:
        return np.diff(self.offsets)

    def event(self, e: int) -> np.ndarray:
        return self.feats[self.offsets[e]:self.offsets[e + 1]]


def validate_ragged(rb: RaggedBatch) -> None:
    """Raise ValueError unless offsets are monotone and consistent."""
    offs = np.asarray(rb.offsets)
    if offs.ndim != 1 or offs.shape[0] < 1:
        raise ValueError(f"offsets must be 1-D non-empty, got {offs.shape}")
    if offs[0] != 0:
        raise ValueError(f"offsets[0] must be 0, got {offs[0]}")
    if (np.diff(offs) < 0).any():
        raise ValueError("offsets must be monotone non-decreasing")
    if offs[-1] != rb.feats.shape[0]:
        raise ValueError(f"offsets[-1]={offs[-1]} != "
                         f"feats rows {rb.feats.shape[0]}")


def pack_events(feats, mask) -> RaggedBatch:
    """Padded ``feats (B, N, d)`` + ``mask (B, N)`` → CSR.

    Keeps only rows with mask > 0, preserving within-event order. The
    exact inverse of :func:`unpack_events` for feeds whose real hits
    are a prefix of the hit axis (how data/belle2 generates them).
    """
    feats = np.asarray(feats)
    mask = np.asarray(mask)
    if feats.ndim != 3 or mask.shape != feats.shape[:2]:
        raise ValueError(f"feats {feats.shape} vs mask {mask.shape}")
    ev, hit = np.nonzero(mask > 0)
    # np.nonzero is row-major: already stable-grouped by event with
    # within-event order intact, but events with zero hits still need
    # offsets — bincount covers them.
    counts = np.bincount(ev, minlength=feats.shape[0])
    return RaggedBatch(feats=feats[ev, hit],
                       offsets=offsets_from_counts(counts))


def unpack_events(rb: RaggedBatch, n_hits: int):
    """CSR → padded ``(B, n_hits, d)`` feats + ``(B, n_hits)`` mask."""
    validate_ragged(rb)
    b = rb.n_events
    d = rb.feats.shape[1]
    feats = np.zeros((b, n_hits, d), rb.feats.dtype)
    mask = np.zeros((b, n_hits), np.float32)
    counts = rb.counts()
    if (counts > n_hits).any():
        raise ValueError(f"event with {counts.max()} hits exceeds "
                         f"n_hits={n_hits}")
    ev = np.repeat(np.arange(b), counts)
    slot = np.arange(rb.feats.shape[0]) - np.repeat(rb.offsets[:-1], counts)
    feats[ev, slot] = rb.feats
    mask[ev, slot] = 1.0
    return feats, mask


# --------------------------------------------------------- binned packing ----
class BinPacked(NamedTuple):
    """The ragged executable's device layout (see module docstring)."""
    feats: np.ndarray      # (n_bins, capacity, d)
    mask: np.ndarray       # (n_bins, capacity) f32
    segids: np.ndarray     # (n_bins, capacity) i32; −1 on padding
    slots: np.ndarray      # (n_bins, capacity) i32; hit idx within event
    n_events: int


def bins_needed(counts, capacity: int) -> int:
    """Number of bins first-fit packing will open for these counts."""
    fill: list[int] = []
    for c in np.asarray(counts, np.int64):
        c = int(c)
        if c == 0:
            continue
        for i, f in enumerate(fill):
            if f + c <= capacity:
                fill[i] = f + c
                break
        else:
            fill.append(c)
    return len(fill)


def bin_pack(rb: RaggedBatch, capacity: int, *,
             n_bins: int | None = None) -> BinPacked:
    """First-fit pack whole events into ``capacity``-row bins.

    Events are never split; an event larger than ``capacity`` raises
    (``capacity`` is the detector max, so upstream data cannot produce
    one). ``n_bins`` pins the output's leading dim (zero-padded empty
    bins) so one executable shape serves every occupancy mix; packing
    that needs more bins raises — the caller splits into multiple
    launches (see ``pipeline.RaggedPipeline``).
    """
    validate_ragged(rb)
    counts = rb.counts()
    if counts.size and counts.max() > capacity:
        raise ValueError(f"event with {counts.max()} hits exceeds bin "
                         f"capacity {capacity}")
    # first-fit assignment: bin id + row offset per event
    fill: list[int] = []
    ev_bin = np.zeros(rb.n_events, np.int64)
    ev_row = np.zeros(rb.n_events, np.int64)
    for e, c in enumerate(counts):
        c = int(c)
        if c == 0:
            ev_bin[e] = -1
            continue
        for i, f in enumerate(fill):
            if f + c <= capacity:
                ev_bin[e], ev_row[e] = i, f
                fill[i] = f + c
                break
        else:
            ev_bin[e], ev_row[e] = len(fill), 0
            fill.append(c)
    nb = max(len(fill), 1)
    if n_bins is not None:
        if nb > n_bins:
            raise ValueError(f"packing needs {nb} bins > n_bins={n_bins}")
        nb = n_bins
    d = rb.feats.shape[1]
    feats = np.zeros((nb, capacity, d), rb.feats.dtype)
    mask = np.zeros((nb, capacity), np.float32)
    segids = np.full((nb, capacity), -1, np.int32)
    slots = np.zeros((nb, capacity), np.int32)
    total = rb.feats.shape[0]
    if total:
        nz = counts > 0
        evs = np.flatnonzero(nz)
        hit_ev = np.repeat(evs, counts[nz])
        hit_slot = (np.arange(total)
                    - np.repeat(rb.offsets[:-1][nz], counts[nz]))
        hit_bin = ev_bin[hit_ev]
        hit_row = ev_row[hit_ev] + hit_slot
        feats[hit_bin, hit_row] = rb.feats
        mask[hit_bin, hit_row] = 1.0
        segids[hit_bin, hit_row] = hit_ev
        slots[hit_bin, hit_row] = hit_slot
    return BinPacked(feats=feats, mask=mask, segids=segids, slots=slots,
                     n_events=rb.n_events)


def unpack_binned(values, segids, slots, n_events: int, n_hits: int):
    """Scatter packed per-hit ``values (n_bins, capacity, ...)`` back to
    the padded per-event layout ``(n_events, n_hits, ...)``; padding
    rows (segid −1) are dropped."""
    values = np.asarray(values)
    segids = np.asarray(segids)
    slots = np.asarray(slots)
    out = np.zeros((n_events, n_hits, *values.shape[2:]), values.dtype)
    sel = segids >= 0
    out[segids[sel], slots[sel]] = values[sel]
    return out
