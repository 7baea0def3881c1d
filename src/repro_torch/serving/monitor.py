"""Monitoring/visualization substrate (paper §III-B: the demonstrator's
postprocessing + event-display pipeline).

- ``TriggerMonitor``: rolling trigger-rate / cluster-occupancy /
  latency / truth-matched efficiency statistics plus a bounded ring
  buffer of event-display records.  ``record()`` is the hot-path entry
  point and does O(1) work — it stages a reference and a timestamp and
  returns; all numpy conversion, windowed aggregation, and display-dict
  building is deferred to ``snapshot()``/``displays()``, which run on
  the monitoring thread (the paper streams these to an external
  client, not through the trigger path).
- ``MonitorSnapshot``: one monitor's statistics as a plain JSON-ready
  dict; ``MonitorSnapshot.merge`` pools several per-replica monitors
  into the fleet view.
- ``event_display``: one event's display payload (cluster positions in
  detector (θ, φ) coordinates, energies, β) as a JSON-serializable
  dict.  The grid comes from the detector config — never hard-coded.

The port of ``repro/serving/monitor.py``: the same statistics, records
and JSON on the same inputs and clock. Wherever the reference takes an
array, a torch tensor (on any device) is taken too: ``_host`` brings it
to the host as numpy when it is folded or displayed, never on the
recording path.
"""
from __future__ import annotations

import collections
import json
import threading
import time

import numpy as np
import torch

__all__ = ["MonitorSnapshot", "TriggerMonitor", "detector_grid",
           "event_display", "write_display"]

# θ × φ crystal grids of the two Belle II ECL readouts the repo models
# (see data.belle2): keyed by crystal count so either a Belle2Config
# (which carries .grid) or a CCNConfig (which carries .n_crystals)
# identifies its detector.
_GRIDS_BY_CRYSTALS = {576: (24, 24), 8736: (56, 156)}
_DEFAULT_GRID = (56, 156)          # the upgraded detector (paper target)


def _host(v):
    """``v`` as numpy: a tensor is brought to the host, anything else
    goes through ``np.asarray``."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def detector_grid(detector=None) -> tuple[int, int]:
    """(n_θ, n_φ) for a detector/CCN config: ``Belle2Config.grid`` when
    present, else inferred from ``n_crystals``; ``None`` means the
    upgraded-detector default."""
    if detector is None:
        return _DEFAULT_GRID
    grid = getattr(detector, "grid", None)
    if grid is not None:
        nt, nph = grid
        return int(nt), int(nph)
    n = getattr(detector, "n_crystals", None)
    if n in _GRIDS_BY_CRYSTALS:
        return _GRIDS_BY_CRYSTALS[n]
    raise ValueError(
        f"cannot infer a (θ, φ) grid from {detector!r}: expected a "
        f".grid attribute or n_crystals in {sorted(_GRIDS_BY_CRYSTALS)}")


def event_display(cps_result, *, event_id: int, detector=None,
                  grid=None, truth: bool | None = None) -> dict:
    """One event's display record: cluster (θ, φ) detector coordinates,
    energy and β per condensation point.

    ``cluster_xy`` are learned normalized coordinates nominally in
    [-0.5, 0.5] (hit features are ``idx/n - 0.5``); they are clipped to
    that extent before mapping onto the grid, so a cluster the network
    places slightly outside the detector renders at the edge instead of
    off-screen.  Pass the detector (or CCN) config so the grid matches
    the geometry that produced the event — 24×24 for the current
    trigger, 56×156 for the upgrade.
    """
    if grid is None:
        grid = detector_grid(detector)
    nt, nph = int(grid[0]), int(grid[1])
    valid = _host(cps_result["cluster_valid"]) > 0
    xy = np.clip(np.asarray(_host(cps_result["cluster_xy"]), np.float64),
                 -0.5, 0.5)
    e = _host(cps_result["cluster_e"])
    beta = _host(cps_result["cluster_beta"])
    rec = {
        "event": int(event_id),
        "trigger": bool(_host(cps_result["trigger"])),
        "grid": [nt, nph],
        "clusters": [
            {"theta": float((xy[i, 0] + 0.5) * nt),
             "phi": float((xy[i, 1] + 0.5) * nph),
             "energy": float(e[i]),
             "beta": float(beta[i])}
            for i in range(valid.size) if valid[i]],
    }
    if truth is not None:
        rec["truth"] = bool(truth)
    return rec


class MonitorSnapshot(dict):
    """One monitor's statistics as a plain dict (JSON-ready).

    ``merge`` pools the raw windowed samples of several per-replica
    monitors into one fleet-level snapshot, so percentiles and rates
    are computed over the union of windows rather than averaged
    averages."""

    @classmethod
    def merge(cls, monitors) -> "MonitorSnapshot":
        monitors = list(monitors)
        pooled = [m._pooled_samples() for m in monitors]
        now = monitors[0]._clock() if monitors else time.perf_counter()

        def tot(key):
            return sum(p[key] for p in pooled)

        firsts = [p["first_time"] for p in pooled
                  if p["first_time"] is not None]
        return cls(_snapshot_from(
            events=tot("events"),
            window_events=tot("window_events"),
            first_time=min(firsts) if firsts else None,
            trig_sum=tot("trig_sum"), trig_n=tot("trig_n"),
            nclus_sum=tot("nclus_sum"), nclus_n=tot("nclus_n"),
            e_sum=tot("e_sum"), e_n=tot("e_n"),
            lat=np.concatenate([np.asarray(p["lat"], np.float64)
                                for p in pooled])
            if pooled else np.empty(0),
            sig=tot("sig"), sig_fired=tot("sig_fired"),
            bkg=tot("bkg"), bkg_fired=tot("bkg_fired"),
            t0=min((p["t0"] for p in pooled), default=now),
            now=now))


def _snapshot_from(*, events, window_events, first_time, trig_sum,
                   trig_n, nclus_sum, nclus_n, e_sum, e_n, lat, sig,
                   sig_fired, bkg, bkg_fired, t0, now) -> dict:
    """Assemble the snapshot dict from windowed running sums.  ``now``
    is the single wall-clock reading every derived quantity shares —
    ``wall_s``, ``window_s`` and ``rate_ev_s`` can never disagree
    about what time it is."""
    window_s = (now - first_time) if first_time is not None else 0.0
    lat_a = np.asarray(lat, np.float64) if len(lat) else None
    return {
        "events": events,                       # lifetime counter
        "window_events": window_events,         # everything below is
        "wall_s": now - t0,                     # over this window
        "window_s": window_s,
        "rate_ev_s": window_events / window_s if window_s > 0 else 0.0,
        "trigger_rate": trig_sum / trig_n if trig_n else None,
        "clusters_per_event": nclus_sum / nclus_n if nclus_n else None,
        "cluster_e_mean": e_sum / e_n if e_n else None,
        "latency_p50_us": float(np.percentile(lat_a, 50)) * 1e6
        if lat_a is not None else None,
        "latency_p99_us": float(np.percentile(lat_a, 99)) * 1e6
        if lat_a is not None else None,
        "truth_events": int(sig + bkg),
        "efficiency": sig_fired / sig if sig else None,
        "fake_rate": bkg_fired / bkg if bkg else None,
    }


class _Ring:
    """Fixed-capacity numpy ring with a running sum.  Writes are
    vectorized slice assignments that subtract the overwritten segment
    from the sum in the same step, so windowed means are O(1) and
    eviction costs no per-element Python at all."""

    __slots__ = ("buf", "cap", "head", "count", "sum", "_writes")

    def __init__(self, cap: int, dtype=np.float64):
        self.buf = np.zeros(cap, dtype)
        self.cap = cap
        self.head = 0
        self.count = 0
        self.sum = 0.0
        self._writes = 0

    def extend(self, vals):
        vals = np.asarray(_host(vals), self.buf.dtype)
        m = vals.size
        if m == 0:
            return
        if m >= self.cap:
            vals = vals[-self.cap:]
            m = self.cap
        i, end = self.head, self.head + m
        if end <= self.cap:
            seg = self.buf[i:end]
            self.sum += float(vals.sum()) - float(seg.sum())
            seg[:] = vals
        else:
            k = self.cap - i
            lo, hi = self.buf[i:], self.buf[:end - self.cap]
            self.sum += (float(vals.sum()) - float(lo.sum())
                         - float(hi.sum()))
            lo[:] = vals[:k]
            hi[:] = vals[k:]
        self.head = end % self.cap
        self.count = min(self.count + m, self.cap)
        self._writes += 1
        if self._writes % 4096 == 0:    # float-drift resync (cheap;
            self.sum = float(self.buf.sum())   # exact for 0/1 data)

    def append(self, v):
        self.extend(np.asarray([v], self.buf.dtype))

    def window(self) -> np.ndarray:
        """The live values (unordered — fine for means/percentiles)."""
        return self.buf[:self.count] if self.count < self.cap \
            else self.buf


class TriggerMonitor:
    """Rolling trigger statistics with hot-path-cheap recording.

    The hot-path entry points — ``record()`` per event,
    ``record_batch()``/``record_raw()`` per micro-batch — only append
    a reference tuple to a bounded staging deque and bump the lifetime
    counter; no numpy runs on the serving path.  Staged entries are
    folded lazily, under ``_agg_lock``, whenever a reader calls
    ``snapshot()``/``displays()``: windowed statistics live in
    fixed-size numpy rings with running sums (vectorized eviction,
    O(1) means), the windowed rate comes from per-fold
    ``(timestamp, events)`` marks, and display dicts are only built
    for the records a reader actually asks for.  If no reader ever
    shows up the staging deque just wraps (bounded at ``window``
    staged entries — an entry is one event or one micro-batch of CPS
    arrays, so a wrap on the batch path drops that whole batch's
    samples), and nothing unbounded accumulates.

    ``display_every`` thins the event-display ring (keep every k-th
    event, by event id, on both the per-event and the batch paths);
    ``clock`` is injectable for deterministic tests.
    """

    def __init__(self, *, window: int = 4096, display_n: int = 64,
                 display_every: int = 1, detector=None, grid=None,
                 clock=time.perf_counter):
        self.window = window
        self.grid = tuple(grid) if grid is not None \
            else detector_grid(detector)
        self.display_every = max(1, int(display_every))
        self._clock = clock
        self.total = 0
        # the lifetime counter is bumped from concurrent dispatch
        # workers (a replica runs up to `inflight` batches at once);
        # a bare += would lose increments.
        self._total_lock = threading.Lock()
        self.t0 = clock()
        self._pending = collections.deque(maxlen=window)
        self._display = collections.deque(maxlen=display_n)
        # rate marks: one (timestamp, events-folded-before) pair per
        # folded record/batch; the windowed rate spans the retained
        # marks, costing one deque append per batch instead of one
        # timestamped entry per event.
        self._marks = collections.deque(maxlen=window)
        self._folded = 0
        # windowed state lives in numpy rings: O(1) means, vectorized
        # eviction, and the latency percentile reads the ring buffer
        # directly without a copy.
        self._lat = _Ring(window)
        self._trig = _Ring(window)        # 0/1 trigger decisions
        self._nclus = _Ring(window)       # clusters per event
        self._energy = _Ring(window)      # per-cluster energies
        # truth-matched windows (per event *with* a truth bit):
        self._tr_sig = _Ring(window)      # 1 if truth-signal
        self._tr_sigf = _Ring(window)     # fired & truth-signal
        self._tr_bkgf = _Ring(window)     # fired & truth-background
        self._agg_lock = threading.Lock()

    # ------------------------------------------------------------ hot path --
    def record(self, cps_result, latency_s: float | None = None, *,
               truth: bool | None = None, event_id: int | None = None):
        """Stage one event's CPS result (or a full result dict holding
        a ``"cps"`` key).  O(1): two appends, no numpy."""
        with self._total_lock:
            self.total += 1
        self._pending.append(("e", self._clock(), cps_result, latency_s,
                              truth, event_id))

    def record_batch(self, cps_batch, n: int, *, latencies_s=None,
                     truths=None, event_ids=None, t: float | None = None):
        """Stage one *batch* of CPS results — dict of arrays with a
        leading batch dim, of which the first ``n`` rows are real
        events (the rest is zero-padding).  This is the serving path:
        one O(1) append per micro-batch, and the fold is vectorized
        over the batch at drain time, so monitoring cost per event is a
        fraction of a microsecond instead of a Python-loop body.

        ``latencies_s``/``truths``/``event_ids`` are per-event
        sequences of length ``n`` (``truths`` entries may be ``None``
        for events submitted without a truth bit)."""
        with self._total_lock:
            self.total += n
        self._pending.append(("b", t if t is not None else self._clock(),
                              cps_batch, n, latencies_s, truths,
                              event_ids))

    def record_raw(self, rec, pairs, t_done: float, truths):
        """Serving-internal variant of ``record_batch``: the replica
        batch loop hands over the batch's CPS dict (numpy arrays,
        padding rows included) plus (seq, t_submit) pairs for the real
        events; latency/event-id extraction is deferred to the fold.
        Staging only the CPS arrays — not the full result pytree, the
        input events, or the futures — bounds what an unread staging
        deque can pin.  ``truths`` is a per-event list (or ``None``)."""
        with self._total_lock:
            self.total += len(pairs)
        self._pending.append(("r", t_done, rec, pairs, truths))

    # ----------------------------------------------------------- readers ----
    def _drain(self):
        """Fold staged entries into the windowed rings; caller holds
        ``_agg_lock``.  ``popleft`` racing a concurrent ``record`` is
        safe — deque ops are atomic — and an eviction on the staging
        side only drops the oldest staged entry (one event, or one
        batch's samples on the batch path)."""
        while True:
            try:
                entry = self._pending.popleft()
            except IndexError:
                break
            if entry[0] == "b":
                self._fold_batch(*entry[1:])
            elif entry[0] == "r":
                self._fold_raw(*entry[1:])
            else:
                self._fold_event(*entry[1:])

    def _fold_raw(self, t_done, rec, pairs, truths):
        """Fold a staged raw batch (see ``record_raw``); the per-event
        latency/id extraction the hot path skipped happens here, on
        the reader's thread."""
        self._fold_batch(
            t_done, rec, len(pairs),
            [t_done - p[1] for p in pairs], truths,
            [p[0] for p in pairs])

    def _mark(self, t, n):
        """Advance the rate window by one fold of ``n`` events; trim
        marks so the retained span tracks ``window`` events — the same
        population the stat rings cover."""
        self._marks.append((t, self._folded))
        self._folded += n
        while len(self._marks) > 1 and \
                self._folded - self._marks[1][1] >= self.window:
            self._marks.popleft()

    def _fold_event(self, t, rec, latency_s, truth, event_id):
        if isinstance(rec, dict) and "cps" in rec:
            rec = rec["cps"]
        self._mark(t, 1)
        if latency_s is not None:
            self._lat.append(latency_s)
        if not isinstance(rec, dict):
            return                # CPS-less payload: rate/latency only
        # plain bool()/int() — the release path hands us numpy
        # scalars, and np.asarray wrappers here are pure overhead
        fired = None
        if "trigger" in rec:
            fired = bool(rec["trigger"])
            self._trig.append(fired)
        if "n_clusters" in rec:
            n = int(rec["n_clusters"])
            self._nclus.append(n)
            if n and "cluster_e" in rec:
                e = _host(rec["cluster_e"])
                v = _host(rec["cluster_valid"]) > 0
                self._energy.extend(e[v])
        if truth is not None and fired is not None:
            truth = bool(truth)
            self._tr_sig.append(truth)
            self._tr_sigf.append(fired and truth)
            self._tr_bkgf.append(fired and not truth)
        eid = event_id if event_id is not None \
            else self.total - len(self._pending) - 1
        if "cluster_xy" in rec and eid % self.display_every == 0:
            # stage the reference; the display dict is built only when
            # a reader actually asks (``displays()``), so at most
            # ``display_n`` dicts are built per read instead of one
            # per event.
            self._display.append(("e", rec, eid, truth))

    def _fold_batch(self, t, rec, n, latencies_s, truths, event_ids):
        """Vectorized fold of one staged micro-batch (first ``n`` rows
        real)."""
        if isinstance(rec, dict) and "cps" in rec:
            rec = rec["cps"]
        self._mark(t, n)
        if latencies_s is not None:
            self._lat.extend(latencies_s)
        if not isinstance(rec, dict):
            return
        fired = None
        if "trigger" in rec:
            fired = np.asarray(_host(rec["trigger"])[:n], bool)
            self._trig.extend(fired)
        if "n_clusters" in rec:
            self._nclus.extend(_host(rec["n_clusters"])[:n])
            if "cluster_e" in rec:
                e = _host(rec["cluster_e"])[:n]
                v = _host(rec["cluster_valid"])[:n] > 0
                self._energy.extend(e[v])
        if truths is not None and fired is not None:
            if None in truths:      # mixed: fold only the truth-carrying
                pairs = [(f, tr) for f, tr in zip(fired.tolist(), truths)
                         if tr is not None]
                if pairs:
                    f_arr = np.asarray([p[0] for p in pairs], bool)
                    t_arr = np.asarray([p[1] for p in pairs], bool)
                else:
                    f_arr = t_arr = None
            else:
                f_arr = fired
                t_arr = np.asarray(_host(truths), bool)
            if t_arr is not None:
                self._tr_sig.extend(t_arr)
                self._tr_sigf.extend(f_arr & t_arr)
                self._tr_bkgf.extend(f_arr & ~t_arr)
        if "cluster_xy" in rec:
            # stage references only (display dicts are built lazily by
            # displays(), bounded by its limit); an entry pins one
            # micro-batch's CPS arrays until evicted — compact, since
            # the serving path stages just the CPS subtree.
            base = self._folded - n
            ids = event_ids if event_ids is not None \
                else range(base, base + n)
            if self.display_every == 1:
                rows = range(n)
            else:
                rows = [i for i in range(n)
                        if ids[i] % self.display_every == 0]
            if rows:
                self._display.append(("b", rec, rows, truths, ids))

    def _stat_kwargs(self) -> dict:
        """Windowed running sums + the latency window; caller holds
        the lock and has drained.  Everything here is O(1) except the
        latency buffer, which is handed over as the ring's live view
        (readers only reduce it)."""
        sig = self._tr_sig.sum
        n_truth = self._tr_sig.count
        if self._marks:
            t_first, folded_before = self._marks[0]
        else:
            t_first, folded_before = None, self._folded
        return {
            "events": self.total,
            "window_events": self._folded - folded_before,
            "first_time": t_first,
            "trig_sum": self._trig.sum, "trig_n": self._trig.count,
            "nclus_sum": self._nclus.sum, "nclus_n": self._nclus.count,
            "e_sum": self._energy.sum, "e_n": self._energy.count,
            "lat": self._lat.window(),
            "sig": sig, "sig_fired": self._tr_sigf.sum,
            "bkg": n_truth - sig, "bkg_fired": self._tr_bkgf.sum,
            "t0": self.t0,
        }

    def _pooled_samples(self) -> dict:
        """Consistent copy of the windowed state (drains staging
        first) — the merge substrate.  The latency buffer is copied:
        ``merge`` reduces it after this lock is released, and another
        reader's fold could be overwriting the live ring by then."""
        with self._agg_lock:
            self._drain()
            kw = self._stat_kwargs()
            kw["lat"] = kw["lat"].copy()
            return kw

    def snapshot(self) -> MonitorSnapshot:
        """Windowed statistics.  The clock is read exactly once, so
        ``wall_s``, ``window_s`` and ``rate_ev_s`` are mutually
        consistent, and the rate is windowed (recent events / window
        span) — only ``events`` is a lifetime counter."""
        with self._agg_lock:
            self._drain()
            now = self._clock()
            return MonitorSnapshot(
                _snapshot_from(now=now, **self._stat_kwargs()))

    _ROW_KEYS = ("trigger", "cluster_valid", "cluster_xy", "cluster_e",
                 "cluster_beta")

    def displays(self, n: int | None = None) -> list[dict]:
        """Most recent event-display records, oldest first.  Display
        dicts are built here, newest-first until the limit is hit, so
        reads touch at most ``n`` (default ``display_n``) events no
        matter how much is staged."""
        limit = n if n is not None else self._display.maxlen
        if limit <= 0:
            return []
        with self._agg_lock:
            self._drain()
            staged = list(self._display)
        out: list[dict] = []
        for entry in reversed(staged):
            if entry[0] == "e":
                _, rec, eid, truth = entry
                out.append(event_display(rec, event_id=eid,
                                         grid=self.grid, truth=truth))
            else:
                _, rec, rows, truths, eids = entry
                for i in reversed(rows):
                    row = {k: rec[k][i] for k in self._ROW_KEYS
                           if k in rec}
                    out.append(event_display(
                        row, event_id=eids[i], grid=self.grid,
                        truth=truths[i] if truths is not None
                        else None))
                    if len(out) >= limit:
                        break
            if len(out) >= limit:
                break
        out.reverse()
        return out


def write_display(path: str, records: list[dict]):
    with open(path, "w") as f:
        json.dump(records, f, indent=1)
