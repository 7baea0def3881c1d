"""The port's trigger monitor (``repro_torch/serving/monitor.py``) against
the reference's (``repro/serving/monitor.py``), run live on the same
inputs and one injected clock: the detector grids, the event-display
records (clusters outside [-0.5, 0.5] clipped onto both grids), every
recording path (``record``, ``record_batch``, ``record_raw``, with truth
bits and without, thinned by ``display_every``, the windows wrapped past
``window``), ``snapshot()``, ``MonitorSnapshot.merge`` over three
monitors, ``displays()`` and the bytes ``write_display`` writes. The
port's monitor is also fed the same records as torch tensors. Every
statistic derives from the same numpy operations in the same order, so
the snapshots are compared for equality.
"""
import numpy as np
import pytest
import torch

import repro.serving.monitor as ref_monitor
import repro_torch.serving.monitor as port_monitor
from repro.data.belle2 import Belle2Config as JBelle2Config
from repro.data.belle2 import current_detector as j_current
from repro_torch.data.belle2 import Belle2Config as TBelle2Config
from repro_torch.data.belle2 import current_detector as t_current

K = 8                 # CaloClusterNet's k_max
MB = 6                # rows of a recorded batch, padding included


class Clock:
    """A deterministic clock: each reading 1.25 ms after the last."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 1.25e-3
        return self.t


def _cps(rng, rows=None):
    """One event's CPS outputs (``rows`` events' when given), with
    cluster coordinates spread past the detector's [-0.5, 0.5]."""
    shape = () if rows is None else (rows,)
    n = rng.integers(0, K + 1, size=shape)
    valid = (np.arange(K) < np.asarray(n)[..., None]).astype(np.float32)
    return {"trigger": np.asarray(n >= 3),
            "n_clusters": np.asarray(n, np.int32),
            "cluster_valid": valid,
            "cluster_xy": rng.normal(scale=0.6, size=(*shape, K, 2))
            .astype(np.float32),
            "cluster_e": rng.uniform(0.0, 2.0, size=(*shape, K))
            .astype(np.float32),
            "cluster_beta": rng.uniform(size=(*shape, K)).astype(np.float32)}


def _as(tree, as_tensor):
    if not as_tensor:
        return tree
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _scenario(mon_mod, name, as_tensor=False, seed=0, clock=None):
    """A monitor of ``mon_mod`` fed one scenario's records; its
    ``snapshot()``, ``displays()`` and ``displays(5)``."""
    rng = np.random.default_rng(seed)
    kw = dict(window=4096, display_n=16, display_every=1)
    if name == "wrapped":
        kw.update(window=24, display_n=8)
    if name == "thinned":
        kw.update(display_every=3)
    mon = mon_mod.TriggerMonitor(clock=clock or Clock(), grid=(24, 24),
                                 **kw)
    n_batches = 12 if name == "wrapped" else 4
    seq = 0
    for b in range(n_batches):
        n = int(rng.integers(1, MB + 1))
        truths = [bool(t) for t in rng.integers(0, 2, size=n)]
        if name == "mixed_truths":
            truths[::2] = [None] * len(truths[::2])
        if name == "no_truths":
            truths = None
        rec = _as(_cps(rng, rows=MB), as_tensor)
        lat = rng.uniform(1e-4, 1e-2, size=n)
        mode = ("raw", "batch", "event")[b % 3]
        if mode == "raw":
            pairs = [(seq + i, 99.0 - lat[i]) for i in range(n)]
            mon.record_raw(rec, pairs, 99.0, truths)
        elif mode == "batch":
            mon.record_batch(rec, n, latencies_s=lat, truths=truths,
                             event_ids=list(range(seq, seq + n)))
        else:
            for i in range(n):
                one = _as(_cps(rng), as_tensor)
                mon.record(one if i % 2 else {"cps": one},
                           latency_s=float(lat[i]),
                           truth=None if truths is None else truths[i],
                           event_id=seq + i if i != 1 else None)
        seq += n
    return mon.snapshot(), mon.displays(), mon.displays(5), mon


SCENARIOS = ["truths", "mixed_truths", "no_truths", "thinned", "wrapped"]


@pytest.mark.parametrize("as_tensor", [False, True],
                         ids=["numpy", "tensors"])
@pytest.mark.parametrize("name", SCENARIOS)
def test_snapshot_and_displays_equal_reference(name, as_tensor):
    want = _scenario(ref_monitor, name)
    got = _scenario(port_monitor, name, as_tensor)
    assert isinstance(got[0], port_monitor.MonitorSnapshot)
    assert dict(got[0]) == dict(want[0])
    assert got[1] == want[1] and got[2] == want[2]
    assert got[0]["events"] == want[3].total
    if name == "wrapped":
        assert got[0]["window_events"] < got[0]["events"]
        assert len(got[1]) == 8


@pytest.mark.parametrize("name", ["truths", "wrapped"])
def test_merge_over_three_monitors_equals_reference(name):
    def merged(mod):
        clock = Clock()
        mons = [_scenario(mod, name, seed=s, clock=clock)[3]
                for s in (1, 2, 3)]
        return mod.MonitorSnapshot.merge(mons)
    want, got = merged(ref_monitor), merged(port_monitor)
    assert dict(got) == dict(want)
    assert dict(port_monitor.MonitorSnapshot.merge([])) == dict(
        ref_monitor.MonitorSnapshot.merge([]))


@pytest.mark.parametrize("det", ["none", "upgrade", "current", "crystals576",
                                 "crystals8736", "bad"])
def test_detector_grid_equals_reference(det):
    class Crystals:
        def __init__(self, n):
            self.n_crystals = n

    def make(belle2_cls, current):
        return {"none": None, "upgrade": belle2_cls(), "current": current(),
                "crystals576": Crystals(576),
                "crystals8736": Crystals(8736), "bad": object()}[det]
    if det == "bad":
        for mod in (ref_monitor, port_monitor):
            with pytest.raises(ValueError, match="cannot infer"):
                mod.detector_grid(make(TBelle2Config, t_current))
        return
    assert port_monitor.detector_grid(make(TBelle2Config, t_current)) == \
        ref_monitor.detector_grid(make(JBelle2Config, j_current))


@pytest.mark.parametrize("truth", [None, True, False])
@pytest.mark.parametrize("grid", [(24, 24), (56, 156)])
def test_event_display_equals_reference(grid, truth):
    """One record per event of a batch, its clusters partly outside the
    detector, on both grids; the port also on tensors."""
    rng = np.random.default_rng(sum(grid))
    batch = _cps(rng, rows=5)
    assert np.abs(batch["cluster_xy"]).max() > 0.5
    for i in range(5):
        row = {k: v[i] for k, v in batch.items()}
        want = ref_monitor.event_display(row, event_id=i, grid=grid,
                                         truth=truth)
        assert port_monitor.event_display(row, event_id=i, grid=grid,
                                          truth=truth) == want
        assert port_monitor.event_display(_as(row, True), event_id=i,
                                          grid=grid, truth=truth) == want
        for c in want["clusters"]:
            assert 0.0 <= c["theta"] <= grid[0]
            assert 0.0 <= c["phi"] <= grid[1]


@pytest.mark.parametrize("name", ["truths", "thinned"])
def test_write_display_bytes_equal_reference(name, tmp_path):
    _, want, _, _ = _scenario(ref_monitor, name)
    _, got, _, _ = _scenario(port_monitor, name, as_tensor=True)
    ref_monitor.write_display(str(tmp_path / "ref.json"), want)
    port_monitor.write_display(str(tmp_path / "port.json"), got)
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "ref.json").read_bytes()
