"""Whole runs on the CPU, at a small size: a cell dropped in as a file runs
end to end and proves correct; with the timed path broken underneath
``correct`` comes out false; the lower-precision controls fail the limits
at the configurations' own widths."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from portbench import catalog, controls, harness

SEED = 2 ** 31 + 77
TINY = dict(n_hits=16, n_crystals=576, d_hidden=16, d_flr=8, d_s=3, k=4,
            d_decoder=12)
CELLS = {
    "tiny_ccn.service": {"config": "tiny_ccn", "traffic": "service",
                         "kind": "service", "pool": 48, "lead_s": 0.2},
    "tiny_ccn.batch": {"config": "tiny_ccn", "traffic": "batch",
                       "kind": "batch", "pool": 2, "batch": 32},
    "tiny_ccn.rate": {"config": "tiny_ccn", "traffic": "rate",
                      "kind": "open_loop", "pool": 24, "lead_s": 0.2,
                      "rate_per_s": 40.0},
}


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def here(tmp_path_factory):
    """A copy of the benchmark's files with small configurations and cells
    added as files."""
    d = tmp_path_factory.mktemp("portbench")
    for sub in ("configs", "workloads", "metrics"):
        shutil.copytree(catalog.HERE / sub, d / sub)
    cfg = dict(catalog.configs()["ccn_upgrade_mixed"], **TINY)
    cfg["events"] = dict(cfg["events"], grid=[24, 24], n_hits=16,
                         noise_rate=4.0)
    (d / "configs" / "tiny_ccn.json").write_text(json.dumps(cfg))
    for name, cell in CELLS.items():
        (d / "workloads" / f"{name}.json").write_text(json.dumps(
            dict(cell, why="a small cell for the tests")))
    return d


def _bench():
    """The manifest with the small cells added to the lists of its metrics,
    and the service's rate and the open loop's tail, which no cell of the
    manifest reports yet."""
    b = catalog.manifest()
    reports = dict(harness.RATE, open_loop="latency_p99_us")
    e2e = b["end_to_end"] + [
        {"name": "events_per_s", "unit": "events/s", "workloads": []},
        {"name": "latency_p99_us", "unit": "us", "workloads": []}]
    e2e = [dict(m, workloads=m["workloads"] + [
        n for n, c in CELLS.items() if reports[c["kind"]] == m["name"]])
        if "workloads" in m else m for m in e2e]
    return dict(b, end_to_end=e2e, per_layer=[
        dict(m, workloads=list(CELLS)) for m in b["per_layer"]])


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_new_cell_runs_end_to_end_and_proves_correct(here, cell):
    run = harness.run_cell(cell, SEED, 1.0, False, t_start=time.perf_counter(),
                           device="cpu", here=here)
    assert run["correct"], run["compared"]
    assert run["attempted"] > 0 and run["failed"] == 0
    assert run["compared"]["unanswered"]["value"] == 0
    e2e = harness.end_to_end(_bench(), cell, run)
    assert "setup_s" in e2e and len(e2e) == 2
    assert all(v["value"] > 0 for v in e2e.values())


def test_a_run_loads_neither_jax_nor_the_jax_package(here):
    """A fresh process that runs a batch and a service cell holds no module
    of JAX or of the JAX package once the windows have closed (a test
    worker may have loaded them for other tests, so this asks a process of
    its own)."""
    code = (
        "import sys, time\n"
        "from pathlib import Path\n"
        "from portbench import harness\n"
        "for cell in ('tiny_ccn.batch', 'tiny_ccn.service'):\n"
        f"    harness.run_cell(cell, {SEED}, 0.3, False,\n"
        "                     t_start=time.perf_counter(), device='cpu',\n"
        "                     here=Path(sys.argv[1]))\n"
        "print(harness.forbidden_modules())\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(catalog.REPO), str(catalog.REPO / "src")]))
    p = subprocess.run([sys.executable, "-c", code, str(here)], env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


class _Broken:
    """The deployed pipeline with a fault underneath, made where the
    answers are produced: every answer altered; the second half of each
    call's events left out (zeros in their place); one event of each
    micro-batch chunk altered; or each call's first chunk altered."""

    def __init__(self, pipe, fault):
        self.pipe, self.fault = pipe, fault
        self.microbatch = pipe.microbatch

    def _rows(self, n: int):
        mb = self.microbatch
        return {"altered_answer": slice(None),
                "half_left_out": slice(n // 2, None),
                "one_slot_a_chunk": slice(None, None, mb),
                "one_chunk_a_call": slice(None, mb)}[self.fault]

    def _alter(self, out):
        if isinstance(out, dict):
            return {k: self._alter(v) for k, v in out.items()}
        out = torch.as_tensor(out).clone()
        rows = self._rows(out.shape[0])
        if self.fault == "half_left_out":
            out[rows] = 0
        elif out.dtype == torch.bool:
            out[rows] = ~out[rows]
        elif out.is_floating_point():
            out[rows] += 0.5
        return out

    def __call__(self, feeds):
        return self._alter(self.pipe(feeds))


FAULTS = ["altered_answer", "half_left_out", "one_slot_a_chunk",
          "one_chunk_a_call"]


# the open loop's 40 events a second reach the service one at a time, each
# in the first slot of its launch: a launch has no second half to leave out
@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in sorted(CELLS) for f in FAULTS
    if (c, f) != ("tiny_ccn.rate", "half_left_out")])
def test_a_broken_timed_path_is_not_correct(here, cell, fault):
    run = harness.run_cell(cell, SEED + 1, 0.6, False,
                           t_start=time.perf_counter(), device="cpu",
                           here=here, fault=lambda p: _Broken(p, fault))
    assert not run["correct"], run["compared"]


@pytest.mark.parametrize("cell", ["ccn_upgrade.batch4096"])
def test_the_control_fails_at_the_configurations_widths(tmp_path, cell):
    """The reference one precision below the configuration's (int4 for
    int8), in the program's place, on a small pool at the published
    widths, reads above every seed's limit."""
    for sub in ("configs", "workloads"):
        shutil.copytree(catalog.HERE / sub, tmp_path / sub)
    w = catalog.workloads()[cell]
    w = dict(w, pool=1, batch=24) if "batch" in w else dict(w, pool=24)
    (tmp_path / "workloads" / f"{cell}.json").write_text(json.dumps(w))
    cfg = catalog.configs()[w["config"]]
    limits = cfg["correct"]["limits"]
    for seed in (SEED, SEED + 1, SEED + 2):
        got = controls.control_numbers(cell, seed, "cpu", here=tmp_path)
        assert any(got[k] > v for k, v in limits.items()), got


def test_the_reference_agrees_with_itself_bitwise():
    """The check's reference repeats from the seed (same inputs, same
    answers), so a run's verdict depends on the program alone."""
    cfg = catalog.configs()["ccn_upgrade_mixed"]
    a = catalog.adapter("caloclusternet").Model(cfg, SEED, "cpu")
    b = catalog.adapter("caloclusternet").Model(cfg, SEED, "cpu")
    pa, pb = a.pool(8, SEED), b.pool(8, SEED)
    ra, rb = a.reference(pa), b.reference(pb)
    for x, y in zip(harness._leaves(ra), harness._leaves(rb)):
        assert np.array_equal(x, y)
    n = a.numbers(ra, rb, np.ones(8))
    assert n["wrong_share"] == 0.0 and n["widest_gap_steps"] == 0.0


def _alter_first(tree):
    """The first event's answer altered where it is produced: floats
    +0.5, booleans flipped."""
    if isinstance(tree, dict):
        return {k: _alter_first(v) for k, v in tree.items()}
    out = np.array(tree)
    if out.dtype == bool:
        out[0] = ~out[0]
    elif np.issubdtype(out.dtype, np.floating):
        out[0] += 0.5
    return out


def test_the_limit_fails_one_event_in_128():
    """At the configuration's widths, one answer in 128 altered (as one
    micro-batch chunk of 32 events of a 4096-event call would, or one slot
    of each chunk four times over) reads above the limit, and the
    reference's own answers read under it."""
    cfg = catalog.configs()["ccn_upgrade_mixed"]
    a = catalog.adapter("caloclusternet").Model(cfg, SEED, "cpu")
    want = a.reference(a.pool(128, SEED))
    limit = cfg["correct"]["limits"]["wrong_share"]
    assert a.numbers(want, want, np.ones(128))["wrong_share"] <= limit
    got = a.numbers(_alter_first(want), want, np.ones(128))
    assert got["wrong_share"] == pytest.approx(1 / 128)
    assert got["wrong_share"] > limit
