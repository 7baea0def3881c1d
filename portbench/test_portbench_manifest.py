"""The manifest and the files it names: every cell, configuration and
per-layer metric resolved by name, the contract's naming rules, a cell
added as a file, and the imports the benchmark may not make."""
from __future__ import annotations

import ast
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import catalog, harness

HERE = catalog.HERE
REPO = catalog.REPO
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return catalog.manifest()


def test_manifest_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in bench["workloads"]:
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    assert len(json.dumps(bench)) < 64 * 1024


def test_check_fits_the_day(bench):
    """2 + 14 x 24 runs of run_seconds + 60, 2 x 90 s a cell to compile
    and 1200 s spare fit into 43200 s."""
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads"])
def test_every_entry_has_its_file(bench, kind):
    files = getattr(catalog, kind)()
    assert {x["name"] for x in bench[kind]} == set(files)
    for entry in bench[kind]:
        f = files[entry["name"]]
        if kind == "configs":
            assert entry["file"] == f"portbench/configs/{entry['name']}.json"
            assert (REPO / entry["file"]).is_file()
            assert entry["source"] == f["source"]
            assert entry["reduced"] == []
        else:
            for key in ("config", "traffic", "why"):
                assert entry[key] == f[key], key
            assert f["kind"] in ("service", "open_loop", "batch")


def test_every_per_layer_metric_has_its_reader(bench):
    readers = catalog.metrics()
    assert {m["name"] for m in bench["per_layer"]} == set(readers)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        r = readers[m["name"]]
        got = {k.lower(): getattr(r, k) for k in catalog.METRIC_KEYS}
        assert got == {"unit": m["unit"], "better": m["better"],
                       "source": m["source"], "layer": m["layer"],
                       "moves": m["moves"], "workloads": m["workloads"]}
        # each cell a metric lists reports the end-to-end metric it moves
        for cell in m["workloads"]:
            assert catalog.applies(e2e[m["moves"]], cell), (m["name"], cell)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer(bench):
    for w in bench["workloads"]:
        e2e = [m["name"] for m in bench["end_to_end"]
               if catalog.applies(m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert any(catalog.applies(m, w["name"]) for m in bench["per_layer"])
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert m["bound"] <= 0.25


def test_a_cell_file_dropped_in_is_found(tmp_path):
    """A new cell needs its file and no edit to any other file."""
    for d in ("configs", "workloads", "metrics"):
        shutil.copytree(HERE / d, tmp_path / d)
    new = dict(catalog.workloads()["ccn_upgrade.batch4096"], batch=123,
               traffic="batch123")
    (tmp_path / "workloads" / "ccn_upgrade.batch123.json").write_text(
        json.dumps(new))
    found = catalog.workloads(tmp_path)
    assert found["ccn_upgrade.batch123"]["batch"] == 123
    assert set(found) == set(catalog.workloads()) | {"ccn_upgrade.batch123"}
    assert set(catalog.metrics(tmp_path)) == set(catalog.metrics())


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_file_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        bad = _imports(path) & set(harness.FORBIDDEN)
        assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").glob("*.py"):
        assert _imports(path) <= {"__future__", "numpy", "torch"}, path


def test_forbidden_names_compare_whole():
    assert harness.forbidden_modules(["repro_torch", "repro_torch.core",
                                      "jaxtyping", "reprolib"]) == []
    assert harness.forbidden_modules(["repro.core", "jax.numpy", "flax"]) == [
        "flax", "jax", "repro"]


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    """Without the program the command exits non-zero and prints no
    result."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "ccn_upgrade.batch4096", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_no_card_no_result(capsys, monkeypatch):
    """On a host without CUDA the command exits non-zero, no result."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "ccn_upgrade.batch4096", "--seed",
                       str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""

