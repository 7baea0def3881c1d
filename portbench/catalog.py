"""Finds the benchmark's parts by name: the manifest (``BENCHMARK.json``
at the root of the checkout), each configuration (``configs/<name>.json``),
each cell (``workloads/<name>.json``), each per-layer metric's reader
(``metrics/<name>.py``) and each model's two sides (``adapters/<model>.py``,
the program's; ``reference/<model>.py``, the plain reference). Adding a
configuration, a cell or a metric is adding its file."""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent

#: what a metric reader declares, as BENCHMARK.json's per_layer entries do
METRIC_KEYS = ("UNIT", "BETTER", "SOURCE", "LAYER", "MOVES", "WORKLOADS")


def manifest(repo: Path = REPO) -> dict:
    return json.loads((repo / "BENCHMARK.json").read_text())


def _json_dir(d: Path) -> dict:
    return {p.name[:-len(".json")]: json.loads(p.read_text())
            for p in sorted(d.glob("*.json"))}


def configs(here: Path = HERE) -> dict:
    return _json_dir(here / "configs")


def workloads(here: Path = HERE) -> dict:
    return _json_dir(here / "workloads")


def metrics(here: Path = HERE) -> dict:
    """{metric name: its reader module}, loaded from the files."""
    out = {}
    for p in sorted((here / "metrics").glob("*.py")):
        name = p.name[:-len(".py")]
        if name.startswith("_"):
            continue
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + name.replace(".", "_"), p)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[name] = mod
    return out


def adapter(model: str):
    return importlib.import_module(f"portbench.adapters.{model}")


def applies(entry: dict, cell: str) -> bool:
    """Whether a manifest metric is reported in ``cell``: listed there, or
    listing no cells."""
    return cell in entry.get("workloads", [cell])
