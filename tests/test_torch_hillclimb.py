"""The port's hill-climb (``repro_torch/launch/hillclimb.py``) on the
CPU: ``--exp trigger`` in its own process (the fake world of 256 is
global to a process) into a temporary report directory, against the
committed baseline of ``reports/torch_dryrun/``. Each of C1 and C2
writes the reference's report keys, a hypothesis stated on the H100
model of ``launch/mesh.py`` (no TPU figure), and a roofline that
``analysis.roofline`` gives again from its per-device terms.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.launch import analysis, hillclimb

ROOT = Path(__file__).resolve().parents[1]
TAGS = ("C1_ccn_serve_bf16", "C2_ccn_serve_bf16_onehot")
KEYS = {"memory", "per_device", "collectives", "t_lower_s", "roofline",
        "hypothesis"}


@pytest.fixture(scope="module")
def trigger_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("hillclimb")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.hillclimb", "--exp",
         "trigger", "--report-dir", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return out, res.stdout


def test_baselines_are_committed():
    """The three cells' baselines the hill-climb reads."""
    for name in ("yi-9b__decode_32k", "granite-34b__train_4k",
                 "caloclusternet__trigger_serve"):
        path = Path(hillclimb.BASELINE_DIR) / f"{name}__pod16x16.json"
        rec = json.loads(path.read_text())
        assert {"roofline", "memory", "per_device"} <= set(rec), name


@pytest.mark.parametrize("tag", TAGS)
def test_trigger_reports(trigger_run, tag):
    out, stdout = trigger_run
    rec = json.loads((out / f"{tag}.json").read_text())
    assert set(rec) == KEYS
    assert set(rec["per_device"]) == {"flops", "bytes", "collective_bytes"}
    assert set(rec["collectives"]) >= {"all-gather", "all-reduce",
                                       "reduce-scatter"}
    hyp = rec["hypothesis"]
    assert "H100_HBM_BW" in hyp and "predict" in hyp
    for tpu in ("ICI", "819", "MXU", "GBps"):
        assert tpu not in hyp, tpu
    rf = rec["roofline"]
    assert rf == analysis.roofline(rec["per_device"], n_chips=256,
                                   model_flops=rf["model_flops"])
    assert f"[{tag}]" in stdout


def test_onehot_cell_moves_more_bytes(trigger_run):
    """C2's one-hot cell reads and writes the (n, n) distances once a
    round, C1's top-k once: more bytes on the same model FLOPs."""
    out, _ = trigger_run
    c1, c2 = (json.loads((out / f"{t}.json").read_text()) for t in TAGS)
    assert c2["per_device"]["bytes"] > c1["per_device"]["bytes"]
    assert (c2["roofline"]["model_flops"]
            == c1["roofline"]["model_flops"])
