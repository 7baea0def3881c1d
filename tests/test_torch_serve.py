"""The port's serving entry point on the CPU: the command line answers every
event, and the in-order loop returns each event's result in submission
order (equal to one direct call of the pipeline over all events)."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from _numerics import assert_bitwise

from repro_torch.data.belle2 import current_detector, generate
from repro_torch.launch import serve

REPO = Path(__file__).resolve().parent.parent


def _serve_cli(*flags):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device",
         "cpu", "--detector", "current", "--events", "16", *flags],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "answered=16 in-order=True" in r.stdout
    return r.stdout


def test_cli_answers_every_event():
    out = _serve_cli()
    assert "ev/s" in out and "p99=" in out
    # the reference's default: mixed precision, fused quantized blocks
    assert "design point 3, mixed" in out and "blocks=2" in out


@pytest.mark.parametrize("flags,want", [
    (("--design-point", "1"), "design point 1, mixed"),
    (("--no-fuse-int8",), "blocks=0"),
    (("--no-fuse-gravnet-block",), "blocks=0"),
    (("--precision", "fp", "--no-fuse-int8"), "blocks=2")])
def test_cli_design_points_and_escape_hatches(flags, want):
    assert want in _serve_cli(*flags)


def test_serve_loop_returns_results_in_submission_order():
    cfg, gen_cfg = serve.detector_configs("current")
    pipe = serve.build_pipeline(cfg, gen_cfg, device="cpu")
    ev = generate(current_detector(), 20, seed=4)
    feeds = {"hits": ev["feats"], "mask": ev["mask"]}
    res, lat, elapsed = serve.serve_events(pipe, feeds)   # 16 + 4 events
    assert max(pipe.microbatch, serve.MIN_SERVE_BATCH) == 16
    assert lat.shape == (20,) and (lat > 0).all() and elapsed > 0
    direct = pipe(feeds)
    for k in ("n_clusters", "trigger", "cluster_valid"):
        assert_bitwise(res["cps"][k], direct["cps"][k].numpy(), context=k)
    assert_bitwise(res["beta"], direct["beta"].numpy())
    assert res["beta"].shape == (20, cfg.n_hits, 1)


def test_trigger_rates():
    eff, fake = serve.trigger_rates(np.array([1, 0, 1, 1], bool),
                                    np.array([1.0, 1.0, 0.0, 0.0]))
    assert (eff, fake) == (0.5, 1.0)
