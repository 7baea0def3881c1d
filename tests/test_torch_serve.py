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


def _run_cli(*flags):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device",
         "cpu", "--detector", "current", "--events", "16", *flags],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return r.stdout


def _serve_cli(*flags):
    out = _run_cli(*flags)
    assert "answered=16 in-order=True" in out
    return out


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


@pytest.mark.parametrize("models", [("gatedgcn", "graphsage"),
                                    ("ccn", "gatedgcn"),
                                    ("ccn", "gatedgcn", "graphsage")])
def test_cli_serves_every_route(models):
    """``--model`` serves each named route; the 16 events are split over
    the routes as the reference splits them, and each route answers all
    of its own; only the ccn route reports trigger rates."""
    out = _run_cli("--model", *models)
    for i, name in enumerate(models):
        n = 16 // len(models) + (i < 16 % len(models))
        policy = "mixed" if name == "ccn" else "fp"
        assert f"deployed {name}: design point 3, {policy}" in out
        assert f"route {name}: {n} events" in out
        assert any(ln.startswith(f"[serve] route {name}: ")
                   and f"answered={n} in-order=True" in ln
                   for ln in out.splitlines()), name
    assert ("trigger efficiency" in out) == ("ccn" in models)
    assert "16 events in" in out and "one dispatch per route in turn" in out


def test_routes_interleave_one_dispatch_each_in_turn():
    """serve_routes sends one dispatch of each route in turn and counts a
    route's events by the leading axis of its feeds, whatever their
    names."""
    calls = []

    class Echo:
        microbatch = 1

        def __init__(self, name):
            self.name = name

        def __call__(self, feeds):
            calls.append(self.name)
            return {"y": np.asarray(feeds["x"]) * 2}

    routes = {"a": (Echo("a"), {"x": np.arange(40.0)}),
              "b": (Echo("b"), {"x": np.arange(20.0)})}
    res, elapsed = serve.serve_routes(routes)
    assert calls == ["a", "b", "a", "b", "a"]   # 16 + 16 + 8, 16 + 4
    for name, n in (("a", 40), ("b", 20)):
        out, lat, busy = res[name]
        assert_bitwise(out["y"], 2 * np.arange(float(n)))
        assert lat.shape == (n,) and (lat > 0).all() and busy > 0
    assert elapsed >= res["a"][2] + res["b"][2]


def test_cli_refuses_a_route_without_events():
    with pytest.raises(SystemExit):
        serve.parse_args(["--events", "1", "--model", "ccn", "graphsage"])
    assert serve.parse_args([]).model == ["ccn"]


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
