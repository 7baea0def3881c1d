"""The port's serving entry point on the CPU: the command line serves every
event through ``ShardedTriggerService`` (the reference's flags: replicas,
loops, policies, injected faults), releases them in submission order and
answers each as the plain in-order loop does; the plain loop
(``serve_routes``/``serve_events``) returns each event's result in
submission order (equal to one direct call of the pipeline over all
events)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from _numerics import assert_bitwise
from test_torch_lm import _two_threads  # noqa: F401 (autouse)

from repro_torch.data.belle2 import current_detector, generate
from repro_torch.launch import serve

REPO = Path(__file__).resolve().parent.parent


def _run_cli(*flags):
    # two intra-op threads in the subprocess too (unless the caller set
    # its own): the suite runs six workers on the host's cores
    env = {"OMP_NUM_THREADS": "2", **os.environ,
           "PYTHONPATH": str(REPO / "src")}
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
    """Each flag selects its deployment. The flags are about what is
    deployed, not about training: ``--train-steps 0`` serves the random
    weights (warm training is held by ``test_cli_answers_every_event``
    and ``test_default_run_warm_trains_then_serves_the_trained_weights``)."""
    assert want in _serve_cli("--train-steps", "0", *flags)


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
    assert "16 events in" in out
    assert "1 replica(s) per route, round_robin, streaming loop" in out
    assert "lanes captured during traffic: 0" in out


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


def _spy_main(monkeypatch, argv):
    """Run ``serve.run`` in-process, recording the Requirements every
    deployment gets, the servables' event draws, the weights the ccn
    route deploys and the service's micro-batch; returns that record,
    the run's report under ``"report"``."""
    rec = {"reqs": [], "draws": [], "params": [], "width": []}
    real_deploy, real_build = serve.deploy, serve.build_service
    real_ccn = serve._ccn_servable

    def deploy(graph, req, **kw):
        rec["reqs"].append(req)
        return real_deploy(graph, req, **kw)

    def build(args, servables, **kw):
        svc = real_build(args, servables, **kw)
        rec["width"].append(svc.microbatch)
        return svc

    def ccn(args, cfg=None, tuning_cache=None, params=None):
        rec["params"].append(params)
        return real_ccn(args, cfg, tuning_cache, params)

    def recording(make):
        def servable(*a, **kw):
            sv = make(*a, **kw)

            def events(n, seed, sv=sv):
                rec["draws"].append((sv.name, n, seed))
                return sv.events(n, seed)
            rec.setdefault("pipes", {})[sv.name] = sv.pipe
            return serve.Servable(sv.name, sv.pipe, events)
        return servable

    monkeypatch.setattr(serve, "deploy", deploy)
    monkeypatch.setattr(serve, "build_service", build)
    monkeypatch.setattr(serve, "_ccn_servable", recording(ccn))
    monkeypatch.setitem(serve.MODELS, "ccn", recording(ccn))
    for name in ("gatedgcn", "graphsage"):
        monkeypatch.setitem(serve.MODELS, name,
                            recording(serve.MODELS[name]))
    rec["report"] = serve.run(["--device", "cpu", "--detector", "current",
                               *argv])
    return rec


@pytest.mark.parametrize("models", [("ccn", "gatedgcn"),
                                    ("gatedgcn", "graphsage")])
def test_routes_share_the_reference_dispatch_width(monkeypatch, capsys,
                                                   models):
    """Several routes: one service micro-batch for all,
    ``max(8, *microbatches)`` as the reference's service takes it, and
    each route warmed with that many events of seed 99 before its served
    events (seed 7 + i); no warm-training on this path."""
    rec = _spy_main(monkeypatch, ["--events", "12", "--model", *models])
    width = max(8, *(rec["pipes"][m].microbatch for m in models))
    assert rec["width"] == [width]
    for i, m in enumerate(models):
        assert rec["draws"].index((m, width, 99)) < rec["draws"].index(
            (m, 6, 7 + i))
    assert rec["params"] in ([], [None])
    out = capsys.readouterr().out
    assert "warm-trained" not in out
    assert f"microbatch={width}" in out
    for m in models:
        assert f"route {m}: 6 events, answered=6 in-order=True" in out
        assert f"route {m}: 6 submitted, 6 completed" in out


def test_deploy_flags_reach_requirements(monkeypatch):
    """``--target-throughput`` and ``--tpu-native-gravnet`` reach every
    deployment's Requirements; their defaults are the reference's."""
    rec = _spy_main(monkeypatch, ["--events", "4", "--train-steps", "0",
                                  "--target-throughput", "2.5e4",
                                  "--tpu-native-gravnet", "--model", "ccn",
                                  "graphsage"])
    assert len(rec["reqs"]) == 2
    for req in rec["reqs"]:
        assert req.target_throughput == 2.5e4 and req.tpu_native_gravnet
    args = serve.parse_args([])
    assert args.target_throughput == 1e5 and not args.tpu_native_gravnet
    assert args.train_steps == 40


def test_train_steps_0_serves_the_untrained_deployment(monkeypatch, capsys):
    """``--train-steps 0`` is the run without training: the seed-0
    weights, no training line, and the served decisions of
    ``build_pipeline``'s deployment on the events of seed 7."""
    rec = _spy_main(monkeypatch, ["--events", "20", "--train-steps", "0"])
    # the service at ccn's own width, max(microbatch, 16)
    assert rec["params"] == [None] and rec["width"] == [16]
    assert ("ccn", 16, 99) in rec["draws"]
    assert "warm-trained" not in capsys.readouterr().out
    got = serve.stack_results(rec["report"].served.results[None])
    cfg, gen_cfg = serve.detector_configs("current")
    pipe = serve.build_pipeline(cfg, gen_cfg, device="cpu")
    ev = generate(gen_cfg, 20, seed=7)
    want, _, _ = serve.serve_events(pipe, {"hits": ev["feats"],
                                           "mask": ev["mask"]})
    for k in ("n_clusters", "trigger", "cluster_valid"):
        assert_bitwise(got["cps"][k], want["cps"][k], context=k)
    assert_bitwise(got["beta"], want["beta"])


def test_default_run_warm_trains_then_serves_the_trained_weights(
        monkeypatch, capsys):
    """ccn alone trains first (here 3 steps) and deploys exactly the
    weights ``warm_train`` gives, and prints the reference's line."""
    rec = _spy_main(monkeypatch, ["--events", "4", "--train-steps", "3"])
    cfg, gen_cfg = serve.detector_configs("current")
    want, losses = serve.warm_train(cfg, gen_cfg, 3, device="cpu")
    (got,) = rec["params"]
    for n in want:
        for k in want[n]:
            assert_bitwise(got[n][k].numpy(), want[n][k].numpy(),
                           context=f"{n}/{k}")
    out = capsys.readouterr().out
    assert len(losses) == 3
    assert f"warm-trained 3 steps, loss {float(losses[-1]):.3f}" in out
    assert "answered=4 in-order=True" in out


# ----------------------------------------------------- the service flags ----
def _direct(n, seed=7):
    """The plain in-order loop's answers for the events of ``seed``
    through ``build_pipeline``'s random-weight deployment."""
    cfg, gen_cfg = serve.detector_configs("current")
    pipe = serve.build_pipeline(cfg, gen_cfg, device="cpu")
    ev = generate(gen_cfg, n, seed=seed)
    return serve.serve_events(pipe, {"hits": ev["feats"],
                                     "mask": ev["mask"]})[0]


def _same_as_plain_loop(report, n):
    got = serve.stack_results(report.served.results[None])
    want = _direct(n)
    for k in ("n_clusters", "trigger", "cluster_valid"):
        assert_bitwise(got["cps"][k], want["cps"][k], context=k)
    for h in ("beta", "coords", "energy", "cls"):
        assert_bitwise(got[h], want[h], context=h)


@pytest.mark.parametrize("flags,line", [
    (("--replicas", "2", "--policy", "least_loaded"),
     "2 replica(s) per route, least_loaded, streaming loop"),
    (("--loop", "deadline"),
     "1 replica(s) per route, round_robin, deadline loop")])
def test_cli_service_flags(flags, line, capsys):
    """``--replicas``/``--policy`` and ``--loop`` reach the service: the
    run names them, every replica that took traffic reports it, the
    release order is the submission order, no lane captured under
    traffic, and each event's answer equals the plain loop's bitwise."""
    report = serve.run(["--device", "cpu", "--detector", "current",
                        "--events", "24", "--train-steps", "0", *flags])
    out = capsys.readouterr().out
    assert line in out and "answered=24 in-order=True" in out
    assert report.served.order == list(range(24))
    assert report.summary["completed"] == 24
    assert len(report.summary["per_replica"]) == report.args.replicas
    assert all(c["captures"] == c["captured_at_start"]
               for c in report.captures)
    _same_as_plain_loop(report, 24)


def test_cli_dead_lane_fails_over_without_client_failures(capsys):
    """The reference's chaos recipe: replica 1 fails every batch; its
    events fail over to replica 0 (at most 2 retries each), so every
    event is answered once, in order, with 0 client-visible failures,
    as the plain loop answers it."""
    report = serve.run(["--device", "cpu", "--detector", "current",
                        "--events", "32", "--train-steps", "0",
                        "--replicas", "2", "--inject-faults",
                        "fail:p=1.0,replica=1", "--max-retries", "2"])
    out = capsys.readouterr().out
    assert "chaos plan: fail:p=1,replica=1;seed=0" in out
    assert "[serve] chaos: 0 client-visible failure(s)" in out
    assert report.served.failed == 0
    assert report.served.order == list(range(32))
    ft = report.fault_tolerance
    assert ft["failed_over"] > 0 and ft["retried"] >= ft["failed_over"]
    assert report.summary["per_replica"][1]["completed"] == 0
    _same_as_plain_loop(report, 32)


def test_cli_flags_match_the_reference_table():
    """The service flags and their defaults are the reference's."""
    args = serve.parse_args([])
    assert (args.replicas, args.loop, args.policy, args.inject_faults,
            args.fault_seed, args.breaker, args.max_retries, args.shed) == (
        1, "streaming", "round_robin", None, 0, False, 0, False)
    with pytest.raises(SystemExit):
        serve.parse_args(["--loop", "bogus"])
    with pytest.raises(SystemExit):
        serve.parse_args(["--replicas", "0"])


def test_submit_all_interleaves_routes_and_records_release_order():
    """``submit_all`` submits one event of each route in turn (a route
    that runs out drops out) and records the order the futures resolve
    in: the submission order, through the service's in-order release."""
    from repro_torch.serving import ShardedTriggerService
    seen = []

    def echo(name):
        def infer(feeds):
            seen.append((name, [float(x) for x in feeds["x"]]))
            return {"y": feeds["x"] * 2}
        return infer

    svc = ShardedTriggerService(routes={"a": echo("a"), "b": echo("b")},
                                microbatch=1, devices=None)
    try:
        served = serve.submit_all(svc, {"a": {"x": np.arange(3.0)},
                                        "b": {"x": np.arange(10.0, 12.0)}})
    finally:
        svc.close()
    assert served.order == list(range(5)) and served.failed == 0
    assert [float(r["y"]) for r in served.results["a"]] == [0.0, 2.0, 4.0]
    assert [float(r["y"]) for r in served.results["b"]] == [20.0, 22.0]
    assert [s[1][0] for s in seen if s[0] == "a"] == [0.0, 1.0, 2.0]


# ------------------------------------- the monitor, buckets, bench-out ----
def _run(*flags):
    return serve.run(["--device", "cpu", "--detector", "current",
                      "--train-steps", "0", *flags])


def test_default_run_has_no_monitor(monkeypatch):
    """Without the monitor flags the service is built without a monitor
    and no truth bit is submitted: the default run's path."""
    made = []
    real = serve.ShardedTriggerService

    def spy(*a, **kw):
        made.append(kw.get("monitor"))
        return real(*a, **kw)
    monkeypatch.setattr(serve, "ShardedTriggerService", spy)
    report = _run("--events", "8")
    assert made == [False]
    assert (report.monitor, report.live_snapshot, report.displays,
            report.buckets) == (None, None, None, [])


def test_cli_monitor_port_and_event_display(tmp_path, capsys):
    """``--monitor-port 0 --event-display``: the live ``/snapshot`` counts
    the completed events, the monitor's trigger rate is the served
    decisions', and the display file holds the first
    ``--event-display-n`` events' records on the current detector's
    grid, each with its truth bit."""
    path = tmp_path / "display.json"
    report = _run("--events", "20", "--monitor-port", "0",
                  "--event-display", str(path), "--event-display-n", "5")
    out = capsys.readouterr().out
    assert "monitor live at http://127.0.0.1:" in out
    assert "/snapshot events=20 vs stats completed=20 -> MATCH" in out
    assert f"event display (5 events) -> {path}" in out
    live, snap = report.live_snapshot, report.monitor
    assert live["events"] == snap["events"] == 20
    assert live["truth_events"] == 20
    trig = [bool(r["cps"]["trigger"]) for r in report.served.results[None]]
    assert snap["trigger_rate"] == sum(trig) / len(trig)
    recs = json.loads(path.read_text())
    assert recs == report.displays and [r["event"] for r in recs] == \
        list(range(5))
    truth = report.truth["ccn"]
    for r in recs:
        assert r["grid"] == [24, 24] and r["truth"] == bool(truth[r["event"]])
    _same_as_plain_loop(report, 20)


@pytest.mark.parametrize("loop", ["streaming", "deadline"])
def test_cli_buckets(loop, capsys):
    """``--buckets 8 16 32``: one executable per bucket, each warmed once
    before traffic, each event on the smallest bucket that fits its hits,
    answered as the bucketed deployment's eager call answers it."""
    report = _run("--events", "16", "--buckets", "8", "16", "32",
                  "--loop", loop)
    out = capsys.readouterr().out
    assert "buckets=(8, 16, 32) microbatch=8" in out
    assert "bucket executables warmed at startup: 3" in out
    assert "answered=16 in-order=True" in out
    (sv,) = report.servables
    bpipe = sv.pipe
    feeds = report.feeds["ccn"]
    occ = np.count_nonzero(feeds["mask"] > 0, axis=1)
    want_rows = {b: int(sum(bpipe.classify(int(o)) == b for o in occ))
                 for b in bpipe.buckets}
    assert {r["bucket"]: r["submitted"] for r in report.buckets} == want_rows
    assert all(r["completed"] == r["submitted"] for r in report.buckets)
    for b, n in want_rows.items():
        if n:
            assert f"bucket n_hits<={b}: {n} events" in out
    want = bpipe.run_eager(feeds)
    for i, r in enumerate(report.served.results[None]):
        b = bpipe.classify(int(occ[i]))
        assert_bitwise(r["beta"], want["beta"][i, :b], context=str(i))
        for k in ("n_clusters", "trigger", "cluster_valid"):
            assert_bitwise(r["cps"][k], want["cps"][k][i], context=k)


def test_cli_bench_out(tmp_path, capsys):
    path = tmp_path / "bench.json"
    _run("--events", "12", "--model", "gatedgcn", "graphsage",
         "--bench-out", str(path))
    assert f"multi-model stats -> {path}" in capsys.readouterr().out
    bench = json.loads(path.read_text())
    assert bench["events"] == 12 and bench["released_nonzero"]
    assert bench["throughput_ev_s"] > 0 and bench["loop"] == "streaming"
    assert sorted(bench["routes"]) == ["gatedgcn", "graphsage"]
    for row in bench["routes"].values():
        assert row["submitted"] == row["completed"] == 6


def test_cli_bucketed_tune_then_cache(tmp_path, capsys):
    """The bucketed ``--tune`` searches every bucket's graph at the launch
    width and saves the cache; a run on that cache alone binds every
    bucket's problems without searching."""
    cache = tmp_path / "tc.json"
    flags = ("--events", "8", "--buckets", "8", "16", "32",
             "--tuning-cache", str(cache))
    _run(*flags, "--tune")
    out = capsys.readouterr().out
    assert "autotuned" in out and cache.exists()
    report = _run(*flags)
    out = capsys.readouterr().out
    assert "autotuned" not in out
    (sv,) = report.servables
    hits, n_keys = serve.cache_hits(sv.pipe, serve.TuningCache.load(
        str(cache)))
    assert hits == n_keys > 0
    assert f"route ccn: {n_keys} of {n_keys} kernel problems bound" in out
    problems = serve.tuning_problems(sv.pipe)
    assert [(nr, bt) for _, nr, bt, _ in problems] == [(8, 8), (16, 8),
                                                       (32, 8)]


@pytest.mark.parametrize("flags", [
    ("--model", "gatedgcn", "--buckets", "8"),
    ("--model", "ccn", "graphsage", "--monitor-port", "0"),
    ("--model", "graphsage", "--event-display", "x.json"),
    ("--bench-out", "x.json"),
    ("--buckets", "0", "8"),
    ("--bucket-microbatch", "0")])
def test_cli_refuses_flags_off_their_path(flags):
    """The demonstrator's flags serve ccn alone and ``--bench-out`` the
    other selections, as in the reference; sizes must be positive."""
    with pytest.raises(SystemExit):
        serve.parse_args(list(flags))
    args = serve.parse_args([])
    assert (args.buckets, args.bucket_microbatch, args.monitor_port,
            args.event_display, args.event_display_n, args.bench_out) == (
        None, 8, None, None, 16, None)
