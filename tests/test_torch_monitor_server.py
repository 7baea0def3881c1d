"""The port's monitor server (``repro_torch/serving/monitor_server.py``)
against the reference's, on localhost: both bind port 0, and over
monitors fed the same records on the same clock, ``/snapshot`` and
``/events`` (with and without ``?n=``) answer the same bytes, ``/`` the
same page, an unknown path 404; ``for_service`` wires a monitored
service of each package and refuses an unmonitored one; ``close()``
stops the server."""
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
from test_torch_monitor import Clock, _scenario

import repro.serving as ref_serving
import repro.serving.monitor as ref_monitor
import repro_torch.serving as port_serving
import repro_torch.serving.monitor as port_monitor

TIMEOUT = 10


def _get(url):
    """(status, content type, body) of one GET."""
    try:
        with urllib.request.urlopen(url, timeout=TIMEOUT) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


PATHS = ["/snapshot", "/events", "/events?n=3", "/events?n=0", "/",
         "/index.html", "/display", "/nope"]


def _answers(serving, mon_mod, name):
    """Every path's answer from a server of ``serving`` over a monitor of
    ``mon_mod`` fed scenario ``name``."""
    mon = _scenario(mon_mod, name, clock=Clock())[3]
    server = serving.MonitorServer(mon.snapshot, mon.displays, port=0)
    try:
        assert server.port != 0
        assert server.url == f"http://127.0.0.1:{server.port}"
        return [_get(server.url + p) for p in PATHS]
    finally:
        server.close()


@pytest.mark.parametrize("name", ["truths", "wrapped"])
def test_endpoints_answer_as_the_reference(name):
    want = _answers(ref_serving, ref_monitor, name)
    got = _answers(port_serving, port_monitor, name)
    assert got == want
    by_path = dict(zip(PATHS, got, strict=True))
    assert by_path["/nope"][0] == 404
    status, ctype, body = by_path["/snapshot"]
    assert (status, ctype) == (200, "application/json")
    assert json.loads(body)["events"] > 0
    lines = by_path["/events?n=3"][2].decode().splitlines()
    assert len(lines) == 3 and all(json.loads(ln)["grid"] == [24, 24]
                                   for ln in lines)
    assert by_path["/"][2] == by_path["/display"][2] == \
        port_serving.monitor_server._PAGE.encode()


def _echo_cps(feeds):
    x = np.asarray(feeds["x"], np.float32)
    n = x.shape[0]
    return {"cps": {"trigger": x > 1.0,
                    "n_clusters": (x > 0.0).astype(np.int32),
                    "cluster_valid": np.repeat((x > 0.0)[:, None], 2, 1)
                    .astype(np.float32),
                    "cluster_xy": np.zeros((n, 2, 2), np.float32),
                    "cluster_e": np.repeat(x[:, None], 2, 1),
                    "cluster_beta": np.full((n, 2), 0.5, np.float32)}}


def _service_snapshot(pkg):
    """A monitored service's events served, then its /snapshot and
    /events read through ``MonitorServer.for_service``."""
    svc = pkg.ShardedTriggerService(_echo_cps, microbatch=2, window_s=1e-3,
                                    devices=None, monitor=True)
    try:
        futs = [svc.submit({"x": np.float32(i % 3)}, truth=i % 2 == 0)
                for i in range(7)]
        for f in futs:
            f.result(timeout=60)
        svc.drain(timeout=60)
        with pkg.MonitorServer.for_service(svc, port=0) as server:
            snap = json.loads(_get(server.url + "/snapshot")[2])
            events = _get(server.url + "/events")[2].decode().splitlines()
        return snap, [json.loads(e) for e in events], server
    finally:
        svc.close()


def test_for_service_serves_the_fleet_view():
    (ref_snap, ref_ev, _), (snap, ev, server) = (
        _service_snapshot(ref_serving), _service_snapshot(port_serving))
    keys = ("events", "trigger_rate", "efficiency", "fake_rate",
            "clusters_per_event", "cluster_e_mean", "truth_events", "serving")
    assert {k: snap[k] for k in keys} == {k: ref_snap[k] for k in keys}
    assert snap["events"] == 7
    assert ev == ref_ev and [e["event"] for e in ev] == list(range(7))
    # closed on leaving the with block: nothing answers there any more
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(server.url + "/snapshot", timeout=2)
