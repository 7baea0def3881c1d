"""The yardstick on hand-worked inputs: the generators repeat from a seed,
the open loop times each event from its due time, percentiles and busy time
are taken over everything, and the roofline and MFU counts hold."""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import catalog, counts, traffic
from portbench.loads import ServiceLoad
from portbench.metrics import _shared
from portbench.reduce import gaps, percentile, spread, union_length

SEED = 2 ** 31 + 12345


def test_belle2_events_repeat_from_a_seed():
    p = catalog.configs()["ccn_upgrade_mixed"]["events"]
    a = traffic.belle2_events(p, 40, traffic.rng(SEED, "pool"))
    b = traffic.belle2_events(p, 40, traffic.rng(SEED, "pool"))
    c = traffic.belle2_events(p, 40, traffic.rng(SEED + 1, "pool"))
    for k in a:
        assert np.array_equal(a[k], b[k])
    assert not np.array_equal(a["feats"], c["feats"])
    # energy-sorted, prefix-packed hits above 10 MeV on the grid
    e, m = a["feats"][..., 0], a["mask"]
    assert ((e > 0.01) == (m > 0)).all()
    assert (np.diff(e, axis=1) <= 0).all()
    assert (m[:, 1:] <= m[:, :-1]).all()
    assert (np.abs(a["feats"][..., 1:3]) <= 0.5).all()
    assert m.sum(1).mean() > 20


def test_every_seed_gets_the_same_gaps_in_another_order():
    g1 = traffic.arrival_gaps(400.0, 4000, traffic.rng(1, "arrivals"))
    g2 = traffic.arrival_gaps(400.0, 4000, traffic.rng(2, "arrivals"))
    assert np.array_equal(np.sort(g1), np.sort(g2))
    assert not np.array_equal(g1, g2)
    assert abs(g1.mean() * 400.0 - 1.0) < 0.01


def test_streams_of_one_seed_differ():
    assert traffic.derived_seed(SEED, "weights") != traffic.derived_seed(
        SEED, "arrivals")
    assert traffic.derived_seed(SEED, "weights") == traffic.derived_seed(
        SEED, "weights")


def test_open_loop_times_from_the_due_time():
    """A service that stalls once: every event behind the stall is late by
    it, measured from when it was due, not from when it was submitted."""
    stall_at, stall_s = 3, 0.2

    def submit(ev):
        if ev == stall_at:
            time.sleep(stall_s)     # the submit itself blocks
        f = Future()
        f.set_result(ev)
        return f

    due = np.arange(8) * 0.01
    t0 = time.perf_counter() + 0.05
    load = ServiceLoad(submit, list(range(8)), t0, t_stop=t0 + 1, due=due)
    load.start()
    load.join(timeout=10)
    answers, rel = load.results()
    assert answers == list(range(8))
    assert np.allclose(load.t_due, t0 + due)
    lat = rel - np.asarray(load.t_due)
    assert (lat[:3] < 0.05).all()
    # events 3.. were due before the stall ended: each is late by the rest
    for i in range(3, 8):
        assert lat[i] >= stall_s - (due[i] - due[stall_at]) - 1e-3
    sub = np.asarray(load.t_sub) - np.asarray(load.t_due)
    assert sub[4] > 0.1


def test_closed_loop_keeps_submitting_until_stop():
    n = []
    lock = threading.Lock()

    def submit(ev):
        with lock:
            n.append(ev)
        f = Future()
        f.set_result(ev)
        return f
    t0 = time.perf_counter()
    load = ServiceLoad(submit, ["a", "b"], t0, t_stop=t0 + 0.05)
    load.start()
    load.join(timeout=10)
    assert len(n) > 10 and n[:4] == ["a", "b", "a", "b"]


def test_percentile_is_over_all_values():
    xs = list(range(1, 101))
    assert percentile(xs, 99) == 99
    assert percentile(xs, 50) == 50
    assert percentile([5.0], 99) == 5.0
    assert percentile(list(range(1000)) + [1e9] * 11, 99) == 1e9


def test_union_of_intervals_counts_overlap_once():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7)]
    assert union_length(iv, 0.0, 10.0) == pytest.approx(4.0)
    assert union_length(iv, 1.5, 5.5) == pytest.approx(2.0)
    assert gaps(iv, 0.0, 10.0) == [(3.0, 5.0), (6.0, 10.0)]


def test_spread_is_the_quartile_distance_over_the_median():
    assert spread([1.0, 2.0, 3.0, 4.0, 5.0, 6.0]) == pytest.approx(
        (5.25 - 1.75) / 3.5)


def test_model_flops_by_hand():
    ccn = catalog.configs()["ccn_upgrade_mixed"]
    # encoder 2·128·(4·64 + 64·64) = 1,114,112; a block: S and F
    # 2·128·64·26 = 425,984, distances 2·128²·4 = 131,072, the k = 8
    # neighbours' features 2·128·8·22 = 45,056, output 2·128·108·64 =
    # 1,769,472, together 2,371,584; decoder 2·128·(64·64 + 64·32) =
    # 1,572,864; heads 2·128·32·7 = 57,344
    assert counts.ccn_flops_per_event(ccn) == (
        1_114_112 + 2 * 2_371_584 + 1_572_864 + 57_344)


def test_kernel_counts_by_hand():
    nbytes, ops = counts.fused_dense_int8(256, 64, 64, out_int8=True)
    assert nbytes == (256 + 64) * 64 + 8 * 64 + 256 * 64
    assert ops["int8"] == 2.0 * 256 * 64 * 64
    # bytes bound at HBM, operations at their peaks
    assert counts.bound_s(3.35e12, {"f32": 1.0}) == pytest.approx(1.0)
    assert counts.bound_s(0.0, {"int8": 1979e12}) == pytest.approx(1.0)
    # one event of the mixed chain, then many: work grows with events
    one = counts.ccn_mixed_bound_s(catalog.configs()["ccn_upgrade_mixed"], 1)
    many = counts.ccn_mixed_bound_s(catalog.configs()["ccn_upgrade_mixed"],
                                    1000)
    assert 0 < one and 500 * one < many < 1000 * one


def _ctx(kernel_s, events, model):
    rec = {"ops": [("void fused_dense_int8_kernel<64>(...)", 0.0, kernel_s),
                   ("void at::native::elementwise_kernel<1>(...)", 0.5,
                    0.75)],
           "lo": 0.0, "hi": 1.0, "host": []}
    return SimpleNamespace(trace=rec, trace_events=events, model=model,
                           completed=2 * events, window_s=4.0,
                           is_hand=lambda n: "fused_dense_int8_kernel" in n)


def test_roofline_share_is_the_bound_over_the_kernel_time():
    model = SimpleNamespace(bound_s=lambda e: 1e-3 * e)
    assert _shared.kernel_roofline(_ctx(0.5, 100, model)) == pytest.approx(
        20.0)
    assert _shared.kernel_roofline(_ctx(0.5, 0, model)) is None
    # busy 0.75 s for 2 events traced, 0.375 s an event; 4 events in the
    # untraced 4 s keep the device busy 1.5 s of them
    assert _shared.device_idle_share(_ctx(0.5, 2, model)) == pytest.approx(
        62.5)



def test_work_counts_a_call_by_its_share_inside():
    """Calls of 10 events over [0, 1], [1, 3], [3, 4]: [0.5, 3.5] holds
    half the first, all the second and half the third; answers with no
    span count where they came."""
    from portbench.harness import _work
    spans = (np.array([0.0, 1.0, 3.0]), np.array([1.0, 3.0, 4.0]), 10)
    assert _work(spans, 0.5, 3.5) == pytest.approx(20.0)
    assert _work(spans, 0.0, 4.0) == pytest.approx(30.0)
    t = np.array([0.2, 0.6, 0.9])
    assert _work((t, t, 1), 0.5, 1.0) == 2.0


def test_a_window_keeps_its_ends_when_markers_are_dropped():
    """Either marker alone and the host's span give both ends; with
    neither, the wall clock's readings do."""
    import torch

    from portbench.trace import Window
    w = Window(torch)
    w.h0, w.h1 = 100.0, 102.0
    w.wall0, w.wall1 = 4.9, 6.9
    w._first_op, w._last_op = 5.0, 7.0
    assert w._ends([("spin_kernel", 5.0, 5.0), ("spin_kernel", 7.0, 7.0)]
                   ) == (5.0, 7.0)
    assert w._ends([("spin_kernel", 5.1, 5.1)]) == (5.1, 7.1)
    assert w._ends([("spin_kernel", 7.0, 7.0)]) == (5.0, 7.0)
    assert w._ends([]) == (4.9, 6.9)
