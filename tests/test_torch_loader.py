"""The port's prefetching loader (``repro_torch/data/loader.py``) and
the training driver's stream: straggler reuse of the last batch past
the deadline, a generator's error raised by the next ``get()``,
``close()`` stopping the worker, and a stream resumed at step s equal to
the tail of an unbroken one (the same bytes as the reference's).
"""
import itertools
import threading
import time

import numpy as np
import pytest

from repro.data.belle2 import event_stream as jevent_stream
from repro.data.belle2 import Belle2Config as JBelle2Config
from repro_torch import configs
from repro_torch.data import Prefetcher
from repro_torch.data.loader import timed
from repro_torch.launch import train


def test_prefetcher_serves_in_order():
    with Prefetcher(iter(range(10)), depth=2) as pf:
        assert [pf.get() for _ in range(10)] == list(range(10))
        assert pf.stats == {"batches": 10, "stragglers": 0}


def test_straggler_reuses_last_batch():
    release = threading.Event()

    def gen():
        yield "first"
        release.wait(5.0)
        yield "second"
    pf = Prefetcher(gen(), depth=1, deadline_s=0.2)
    try:
        assert pf.get() == "first"
        t0 = time.perf_counter()
        assert pf.get() == "first"          # stalled: the last batch again
        assert time.perf_counter() - t0 >= 0.19
        assert pf.stats["stragglers"] == 1
        release.set()
        assert pf.get() == "second"
    finally:
        release.set()
        pf.close()


def test_nothing_within_deadline_raises():
    def gen():
        time.sleep(1.0)
        yield 1
    with Prefetcher(gen(), deadline_s=0.1) as pf:
        with pytest.raises(TimeoutError, match="produced nothing"):
            pf.get()


def test_generator_error_surfaces_on_get():
    first_taken = threading.Event()

    def gen():
        yield 1
        first_taken.wait(5.0)
        raise RuntimeError("disk gone")
    with Prefetcher(gen(), depth=4, deadline_s=1.0) as pf:
        assert pf.get() == 1
        first_taken.set()
        deadline = time.time() + 5
        while pf._exc is None and time.time() < deadline:
            time.sleep(0.01)
        with pytest.raises(RuntimeError, match="disk gone"):
            pf.get()


def test_close_stops_the_worker():
    produced = []

    def gen():
        for i in itertools.count():
            produced.append(i)
            yield i
    pf = Prefetcher(gen(), depth=2)
    assert pf.get() == 0
    pf.close()
    pf._t.join(timeout=5.0)
    assert not pf._t.is_alive()
    assert len(produced) <= 6


def test_timed_yields_items_with_durations():
    out = list(timed(iter([1, 2])))
    assert [x for x, _ in out] == [1, 2]
    assert all(dt >= 0.0 for _, dt in out)


@pytest.mark.parametrize("start", [3, 7])
def test_resumed_stream_is_the_tail_of_an_unbroken_one(start):
    mod = configs.get_arch("caloclusternet")
    cfg = mod.smoke_config()
    whole = list(itertools.islice(
        train.make_data_stream("caloclusternet", mod, cfg, 4, 11, 0),
        start + 3))
    tail = list(itertools.islice(
        train.make_data_stream("caloclusternet", mod, cfg, 4, 11, start), 3))
    gen = JBelle2Config(n_crystals=576, grid=(24, 24), n_hits=cfg.n_hits,
                        noise_rate=4.0)
    ref = list(itertools.islice(jevent_stream(gen, 4, seed0=11 + start), 3))
    for got, want, jwant in zip(tail, whole[start:], ref):
        assert list(got) == list(want) == list(jwant)
        for k in want:
            assert got[k].tobytes() == want[k].tobytes() == \
                np.asarray(jwant[k]).tobytes()
