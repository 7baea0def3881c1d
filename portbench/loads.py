"""The traffic kinds a cell can name ("kind" in its file), each driving the
program from one thread of its own:

- ``service``: a closed loop that keeps the streaming service's queue full.
  One thread submits the pool's events in turn, one event a ``submit``,
  held back only by the service's backpressure.
- ``open_loop``: Poisson arrivals at the cell's fixed ``rate_per_s``. Each
  event is submitted at its due time (or as soon after as the thread gets
  there) and timed from the due time, so a stall counts against every event
  behind it.
- ``batch``: the deployed pipeline called directly on whole batches of the
  pool in turn, each call's results copied to the host before the next call.

Each load records, per event or per call, the pool index, when it was due or
dispatched and when its answer reached the host, and keeps every answer for
the check that follows the window.
"""
from __future__ import annotations

import threading
import time

import numpy as np

RESULT_WAIT_S = 60.0


class _Thread:
    """Runs ``self._loop`` on a thread of its own; ``error`` keeps what it
    raised."""

    def __init__(self):
        self.error = None
        self.cpu_s = None
        self._thread = threading.Thread(target=self._guarded, daemon=True,
                                        name="portbench-load")

    def _guarded(self):
        try:
            self._loop()
        except BaseException as exc:  # noqa: BLE001 — re-raised by join()
            self.error = exc
        self.cpu_s = time.thread_time()

    def start(self):
        self._thread.start()

    def join(self, timeout=None):
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("the load thread did not stop")
        if self.error is not None:
            raise self.error


class ServiceLoad(_Thread):
    """The ``service`` and ``open_loop`` kinds over ``submit(event)``.

    ``events[k]`` is the k-th pool event. With ``due`` (seconds after
    ``t0``) each submission waits for its due time; without it the loop
    submits back to back until ``t_stop``."""

    def __init__(self, submit, events, t0: float, *, t_stop: float,
                 due=None):
        super().__init__()
        self.submit, self.events = submit, events
        self.t0, self.t_stop, self.due = t0, t_stop, due
        self.pool_idx: list = []
        self.t_due: list = []
        self.t_sub: list = []
        self.futures: list = []
        self.released: list = []          # (event index, perf_counter)

    def _loop(self):
        n_pool = len(self.events)
        i = 0
        while True:
            if self.due is not None:
                if i >= len(self.due):
                    return
                target = self.t0 + self.due[i]
                wait = target - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
            else:
                target = time.perf_counter()
                if target >= self.t_stop:
                    return
            k = i % n_pool
            fut = self.submit(self.events[k])
            self.t_sub.append(time.perf_counter())
            fut.add_done_callback(
                lambda _f, i=i: self.released.append((i, time.perf_counter())))
            self.pool_idx.append(k)
            self.t_due.append(target)
            self.futures.append(fut)
            i += 1

    def results(self):
        """(per event: its answer or None, the release times (nan where
        none)), waiting up to ``RESULT_WAIT_S`` for each answer."""
        deadline = time.perf_counter() + RESULT_WAIT_S
        answers = []
        for fut in self.futures:
            try:
                answers.append(fut.result(
                    timeout=max(0.0, deadline - time.perf_counter())))
            except Exception:  # noqa: BLE001 — an event that failed or
                answers.append(None)          # never came is unanswered
        rel = np.full(len(self.futures), np.nan)
        for i, t in list(self.released):
            rel[i] = t
        return answers, rel


class BatchLoad(_Thread):
    """The ``batch`` kind: ``call(batches[c % len(batches)])`` back to back
    from ``t0`` until the first call that ends at or after ``t_stop``."""

    def __init__(self, call, batches, t0: float, *, t_stop: float):
        super().__init__()
        self.call, self.batches = call, batches
        self.t0, self.t_stop = t0, t_stop
        self.pool_idx: list = []
        self.t_disp: list = []
        self.t_done: list = []
        self.outputs: list = []

    def _loop(self):
        c = 0
        while True:
            k = c % len(self.batches)
            t = time.perf_counter()
            out = self.call(self.batches[k])
            done = time.perf_counter()
            self.pool_idx.append(k)
            self.t_disp.append(t)
            self.t_done.append(done)
            self.outputs.append(out)
            c += 1
            if done >= self.t_stop:
                return
