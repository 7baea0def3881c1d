"""Prefetching loader with straggler mitigation.

Counterpart of ``repro/data/loader.py``, the same semantics: a
background thread keeps ``depth`` batches ready; ``get()`` enforces a
deadline — if generation stalls (slow host, the straggler case), it
returns the last good batch and records the incident instead of blocking
the accelerator step. An exception in the generator is raised by the
next ``get()``. Deterministic streams (seeded per step) make
checkpoint-resume exact: pass ``start_step`` when resuming.
"""
from __future__ import annotations

import queue
import threading
import time


class Prefetcher:
    def __init__(self, gen, *, depth: int = 2, deadline_s: float = 30.0):
        self._gen = gen
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._deadline = deadline_s
        self._stop = threading.Event()
        self._exc = None
        self.stats = {"batches": 0, "stragglers": 0}
        self._last = None
        self._t = threading.Thread(target=self._worker, daemon=True)
        self._t.start()

    def _worker(self):
        try:
            for item in self._gen:
                if self._stop.is_set():
                    return
                while True:
                    try:
                        self._q.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        if self._stop.is_set():
                            return
        except Exception as e:  # surfaced on the next get()
            self._exc = e

    def get(self):
        if self._exc is not None:
            raise self._exc
        try:
            item = self._q.get(timeout=self._deadline)
            self._last = item
            self.stats["batches"] += 1
            return item
        except queue.Empty:
            if self._last is None:
                raise TimeoutError("data pipeline produced nothing "
                                   f"within {self._deadline}s")
            # straggler mitigation: reuse the last batch, don't stall
            self.stats["stragglers"] += 1
            return self._last

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def timed(gen):
    """Wrap a generator yielding (batch, gen_seconds)."""
    for item in gen:
        t0 = time.perf_counter()
        yield item, time.perf_counter() - t0
