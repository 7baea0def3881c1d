"""The traced sub-window: torch.profiler's device activity alone, a sparse
sampler of the host's frames, and their reduction to intervals, busy time
and a breakdown.

Only the device's activity is traced (CUPTI records every kernel, copy and
set, whichever thread launched it). The records still slow a host-bound
cell's host to about half its pace, so the readings take device time per
event done in the stretch, which the host's pace does not change, and
never the stretch's own idle share. With no host event on the profiler's
clock, the stretch's ends are two marker kernels (``torch.cuda._sleep`` of
one cycle) launched on a stream of their own when it opens and when it
closes; the profiler drops one now and then, and the host's span or the
wall clock stands in (``Window._ends``). What the host was doing in an
idle gap is read from the innermost Python frame of every thread, sampled
every ``SAMPLE_S``: sparse enough to cost the host little, dense enough to
land in most gaps of a few milliseconds.
"""
from __future__ import annotations

import os
import re
import sys
import threading
import time

from portbench.reduce import gaps, union_length

SAMPLE_S = 5e-3
MARKER = "spin_kernel"
# innermost frames that mean a thread is parked, not working
_PARKED = re.compile(r"^(threading|queue|selectors|thread)\.py:")


def _activities(torch):
    return [torch.profiler.ProfilerActivity.CUDA]


def start_tracer(torch):
    """An empty profiler session, so that the tracer runs before the
    program captures its CUDA graphs (kernels of a graph captured earlier
    go unrecorded)."""
    with torch.profiler.profile(activities=_activities(torch)):
        pass


class HostSampler:
    """Every ``SAMPLE_S`` the innermost Python frame of each thread but
    its own and the one that started it (which only waits for the window's
    end), as (perf_counter, [label, ...]) with labels "file.py:function"."""

    def __init__(self):
        self.samples: list = []
        self._starter = threading.get_ident()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="portbench-sampler")

    def _run(self):
        skip = {threading.get_ident(), self._starter}
        while not self._stop.wait(SAMPLE_S):
            t = time.perf_counter()
            labels = []
            for tid, frame in sys._current_frames().items():
                if tid in skip:
                    continue
                code = frame.f_code
                labels.append(f"{os.path.basename(code.co_filename)}:"
                              f"{code.co_name}")
            self.samples.append((t, labels))

    def start(self):
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)


class Window:
    """One profiled stretch: ``start()`` and ``stop()`` bracket it on the
    host clock (``h0``, ``h1``) and on the device (the markers); ``read()``
    gives its device records."""

    def __init__(self, torch):
        self.torch = torch

    def _marker(self):
        with self.torch.cuda.stream(self.stream):
            self.torch.cuda._sleep(1)

    def start(self):
        self.sampler = HostSampler()
        self.stream = self.torch.cuda.Stream()
        self.prof = self.torch.profiler.profile(
            activities=_activities(self.torch))
        self.prof.__enter__()
        self.h0, self.wall0 = time.perf_counter(), time.time_ns() * 1e-9
        self._marker()
        self.sampler.start()

    def stop(self):
        self.h1, self.wall1 = time.perf_counter(), time.time_ns() * 1e-9
        self._marker()
        self.sampler.stop()
        self.torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)

    def read(self) -> dict:
        """{"ops": [(name, start_s, end_s)] of the device between the
        markers (profiler clock, seconds), "lo", "hi": the markers' starts,
        and "host": the sampler's records shifted onto that clock}. Reads
        the profiler's raw records: building its Python events for some
        hundred thousand kernels would take a minute."""
        dev = self.torch.autograd.DeviceType.CUDA
        ops, marks = [], []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != dev:
                continue
            s = e.start_ns() * 1e-9
            rec = (e.name(), s, s + e.duration_ns() * 1e-9)
            (marks if MARKER in rec[0] else ops).append(rec)
        self._first_op = min((r[1] for r in ops), default=0.0)
        self._last_op = max((r[2] for r in ops), default=0.0)
        lo, hi = self._ends(marks)
        shift = lo - self.h0
        host = [(t + shift, labels) for t, labels in self.sampler.samples]
        inside = [(n, max(s, lo), min(e, hi)) for n, s, e in ops
                  if e > lo and s < hi]
        if not inside:
            raise RuntimeError(f"none of {len(ops)} device records lies in "
                               f"the stretch ({len(marks)} markers kept)")
        # each marker kept against the wall clock at its end, for the record
        skew = [min((1e6 * (t - w) for w in (self.wall0, self.wall1)),
                    key=abs) for _, t, _ in marks]
        return {"ops": inside, "lo": lo, "hi": hi, "host": host,
                "markers": len(marks), "clock_skew_us": skew}

    def _ends(self, marks):
        """The stretch's ends on the profiler's clock: the two markers'
        starts; where the profiler dropped one, the other's start and the
        stretch's length on the host clock; where it dropped both, the wall
        clock's readings at the ends (the profiler stamps its records in
        nanoseconds of the wall clock, some milliseconds off on the card,
        against a stretch of seconds)."""
        span = self.h1 - self.h0
        starts = sorted(s for _, s, _ in marks)
        if len(starts) == 2:
            return tuple(starts)
        if len(starts) == 1:
            t = starts[0]
            late = abs(t - self._first_op) > abs(t - self._last_op)
            return (t - span, t) if late else (t, t + span)
        return self.wall0, self.wall1


def busy_s(rec: dict) -> float:
    """Seconds of the window in which some operation ran on the device."""
    return union_length([(s, e) for _, s, e in rec["ops"]], rec["lo"],
                        rec["hi"])


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset", "cudaMem"))


def kernel_time(rec: dict, pick) -> float:
    """Summed seconds of the kernels whose names ``pick`` accepts."""
    return sum(e - s for n, s, e in rec["ops"] if is_kernel(n) and pick(n))


def _host_label(rec, lo, hi) -> str:
    """The working frame the sampler saw most often during [lo, hi]; if
    every thread was parked, the most frequent parked one."""
    work: dict = {}
    parked: dict = {}
    for t, labels in rec["host"]:
        if lo <= t <= hi:
            for lab in labels:
                d = parked if _PARKED.match(lab) else work
                d[lab] = d.get(lab, 0) + 1
    if work:
        return "host: " + max(work, key=work.get)
    if parked:
        return "host parked: " + max(parked, key=parked.get)
    return "host: no sample"


def breakdown(rec: dict, top: int = 10) -> dict:
    """The device operations that took most time (summed by name, names
    cut to 120 characters) and the longest idle gaps, each named by the
    busiest working frame the host sampler saw during it."""
    by_name: dict = {}
    for n, s, e in rec["ops"]:
        by_name[n[:120]] = by_name.get(n[:120], 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps([(s, e) for _, s, e in rec["ops"]], rec["lo"],
                       rec["hi"]), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n, t] for n, t in ops],
            "idle_gaps": [[_host_label(rec, a, b), b - a] for a, b in idle]}
