"""Readers that several per-layer metrics share (not a metric: a file of
``metrics/`` whose name starts with ``_`` is no metric). Each returns None
where it finds nothing to read."""
from __future__ import annotations

from portbench.trace import busy_s, kernel_time


def queue_wait_us(ctx):
    """The service's own mean queue wait over its last 65,536 events, read
    when the window closed."""
    if ctx.budget is None or ctx.budget["queue_wait_us_mean"] is None:
        return None
    return ctx.budget["queue_wait_us_mean"]


def plain_kernel_us_per_event(ctx):
    """Device µs of the kernels that are not hand kernels, per event
    completed in the traced stretch."""
    if ctx.trace is None or not ctx.trace_events:
        return None
    t = kernel_time(ctx.trace, lambda n: not ctx.is_hand(n))
    return 1e6 * t / ctx.trace_events


def kernel_roofline(ctx):
    """100 x the roofline time of the configuration's hand-kernel work for
    the events completed in the traced stretch / the hand kernels' device
    time there."""
    if ctx.trace is None or not ctx.trace_events:
        return None
    t = kernel_time(ctx.trace, ctx.is_hand)
    if t <= 0:
        return None
    return 100.0 * ctx.model.bound_s(ctx.trace_events) / t


def mfu(ctx):
    """100 x the model FLOPs a second of the window's untraced part / the
    peak of the configuration's stated precision."""
    if not ctx.completed:
        return None
    rate = ctx.completed * ctx.model.flops() / ctx.window_s
    return 100.0 * rate / ctx.model.peak


def device_idle_share(ctx):
    """100 x (1 - the device's busy seconds an event x the events a second
    of the window's untraced part). The busy seconds (the union of the
    device's operations) come from the traced stretch, per event done
    there: the profiler slows the host, not the device's work an event,
    so the stretch's own idle share would describe the profiler."""
    if ctx.trace is None or not ctx.trace_events or not ctx.completed:
        return None
    busy = busy_s(ctx.trace) / ctx.trace_events
    return 100.0 * (1.0 - busy * ctx.completed / ctx.window_s)
