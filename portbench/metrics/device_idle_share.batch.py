"""The share of the window's untraced part in which no operation ran on
the card: 1 - the device's busy seconds an event (from the traced
stretch) x the events a second before it."""
from portbench.metrics import _shared

UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device (H100)"
MOVES = "batch_events_per_s"
WORKLOADS = ["ccn_upgrade.batch4096"]


def read(ctx):
    return _shared.device_idle_share(ctx)
