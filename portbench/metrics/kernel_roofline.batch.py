"""The hand kernels' share of their roofline: the least time the card
needs for the configuration's hand-kernel work on the events completed in
the traced stretch, over the hand kernels' device time there."""
from portbench.metrics import _shared

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "batch_events_per_s"
WORKLOADS = ["ccn_upgrade.batch4096"]


def read(ctx):
    return _shared.kernel_roofline(ctx)
