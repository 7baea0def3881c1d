"""Model FLOPs of the events completed in the window's untraced part over
its seconds, as a share of the card's peak in the precision the
configuration states for its products (int8 for the mixed
CaloClusterNet)."""
from portbench.metrics import _shared

UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
LAYER = "model step"
MOVES = "batch_events_per_s"
WORKLOADS = ["ccn_upgrade.batch4096"]


def read(ctx):
    return _shared.mfu(ctx)
