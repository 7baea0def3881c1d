"""Device time of the kernels that are not the program's hand kernels
(the executor's plain ops; in a mixed CaloClusterNet chunk mostly CPS),
per event completed in the traced stretch."""
from portbench.metrics import _shared

UNIT = "us"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "executor and CPS"
MOVES = "batch_events_per_s"
WORKLOADS = ["ccn_upgrade.batch4096"]


def read(ctx):
    return _shared.plain_kernel_us_per_event(ctx)
