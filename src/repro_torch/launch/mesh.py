"""Hardware constants the parallelization pass reads, and the serving
layer's replica placement.

The constants are copied from ``repro/launch/mesh.py`` without its JAX
mesh builders. They describe a TPU v5e chip: the design flow's cost
model ranks P choices with them (or with the CPU constants in
``passes/parallelize.py``) so that the port picks the reference's P
and micro-batch, and ``CompiledPipeline.resource_report`` reports the
reference's modelled working set against ``VMEM_BYTES``. They are not
a description of the H100; an H100 cost table is later work.
"""
import torch

PEAK_FLOPS_BF16 = 197e12      # per chip, FLOP/s
HBM_BW = 819e9                # per chip, B/s
VMEM_BYTES = 128 * 1024 * 1024  # the working-set limit resource_report uses


def replica_devices(n_replicas: int):
    """Device placement for the sharded serving layer.

    With several visible cards, replica i is pinned to ``cuda:{i %
    count}`` (its lane holds its own copy of the weights there). With
    one card, or none, every entry is ``None``: the replicas are
    thread-backed lanes on the pipeline's device.
    """
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count <= 1:
        return [None] * n_replicas
    return [torch.device(f"cuda:{i % count}") for i in range(n_replicas)]
