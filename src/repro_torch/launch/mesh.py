"""Hardware constants the parallelization pass reads.

Copied from ``repro/launch/mesh.py`` without its JAX mesh builders.
They describe a TPU v5e chip: the design flow's cost model ranks P
choices with them (or with the CPU constants in
``passes/parallelize.py``) so that the port picks the reference's P
and micro-batch. They are not a description of the H100; an H100 cost
table is later work.
"""
PEAK_FLOPS_BF16 = 197e12      # per chip, FLOP/s
HBM_BW = 819e9                # per chip, B/s
