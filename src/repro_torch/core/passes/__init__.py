"""Design-flow passes of the port (fuse, partition, map, parallelize,
kernel_opt, verify)."""
