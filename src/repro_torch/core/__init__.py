"""The port of the design flow, CaloClusterNet and the executor."""
