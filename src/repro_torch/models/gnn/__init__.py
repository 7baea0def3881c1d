"""Edge-based GNNs served beside the CaloClusterNet trigger. Importing
this package registers their exporters (``core/graph_ir.py``)."""
from repro_torch.models.gnn import common, gatedgcn, graphsage

__all__ = ["common", "gatedgcn", "graphsage"]
