from repro_torch.dist.sharding import (DP, TP, NamedSharding, P,
                                       logical_to_physical,
                                       specs_from_rules)

__all__ = ["DP", "TP", "NamedSharding", "P", "logical_to_physical",
           "specs_from_rules"]
