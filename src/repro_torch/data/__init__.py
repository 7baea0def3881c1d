"""Synthetic data for the port (numpy only) and its prefetching
loader."""
from repro_torch.data.loader import Prefetcher

__all__ = ["Prefetcher"]
