"""Models of the port beside CaloClusterNet (``core/caloclusternet.py``)."""
