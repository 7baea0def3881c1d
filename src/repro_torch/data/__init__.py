"""Synthetic event data for the port (numpy only)."""
