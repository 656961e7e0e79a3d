"""Sharding rules (the data-parallel subset)."""
