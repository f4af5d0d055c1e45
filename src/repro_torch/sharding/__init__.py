"""Logical-axis sharding rules (``partition``)."""
