"""Slot-based serving engine of the port."""
