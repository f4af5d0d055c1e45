"""Runnable scenarios of the port."""
