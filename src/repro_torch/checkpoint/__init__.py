"""Checkpoints of the port, in the JAX package's on-disk format."""
