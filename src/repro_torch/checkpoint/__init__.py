"""Checkpoints on the JAX package's on-disk format."""
