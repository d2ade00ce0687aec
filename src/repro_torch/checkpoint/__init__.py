"""Checkpoints in the JAX package's npz layout."""
