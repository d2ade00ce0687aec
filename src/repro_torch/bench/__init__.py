"""Benchmarks of the port that need no JAX: the paper's figures
(``bench/figures.py``)."""
