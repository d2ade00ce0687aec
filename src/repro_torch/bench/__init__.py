"""Benchmarks of the port that need no JAX: the paper's figures
(``bench/figures.py``), the fleet sweep (``bench/fleet.py``) and the
campaigns that run them (``bench/campaigns.py``)."""
