"""Datasets of the paper's convex experiments (numpy)."""
