"""Benchmarks of the port: `scaling.py`, the scaling sweep."""
