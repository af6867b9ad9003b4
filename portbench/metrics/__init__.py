"""Metrics of the benchmark (see ../README.md)."""
