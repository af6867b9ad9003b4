"""Drivers of the benchmark (see ../README.md)."""
