"""Tests of the benchmark (see ../README.md)."""
