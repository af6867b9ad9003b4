"""Reference of the benchmark (see ../README.md)."""
