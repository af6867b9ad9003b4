"""The port's native host code: the ``.dat`` text formatter
(``heat2d_io.cpp``), loaded through ``native/lib.py``."""
