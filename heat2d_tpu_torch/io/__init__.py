"""Text and binary grid I/O, byte-compatible with ``heat2d_tpu.io``."""
