"""Multi-device modes of the port (dist1d, dist2d, hybrid): the mesh, the
halo exchange, the sharded engine and the gather to the host, the
counterparts of ``heat2d_tpu/parallel/``."""
