"""The single-process part of ``heat2d_tpu/parallel/multihost.py``: the
gather of a run's result to the host. Multi-process bring-up
(``initialize_distributed``) waits for the port's ``dist/`` slice."""

from __future__ import annotations

import numpy as np


def gather_to_host(u) -> np.ndarray:
    """The full array on the host as numpy, the MPI result-gather: a
    ``ShardedGrid``'s blocks concatenated back into the (padded) global
    grid, a tensor copied from its device, a host array as it is. The
    caller crops the equal-shard padding."""
    if hasattr(u, "blocks"):
        return np.block([[b.detach().cpu().numpy() for b in row]
                         for row in u.blocks])
    if hasattr(u, "detach"):
        return u.detach().cpu().numpy()
    return np.asarray(u)
