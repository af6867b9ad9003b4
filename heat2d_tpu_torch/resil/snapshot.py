"""In-memory state snapshots: the device-to-host half of a checkpoint
(the port's copy of ``heat2d_tpu/resil/snapshot.py``).

The inverse driver keeps its best optimizer iterate with
``snapshot_state`` (``diff/inverse.py``). A snapshot is a host numpy array
that owns its data: mutating it cannot touch the source, and later steps
on the source cannot touch it.
"""

from __future__ import annotations

import numpy as np


def snapshot_state(u, shape=None, dtype=np.float32) -> np.ndarray:
    """A host copy of ``u`` (a numpy array or a tensor on any device),
    cropped to ``shape`` where given (the equal-shard padding of an
    uneven decomposition). ``dtype`` defaults to the checkpoint format's
    float32; ``None`` keeps the source's dtype, so that an f64 iterate is
    not truncated through f32."""
    if hasattr(u, "detach"):
        u = u.detach().cpu().numpy()
    host = np.asarray(u, dtype=dtype)
    if shape is not None and tuple(host.shape) != tuple(shape):
        host = host[tuple(slice(0, s) for s in shape)]
    # np.asarray may hand back the source itself or a view of it; a
    # snapshot must own its data.
    if host.base is not None or np.shares_memory(host, u):
        host = host.copy()
    return host


def snapshot_shards(grid) -> list:
    """The blocks of a ``parallel.sharded.ShardedGrid`` as host float32
    arrays at their global offsets, ``[(row0, col0, block), ...]``, the
    equal-shard padding included: the snapshot half of a sharded
    checkpoint."""
    bm, bn = grid.block_shape
    return [(i * bm, j * bn, snapshot_state(blk))
            for i, row in enumerate(grid.blocks)
            for j, blk in enumerate(row)]
