"""In-memory state snapshots: the device-to-host half of a checkpoint
(the port's copy of ``heat2d_tpu/resil/snapshot.py``).

The async checkpoint writer (``resil/writer.py``) takes its snapshots
here on the main thread, between two segments of a run, and hands them
to its worker thread for the file write; the inverse driver keeps its
best optimizer iterate with ``snapshot_state`` (``diff/inverse.py``). A
snapshot is a host numpy array that owns its data: a torch tensor is
mutable and a runner may hand the next segment a buffer it writes into,
so the snapshot never aliases its source, and later steps on the source
cannot touch it.
"""

from __future__ import annotations

import numpy as np


def snapshot_state(u, shape=None, dtype=np.float32) -> np.ndarray:
    """A host copy of ``u`` (a numpy array or a tensor on any device),
    cropped to ``shape`` where given (the equal-shard padding of an
    uneven decomposition). ``dtype`` defaults to the checkpoint format's
    float32; ``None`` keeps the source's dtype, so that an f64 iterate is
    not truncated through f32. A tensor is cropped on its device and
    copied to the host once (a synchronous copy: it waits for the
    kernels that produce ``u``)."""
    if hasattr(u, "detach"):
        import torch
        t = u.detach()
        if shape is not None and tuple(t.shape) != tuple(shape):
            t = t[tuple(slice(0, s) for s in shape)]
        want = t.dtype if dtype is None else getattr(
            torch, np.dtype(dtype).name)
        # copy=True: a fresh host tensor even when ``t`` already lies on
        # the CPU, so the array below owns what nothing else can write
        return t.to(device="cpu", dtype=want, copy=True).numpy()
    host = np.asarray(u, dtype=dtype)
    if shape is not None and tuple(host.shape) != tuple(shape):
        host = host[tuple(slice(0, s) for s in shape)]
    # np.asarray may hand back the source itself or a view of it; a
    # snapshot must own its data.
    if host.base is not None or np.shares_memory(host, u):
        host = host.copy()
    return host


def snapshot_shards(grid) -> list:
    """This process's blocks of a ``parallel.sharded.ShardedGrid`` as host
    float32 arrays at their global offsets, ``[(row0, col0, block),
    ...]``, the equal-shard padding included (blocks of other processes
    are left out): the snapshot half of a sharded checkpoint. No
    collective: safe on any thread."""
    bm, bn = grid.block_shape
    return [(i * bm, j * bn, snapshot_state(blk))
            for i, row in enumerate(grid.blocks)
            for j, blk in enumerate(row) if blk is not None]
