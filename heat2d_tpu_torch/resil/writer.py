"""Async double-buffered checkpoint writer: restart points off the hot
loop. The port's copy of ``heat2d_tpu/resil/writer.py``.

A checkpoint has two phases, and the writer overlaps the expensive one
with the next segment's kernels:

1. **Snapshot** (main thread): the state is copied to host memory: one
   synchronous device-to-host copy of the grid, or of this process's
   blocks of a ``ShardedGrid`` (``resil.snapshot``). It runs after the
   segment's kernels have finished (the copy waits for them) and before
   the next segment launches, and the host copy owns its data: a torch
   tensor is mutable, and a runner may reuse a buffer the next segment
   writes into, so nothing of the device state is read later. A grid on
   a card is copied into a pinned staging buffer that the writer owns
   (on an H100, 64 MiB in ~1.2 ms against ~24 ms pageable; PERF.md):
   one buffer suffices, since a save first waits out the previous
   write, the only reader of the buffer.
2. **Write + commit** (a worker thread): the snapshot is staged,
   digested and promoted (``io.binary``'s temp + ``os.replace``
   protocol), then indexed into the ``CheckpointManager`` manifest.

Double-buffered: at most ONE write is in flight; ``save_async`` first
waits out the previous write (a slow disk back-pressures to the
checkpoint cadence instead of queueing snapshots), then returns as soon
as the new snapshot is on the host.

**Collective safety.** In a world of processes the worker thread never
runs a collective. For a grid that spans processes, the collective
pieces (process 0 sizing the shared staging file, the barrier that
orders it before any write, the all-done barrier before process 0
commits) run on the MAIN thread inside ``save_async``/``flush``; only
this process's block writes (``io.binary._write_local_blocks``) ride the
worker. The commit of checkpoint N is therefore deferred to the next
``save_async`` (or ``flush``): N becomes durable while N+1 computes, and
the manifest only ever indexes files every process finished.

Each save appends ``{"step", "snapshot_s", "write_s"}`` to ``timings``:
the main thread's seconds in the snapshot, and the worker's in the
write, sha256 and commit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

import numpy as np

from heat2d_tpu_torch.analysis.locks import AuditedLock, guarded_by
from heat2d_tpu_torch.io.binary import (_stage_file, _write_local_blocks,
                                        checkpoint_tmp_path,
                                        commit_checkpoint_files)
from heat2d_tpu_torch.parallel import multihost
from heat2d_tpu_torch.resil.manager import CheckpointManager
from heat2d_tpu_torch.resil.snapshot import snapshot_shards, snapshot_state

log = logging.getLogger("heat2d_tpu_torch.resil")


@dataclasses.dataclass
class _PendingCommit:
    """A collective checkpoint whose local writes are in flight; the
    commit (barrier + process-0 promote + manifest) is still owed."""
    step: int
    tmp: str
    path: str
    config: object
    out_shape: tuple


@guarded_by("_lock", "_future", "_pending", "_closed", "saves")
class AsyncCheckpointer:
    """Write restart points without blocking the run.

    ``target`` is a ``CheckpointManager`` (directory mode: manifest,
    retention, ``latest_valid``) or a plain path (a single-file restart
    point, replaced atomically by each save). ``shape`` crops the
    equal-shard padding of a sharded state.
    """

    def __init__(self, target, config, shape=None, registry=None):
        self.manager = (target if isinstance(target, CheckpointManager)
                        else None)
        self.path = None if self.manager is not None else str(target)
        self.config = config
        self.shape = tuple(shape) if shape is not None else None
        self.registry = registry
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="heat2d-ckpt")
        self._future: Optional[Future] = None
        self._pending: Optional[_PendingCommit] = None
        self._closed = False
        self._lock = AuditedLock("resil.writer")
        self.saves = 0
        self.timings: list = []
        self._staging = None    # pinned host buffer of a card's grid

    # -- public -------------------------------------------------------- #

    def save_async(self, u, step: int) -> None:
        """Snapshot ``u`` (a tensor, a host array or a ``ShardedGrid``)
        and schedule its durable commit. Returns once the snapshot is on
        the host: the file I/O overlaps the caller's next segment.
        COLLECTIVE when ``u`` spans processes (every process calls, in
        the same order); otherwise process 0 writes and the call is a
        no-op elsewhere."""
        with self._lock:
            if self._closed:
                raise RuntimeError("AsyncCheckpointer is closed")
            self._finish_pending_locked()
            if getattr(u, "spans_processes", False):
                self._save_collective_locked(u, step)
            else:
                self._save_local_locked(u, step)
            self.saves += 1
            self._gauge_pending()

    def flush(self) -> None:
        """Wait until every scheduled checkpoint is durable (commit
        barriers included). COLLECTIVE in a world, like the saves it
        drains. Write errors surface here (and on the next
        ``save_async``), never silently."""
        with self._lock:
            self._finish_pending_locked()
            self._gauge_pending()

    def close(self) -> None:
        try:
            self.flush()
        finally:
            with self._lock:    # save_async reads _closed under it
                self._closed = True
            self._pool.shutdown(wait=True)

    def __enter__(self) -> "AsyncCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- one process writes ------------------------------------------- #

    def _save_local_locked(self, u, step: int) -> None:
        if multihost.process_index() != 0:
            return
        t0 = time.perf_counter()
        if hasattr(u, "blocks"):
            host = snapshot_shards(u)
            shape = self.shape or (u.nx, u.ny)
        elif getattr(u, "is_cuda", False):
            host = self._stage(u)
            shape = host.shape
        else:
            host = snapshot_state(u, shape=self.shape)
            shape = host.shape
        timing = {"step": int(step), "snapshot_s": time.perf_counter() - t0}
        self.timings.append(timing)
        self._future = self._pool.submit(
            self._write_and_commit, host, shape, step, self._path_for(step),
            timing)

    def _stage(self, u):
        """A card's grid (cropped to ``shape``) copied into the pinned
        staging buffer, as a numpy view of it. The previous write, the
        buffer's only reader, has finished (``save_async`` waits it
        out)."""
        import torch
        t = u.detach()
        if self.shape is not None and tuple(t.shape) != self.shape:
            t = t[:self.shape[0], :self.shape[1]]
        if self._staging is None or self._staging.shape != t.shape:
            self._staging = torch.empty(t.shape, dtype=torch.float32,
                                        pin_memory=True)
        self._staging.copy_(t)      # synchronous: waits for the kernels
        return self._staging.numpy()

    def _write_and_commit(self, host, shape, step, path, timing) -> None:
        t0 = time.perf_counter()
        timer = (self.registry.timer("resil_ckpt_async_write_s")
                 if self.registry is not None else contextlib.nullcontext())
        with timer:
            tmp = checkpoint_tmp_path(path)
            if isinstance(host, list):
                _stage_file(tmp, *shape)
                _write_local_blocks(host, tmp, *shape)
            else:
                # the buffer itself, no bytes copy: the write releases the
                # GIL, so the next segment's launches are not held up
                with open(tmp, "wb") as f:
                    f.write(memoryview(np.ascontiguousarray(
                        host, dtype=np.float32)).cast("B"))
            commit_checkpoint_files(tmp, path, step, self.config, shape)
            if self.manager is not None:
                self.manager.index(step)
            elif self.registry is not None:
                self.registry.counter("resil_ckpt_saves_total")
        timing["write_s"] = time.perf_counter() - t0
        log.debug("async checkpoint committed: step=%d path=%s", step, path)

    # -- every process writes its blocks ------------------------------- #

    def _save_collective_locked(self, u, step: int) -> None:
        path = self._path_for(step)
        tmp = checkpoint_tmp_path(path)
        nx, ny = self.shape if self.shape is not None else (u.nx, u.ny)
        # MAIN-THREAD collective prologue: process 0 sizes the shared
        # staging file; the barrier orders it before any process writes.
        if multihost.process_index() == 0:
            _stage_file(tmp, nx, ny)
        multihost.barrier()
        t0 = time.perf_counter()
        blocks = snapshot_shards(u)
        timing = {"step": int(step), "snapshot_s": time.perf_counter() - t0}
        self.timings.append(timing)
        self._future = self._pool.submit(self._write_blocks, tmp, blocks,
                                         nx, ny, timing)
        self._pending = _PendingCommit(step=step, tmp=tmp, path=path,
                                       config=self.config,
                                       out_shape=(nx, ny))

    def _write_blocks(self, tmp, blocks, nx, ny, timing) -> None:
        t0 = time.perf_counter()
        timer = (self.registry.timer("resil_ckpt_async_write_s")
                 if self.registry is not None else contextlib.nullcontext())
        with timer:
            _write_local_blocks(blocks, tmp, nx, ny)
        timing["write_s"] = time.perf_counter() - t0

    # -- shared internals ---------------------------------------------- #

    def _finish_pending_locked(self) -> None:
        if self._future is not None:
            try:
                self._future.result()
            except BaseException:
                # The block write never finished: its staged file must
                # NOT be committed (a later flush/close would digest the
                # partial data into a "verified" sidecar). The previous
                # checkpoint stays the durable restart point.
                self._pending = None
                raise
            finally:
                self._future = None
        if self._pending is not None:
            p, self._pending = self._pending, None
            # MAIN-THREAD collective epilogue: every process's blocks are
            # on disk before process 0 promotes and indexes the pair.
            multihost.barrier()
            if multihost.process_index() == 0:
                commit_checkpoint_files(p.tmp, p.path, p.step, p.config,
                                        p.out_shape)
                if self.manager is not None:
                    self.manager.index(p.step)
                elif self.registry is not None:
                    self.registry.counter("resil_ckpt_saves_total")
            multihost.barrier()

    def _path_for(self, step: int) -> str:
        if self.manager is not None:
            return self.manager.path_for(step)
        return self.path

    def _gauge_pending(self) -> None:
        if self.registry is not None:
            pending = int(self._future is not None
                          or self._pending is not None)
            self.registry.gauge("resil_ckpt_pending", pending)
