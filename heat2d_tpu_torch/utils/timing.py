"""Timing protocol, like for like with the reference and the JAX
package (``heat2d_tpu/utils/timing.py``).

Barrier, clock, run, fence, clock: setup is excluded by warming up the
runner by *executing* it once first (on the card that first run also
builds the CUDA kernels and loads them), and its wall-clock is kept as
``warmup_s``. The fence is ``torch.cuda.synchronize(d)`` on every card
the outputs span (the shards of a mesh may lie on several) plus a 4-byte
read back from every output tensor: the read cannot complete before the
kernels that produce it have.

In a multi-process world the clock starts after a barrier, and the
elapsed time is the slowest process's (``max_over_processes``, the
reference's MPI_Reduce(MPI_MAX), grad1612_mpi_heat.c:277-280). The
cross-process halo route's totals (``parallel.halo.CROSS_PROCESS``) are
read over the timed run alone, so they leave the warmup out as the
clock does.
"""

from __future__ import annotations

import time

import torch


def gather_over_processes(value: float) -> list:
    """Every process's value of a host scalar, in process order (one
    value alone)."""
    from heat2d_tpu_torch.parallel import multihost
    if not multihost.is_multiprocess():
        return [float(value)]
    got = multihost.all_gather_rows(
        torch.tensor([float(value)], dtype=torch.float64),
        [1] * multihost.process_count())
    return [float(g[0]) for g in got]


def max_over_processes(value: float) -> float:
    """Cluster-max of a host scalar: the MPI_Reduce(MPI_MAX) analogue."""
    return max(gather_over_processes(value))


class Stopwatch:
    """Fenced wall-clock span (the caller fences inside it)."""

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        return False


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        for t in tree:
            yield from _leaves(t)
    elif isinstance(tree, torch.Tensor):
        yield tree
    elif hasattr(tree, "tensors"):          # a ShardedGrid
        yield from tree.tensors()


def _fence(tree) -> None:
    """Hard completion fence over every tensor in ``tree``."""
    leaves = list(_leaves(tree))
    for dev in {t.device for t in leaves if t.is_cuda}:
        torch.cuda.synchronize(dev)
    for t in leaves:
        if t.numel():
            t.reshape(-1)[:1].cpu()


class TimedCall(tuple):
    """``(outputs, elapsed_seconds)``, with the setup cost the timed span
    excludes carried as ``warmup_s`` (None when the warmup was skipped)."""

    warmup_s: float | None = None
    #: every process's own elapsed seconds in a multi-process world
    elapsed_by_process: list | None = None
    #: this process's cross-process halo totals over the timed run
    #: (``parallel.halo.CROSS_PROCESS``'s change); None in one process
    exchange: dict | None = None

    @property
    def out(self):
        return self[0]

    @property
    def elapsed(self) -> float:
        return self[1]


def timed_call(fn, *args, warmup: bool = True):
    """Run ``fn(*args)`` under the reference's timing protocol; returns a
    ``TimedCall`` whose elapsed time is the slowest process's."""
    from heat2d_tpu_torch.parallel import multihost
    from heat2d_tpu_torch.parallel.halo import cross_process_counts
    warmup_s = None
    if warmup:
        w0 = time.perf_counter()
        _fence(fn(*args))
        warmup_s = time.perf_counter() - w0
    _fence(args)
    multihost.barrier()
    ex0 = cross_process_counts()
    t0 = time.perf_counter()
    out = fn(*args)
    _fence(out)
    elapsed = time.perf_counter() - t0
    ex1 = cross_process_counts()
    by_process = gather_over_processes(elapsed)
    result = TimedCall((out, max(by_process)))
    result.warmup_s = warmup_s
    if multihost.is_multiprocess():
        result.elapsed_by_process = by_process
        result.exchange = {k: ex1[k] - ex0[k] for k in ex1}
    return result
