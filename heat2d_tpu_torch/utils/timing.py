"""Timing protocol, like for like with the reference and the JAX
package (``heat2d_tpu/utils/timing.py``).

Barrier, clock, run, fence, clock: setup is excluded by warming up the
runner by *executing* it once first (on the card that first run also
builds the CUDA kernels and loads them), and its wall-clock is kept as
``warmup_s``. The fence is ``torch.cuda.synchronize(d)`` on every card
the outputs span (the shards of a mesh may lie on several) plus a 4-byte
read back from every output tensor: the read cannot complete before the
kernels that produce it have.
"""

from __future__ import annotations

import time

import torch


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

    @property
    def out(self):
        return self[0]

    @property
    def elapsed(self) -> float:
        return self[1]


def timed_call(fn, *args, warmup: bool = True):
    """Run ``fn(*args)`` under the reference's timing protocol; returns a
    ``TimedCall``."""
    warmup_s = None
    if warmup:
        w0 = time.perf_counter()
        _fence(fn(*args))
        warmup_s = time.perf_counter() - w0
    _fence(args)
    t0 = time.perf_counter()
    out = fn(*args)
    _fence(out)
    elapsed = time.perf_counter() - t0
    result = TimedCall((out, elapsed))
    result.warmup_s = warmup_s
    return result
