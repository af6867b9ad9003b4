"""Time-stepping loops: the port of ``heat2d_tpu/models/engine.py`` as
Python loops over tensors.

``steps_done`` matches the JAX engine exactly, schedule included: the
fused and chunked loops check only full INTERVAL chunks and run the
``steps % interval`` remainder unchecked; ``run_convergence`` checks its
final partial chunk too.

The residual is read to the host once per check, to decide the early
exit; every read is reported through ``tap(steps_done, residual)``, the
JAX engine's telemetry hook, so a caller counts the reads by counting
tap calls.

The fused and chunked loops read one chunk late. Once chunk c is
issued, its residual starts on its way to the host: a CUDA residual is
copied without blocking into one of two pinned slots, and an event is
recorded behind the copy. Chunk c + 1 is issued from chunk c's grid
while the cap allows it, and only then does the host wait, on chunk c's
event alone. So the card has the next chunk queued while the host reads
and decides. The decision is the synchronous loop's, on the same
residuals: the loop stops after the same chunk with the same grid, and
drops the speculative chunk unread (a chunk writes only new tensors, so
chunk c's grid is intact). The depth is one chunk on every route and
device; on the CPU it costs one discarded chunk where a run stops
before its cap. Each call adds its reads, those taken with the next
chunk already issued, and its discarded chunks to the process
registry's ``solver_residual_reads_total``, ``solver_reads_ahead_total``
and ``solver_chunks_discarded_total``.

The comparison with ``sensitivity`` is made in float32, as the JAX loop
makes it (an f32 residual against a weakly typed Python float).

Each read's wait is the hook ``solver.residual_read``
(``utils.profiling.phase``): the host blocks there until the chunk that
produced the residual is done.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from heat2d_tpu_torch.obs.metrics import get_registry
from heat2d_tpu_torch.utils.profiling import phase


def _read(res, k: int, tap: Optional[Callable]) -> float:
    """One host read of the residual (exact f32 value as a float).
    ``res`` is a tensor, a number, or a ``_Reads.start`` ticket, whose
    read waits on its own chunk alone."""
    with phase("solver.residual_read"):
        if isinstance(res, tuple):
            slot, copied = res
            copied.synchronize()
            res = slot
        r = float(res)
    if tap is not None:
        tap(k, r)
    return r


class _Reads:
    """The residual reads of one call of the pipelined loop.
    ``start(r)`` begins a read without waiting: a CUDA residual is copied
    into the next of two pinned slots (made at the first read and used in
    turn, so the next chunk's copy never overwrites a value not yet read),
    and an event is recorded behind the copy on the stream the copy took,
    its device's current stream (looked up at the first read); the
    ``(slot, event)`` ticket goes to ``_read``. Any other residual is
    computed already and is taken as a float at once."""

    def __init__(self):
        self._slots = None
        self._stream = None
        self._turn = 0

    def start(self, r):
        if not (isinstance(r, torch.Tensor) and r.is_cuda):
            return float(r)
        if self._slots is None:
            self._stream = torch.cuda.current_stream(r.device)
            with torch.cuda.device(r.device):
                self._slots = [(torch.empty(r.shape, dtype=r.dtype,
                                            pin_memory=True),
                                torch.cuda.Event()) for _ in range(2)]
        slot, copied = self._slots[self._turn]
        self._turn ^= 1
        slot.copy_(r, non_blocking=True)
        copied.record(self._stream)
        return slot, copied


def _going(res: float, sensitivity: float) -> bool:
    """The loops' continue test, ``res >= sensitivity`` in f32 (False
    for a NaN residual, as in the JAX loop)."""
    return bool(np.float32(res) >= np.float32(sensitivity))


def _converged(res: float, sensitivity: float) -> bool:
    return bool(np.float32(res) < np.float32(sensitivity))


def run_fixed(step_fn: Callable, u0, steps: int):
    """Run exactly ``steps`` steps. Returns (u_final, steps_done)."""
    u = u0
    for _ in range(steps):
        u = step_fn(u)
    return u, steps


def run_fixed_stacked(step_fn: Callable, u0, steps: int):
    """Run exactly ``steps`` steps of an (nx, ny) state, also returning the
    state before each step: ``states[t]`` is the input of step t
    (``states[0]`` equals u0), so a reverse sweep can linearize every step
    where it was taken. The trajectory store of the full-storage adjoint
    and the per-segment recompute of the checkpointed one
    (``diff/adjoint.py``): O(steps) memory, one ``(steps, nx, ny)`` tensor
    allocated up front and filled in place. Returns (u_final, states)."""
    states = u0.new_empty((steps,) + tuple(u0.shape))
    u = u0
    for t in range(steps):
        states[t] = u
        u = step_fn(u)
    return u, states


def run_convergence(step_fn: Callable, residual_fn: Callable, u0,
                    steps: int, interval: int, sensitivity: float,
                    tap: Optional[Callable] = None):
    """Run up to ``steps`` steps, checking the residual of the last step
    pair every ``interval`` steps (and after a final partial chunk), and
    stop once it falls below ``sensitivity``. Returns (u, steps_done)."""
    interval = min(interval, steps) if steps else interval
    u_prev, u, k = u0, u0, 0
    res = float("inf")
    while k < steps and _going(res, sensitivity):
        n = min(interval, steps - k)
        for _ in range(n):
            u_prev, u = u, step_fn(u)
        k += n
        res = _read(residual_fn(u, u_prev), k, tap)
    return u, k


def run_convergence_fused(chunk_resid_fn, multi_step_fn, u0,
                          steps: int, interval: int, sensitivity: float,
                          tap: Optional[Callable] = None):
    """Convergence loop for engines whose multi-step primitive emits the
    residual itself: ``chunk_resid_fn(u, n) -> (u, residual)`` advances n
    steps and returns the residual of the final step pair. Full INTERVAL
    chunks are checked, each read one chunk late (the module docstring);
    the ``steps % interval`` remainder runs unchecked unless the run has
    converged."""
    if steps:
        interval = max(1, min(interval, steps))
    n_chunks = steps // interval if interval else 0
    remainder = steps - n_chunks * interval
    reads = _Reads()

    def issue(u):
        u, r = chunk_resid_fn(u, interval)
        return u, reads.start(r)

    u, c, ahead, discarded = u0, 0, 0, 0
    res = float("inf")
    nxt = issue(u0) if n_chunks else None
    while nxt is not None:
        (u, pending), c = nxt, c + 1
        nxt = issue(u) if c < n_chunks else None
        ahead += nxt is not None
        res = _read(pending, c * interval, tap)
        if not _going(res, sensitivity):
            discarded = int(nxt is not None)
            break
    del nxt  # the dropped chunk's grid, freed before the remainder
    if c:
        reg = get_registry()
        reg.counter("solver_residual_reads_total", c)
        reg.counter("solver_reads_ahead_total", ahead)
        reg.counter("solver_chunks_discarded_total", discarded)
    k = c * interval
    if remainder and not _converged(res, sensitivity):
        u = multi_step_fn(u, remainder)
        k += remainder
    return u, k


def run_convergence_chunked(multi_step_fn, step_fn, residual_fn, u0,
                            steps: int, interval: int, sensitivity: float,
                            tap: Optional[Callable] = None):
    """``run_convergence_fused`` for engines with a multi-step primitive
    and no fused residual: each full chunk is ``interval - 1`` fused
    steps plus one tracked step for the residual pair."""
    def chunk_resid(u, n):
        u_prev = multi_step_fn(u, n - 1)
        u_new = step_fn(u_prev)
        return u_new, residual_fn(u_new, u_prev)

    return run_convergence_fused(chunk_resid, multi_step_fn, u0,
                                 steps, interval, sensitivity, tap=tap)


class Runner:
    """``u0 -> (u_final, steps_done)`` for one config: the route it takes,
    and the host reads of the residual its last call made (its ``tap``
    counts them, whatever they report; pass it to the convergence
    loops). ``stream``, when set, receives every read too (a
    ``obs.stream.TelemetryStream``'s ``tap`` or ``tap_members``): the
    reads are the loops' own, so arming it adds no launch."""

    def __init__(self, fn, route: str):
        self._fn = fn
        self.route = route
        self.residual_reads = 0
        self.stream = None

    def tap(self, *args) -> None:
        self.residual_reads += 1
        if self.stream is not None:
            self.stream(*args)

    def __call__(self, u):
        self.residual_reads = 0
        return self._fn(u)
