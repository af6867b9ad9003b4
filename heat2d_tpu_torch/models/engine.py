"""Time-stepping loops: the port of ``heat2d_tpu/models/engine.py`` as
Python loops over tensors.

``steps_done`` matches the JAX engine exactly, schedule included: the
fused and chunked loops check only full INTERVAL chunks and run the
``steps % interval`` remainder unchecked; ``run_convergence`` checks its
final partial chunk too.

The residual is read to the host once per check, to decide the early
exit; every read is reported through ``tap(steps_done, residual)``, the
JAX engine's telemetry hook, so a caller counts the reads by counting
tap calls. Keeping the flag on the device (a CUDA graph or a device-side
flag) is later work (ROADMAP.md).

The comparison with ``sensitivity`` is made in float32, as the JAX loop
makes it (an f32 residual against a weakly typed Python float).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np


def _read(res, k: int, tap: Optional[Callable]) -> float:
    """One host read of the residual (exact f32 value as a float)."""
    r = float(res)
    if tap is not None:
        tap(k, r)
    return r


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
    chunks are checked; the ``steps % interval`` remainder runs
    unchecked unless the run has converged."""
    if steps:
        interval = max(1, min(interval, steps))
    n_chunks = steps // interval if interval else 0
    remainder = steps - n_chunks * interval
    u, c = u0, 0
    res = float("inf")
    while c < n_chunks and _going(res, sensitivity):
        u, r = chunk_resid_fn(u, interval)
        c += 1
        res = _read(r, c * interval, tap)
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
