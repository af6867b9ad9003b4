"""Residual trajectories and chunk progress out of the convergence
loops: the port's copy of ``heat2d_tpu/obs/stream.py``.

The port's loops already read each chunk's residual to the host to
decide the early exit (``models/engine.py``'s ``_read``, the ensembles'
``_all_done``), and report every read to the runner's ``tap``. A
``TelemetryStream`` given to the runner (``Runner.stream``) receives
those reads: ``tap(step, residual)`` from the solver's loops,
``tap_members(chunk, steps_done, residuals, done)`` from the ensembles'.
No read is added and no launch changes, so a run with the stream armed
gives the same grid, bit for bit, and the same launch counts as one
without it. Both taps dedupe (by step, by chunk): the timing protocol's
warmup run reports the same chunks as the timed run.
"""

from __future__ import annotations

from heat2d_tpu_torch.analysis.locks import AuditedLock
from heat2d_tpu_torch.obs.metrics import MetricsRegistry


def flush_taps() -> None:
    """Nothing to drain: the port's taps are synchronous host reads, made
    before the loop decides its next chunk, so a collector read after a
    run has every chunk already (the JAX package's asynchronous callbacks
    needed a barrier here)."""


def _floats(v) -> list:
    return [float(x) for x in (v.tolist() if hasattr(v, "tolist") else v)]


class TelemetryStream:
    """Host-side collector for the convergence loops' taps: ``tap`` is the
    scalar-residual hook, ``tap_members`` the ensemble hook with
    per-member vectors (tensors or sequences)."""

    def __init__(self, registry: MetricsRegistry | None = None):
        self._lock = AuditedLock("obs.stream")
        self._resid: dict = {}          # step -> residual
        self._chunks: dict = {}         # chunk index -> member snapshot
        self.registry = registry

    def tap(self, step, residual) -> None:
        k, r = int(step), float(residual)
        with self._lock:
            fresh = k not in self._resid
            if fresh:
                self._resid[k] = r
        if fresh and self.registry is not None:
            self.registry.series("residual", k, r)

    def tap_members(self, chunk, steps_done, residuals, done) -> None:
        c = int(chunk)
        snap = {
            "chunk": c,
            "steps_done": [int(s) for s in _floats(steps_done)],
            "residuals": _floats(residuals),
            "done": [bool(d) for d in _floats(done)],
        }
        with self._lock:
            fresh = c not in self._chunks
            if fresh:
                self._chunks[c] = snap
        if fresh and self.registry is not None:
            self.registry.event("ensemble_chunk", **snap)

    def trajectory(self) -> list:
        """Residual trajectory in step order:
        ``[{"step": k, "residual": r}, ...]``."""
        with self._lock:
            return [{"step": k, "residual": self._resid[k]}
                    for k in sorted(self._resid)]

    def residuals(self) -> list:
        """Just the residual values, in step order."""
        return [p["residual"] for p in self.trajectory()]

    def chunk_progress(self) -> list:
        """Ensemble chunk-progress snapshots in chunk order."""
        with self._lock:
            return [self._chunks[c] for c in sorted(self._chunks)]
