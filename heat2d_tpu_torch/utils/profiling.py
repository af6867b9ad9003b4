"""Profiler hooks: the mpiP analogue on ``torch.profiler`` (the port's
counterpart of ``heat2d_tpu/utils/profiling.py``).

``profile_span(LOGDIR)`` captures the enclosed span (the solver CLI's
``--profile`` wraps the whole timed run in it, warmup included; the
timed window inside is fenced as without it) and writes the Chrome trace
into LOGDIR, which ``heat2d-tpu-torch-prof LOGDIR`` digests per hand
kernel and per idle gap, and ui.perfetto.dev shows.

``phase(name, parent=None, **attrs)`` is the one hook of the hot paths.
The kernel loops use the names the JAX package gives its phases
(``stencil_chunk``, ``residual_reduction``, ``halo_exchange``, ...), so
that a trace of either stack attributes time to the same spans; the
solver and the server name their host steps (``solve.*``,
``solver.residual_read``, ``serve.*``; docs/OBSERVABILITY.md lists
them).

- **Off** (no profiler records and tracing is not armed): ``phase``
  checks the profiler's module flag and the tracer's and returns a
  shared no-op context. It reads no clock and builds no
  ``record_function``.
- **On**: a ``record_function`` range while a profiler records; the
  span ``name`` (kind ``phase``) while tracing is armed
  (``obs/tracing.py``), under ``parent`` or else the thread's ambient
  context, and that span is the thread's ambient context until it
  closes (a thread with neither, such as the server's scheduler between
  dispatches, emits no span). While either holds, each entry adds one to
  ``trace_spans_total{span=name}`` and its host seconds to
  ``trace_span_seconds_total{span=name}`` in the process registry
  (``obs.get_registry()``): the benchmark's per-layer readers read
  these.
- **One clock**: the span's stamps are the hook's own
  ``time.monotonic()`` reads, written on the profiler's timeline (epoch
  seconds; ``obs/tracing.py``), so a span and the range of the same
  entry agree to well under a millisecond in a Chrome trace.

``stages(first)`` is the same hook for consecutive steps of one call
that share their boundaries (the serving engine's launch): one clock
read a boundary, kept in ``stages.stamps`` for the caller's own
accounting.

    heat2d-tpu-torch --profile /tmp/prof --mode pallas --nxprob 4096 \\
        --nyprob 4096 --steps 240
    heat2d-tpu-torch-prof /tmp/prof
"""

from __future__ import annotations

import contextlib
import os
import socket
import time

import torch
import torch.autograd.profiler as _autograd_profiler

from heat2d_tpu_torch.obs import tracing
from heat2d_tpu_torch.obs.metrics import get_registry


class EmptyCaptureError(RuntimeError):
    """A capture of a run on the card recorded no CUDA kernel (CUPTI did
    not start, or the span launched nothing): a digest of it would show a
    card that did nothing, so none is written."""


@contextlib.contextmanager
def profile_span(logdir: str | None, device=None):
    """Capture the enclosed span with ``torch.profiler`` into ``logdir``
    (no-op when it is None): CPU activity, and CUDA activity when
    ``device`` is a card (default: a card when one is visible). The trace
    goes to ``<logdir>/<host>_<pid>.<ns>.pt.trace.json`` when the span
    ends. A CUDA capture that holds no kernel event raises
    ``EmptyCaptureError`` (the file stays, for inspection)."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    from heat2d_tpu_torch.obs.trace_report import has_kernel_events

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    on_card = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU]
    if on_card:
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"{socket.gethostname()}_{os.getpid()}."
                                f"{time.time_ns()}.pt.trace.json")
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(path)
    if on_card and not has_kernel_events(path):
        raise EmptyCaptureError(
            f"profile_span: the capture of a run on {device} holds no "
            f"CUDA kernel event ({path}); the profiler recorded host "
            f"events only (is CUPTI available?)")


class _Off:
    """The hook's off path: one shared context that does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _on() -> bool:
    """A profiler records, or tracing is armed (or not yet looked up in
    the environment): the hook's one check."""
    return (_autograd_profiler._is_profiler_enabled or tracing._enabled
            or not tracing._env_checked)


def _open(name: str, parent, attrs: dict, t0=None):
    """Open one entry of the hook: the range, the span, the ambient
    context. Returns its state, or None when nothing records."""
    profiling = _autograd_profiler._is_profiler_enabled
    armed = tracing.enabled()
    if not (profiling or armed):
        return None
    rng = span = prev = None
    if t0 is None:
        t0 = time.monotonic()
    if profiling:
        rng = torch.profiler.record_function(name)
        rng.__enter__()
    if armed:
        ctx = parent if parent is not None else tracing.ambient()
        if ctx is not None:
            span = tracing.begin(name, kind="phase", parent=ctx, t0=t0,
                                 **attrs)
            prev = tracing.ambient()
            tracing.set_ambient(span.ctx)
    return (name, t0, rng, span, prev)


def _close(state, t1=None) -> None:
    name, t0, rng, span, prev = state
    if t1 is None:
        t1 = time.monotonic()
    # the range closes before the span's record is written, so that
    # both end at the stamp
    if rng is not None:
        rng.__exit__(None, None, None)
    if span is not None:
        tracing.set_ambient(prev)
        span.end(t1=t1)
    reg = get_registry()
    reg.counter("trace_spans_total", span=name)
    reg.counter("trace_span_seconds_total", t1 - t0, span=name)


class _Phase:
    __slots__ = ("name", "parent", "attrs", "_state")

    def __init__(self, name: str, parent, attrs: dict):
        self.name = name
        self.parent = parent
        self.attrs = attrs

    def __enter__(self):
        self._state = _open(self.name, self.parent, self.attrs)
        return None

    def __exit__(self, *exc):
        if self._state is not None:
            _close(self._state)
        return False


def phase(name: str, parent=None, **attrs):
    """The hot paths' hook (see the module docstring): a context that
    marks ``name`` in the profiler's timeline and the trace, and counts
    it, while either records; a shared no-op otherwise. ``parent`` (a
    ``tracing.TraceContext``) places the span where the thread has no
    ambient context; ``attrs`` ride the span."""
    return _Phase(name, parent, attrs) if _on() else _OFF


class stages:
    """Consecutive entries of the hook on one thread that share their
    boundaries: ``next(name)`` closes the open one and opens ``name`` at
    one clock read. The boundaries are read whether or not anything
    records, and kept in ``stamps`` (``time.monotonic()`` seconds; the
    first at entry, the last at exit), for a caller that accounts its own
    durations with them: the serving engine's launch row.

        with stages("serve.engine.prepare") as st:
            ...
            st.next("serve.engine.run")
            ...
        prepare_s = st.stamps[1] - st.stamps[0]
    """

    __slots__ = ("stamps", "_first", "_state")

    def __init__(self, first: str):
        self._first = first

    def __enter__(self) -> "stages":
        t = time.monotonic()
        self.stamps = [t]
        self._state = _open(self._first, None, {}, t) if _on() else None
        return self

    def next(self, name: str) -> None:
        t = time.monotonic()
        self.stamps.append(t)
        if self._state is not None:
            _close(self._state, t)
        self._state = _open(name, None, {}, t) if _on() else None

    def __exit__(self, *exc):
        t = time.monotonic()
        self.stamps.append(t)
        if self._state is not None:
            _close(self._state, t)
        return False
