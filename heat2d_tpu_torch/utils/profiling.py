"""Profiler hooks: the mpiP analogue on ``torch.profiler`` (the port's
counterpart of ``heat2d_tpu/utils/profiling.py``).

``profile_span(LOGDIR)`` captures the enclosed span (the solver CLI's
``--profile`` wraps the whole timed run in it, warmup included; the
timed window inside is fenced as without it) and writes the Chrome trace
into LOGDIR, which ``heat2d-tpu-torch-prof LOGDIR`` digests per hand
kernel and per idle gap, and ui.perfetto.dev shows. ``annotate(name)``
marks a named range in it; ``phase(name)`` is the hot paths' range, with
the names the JAX package gives its phases (``stencil_chunk``,
``residual_reduction``, ``halo_exchange``, ...), so that a trace of
either stack attributes time to the same spans.

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


@contextlib.contextmanager
def annotate(name: str):
    """A named range in the profiler's timeline (``record_function``:
    next to nothing when no profiler is recording)."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def phase(name: str):
    """A hot path's named range (``annotate``). When distributed tracing
    is armed (``obs/tracing.py``), each entry also emits a host span
    ``phase.<name>`` under the thread's ambient context (the CLI's run
    root): host bookkeeping only, the launches are the same either way.
    A thread with no ambient context (a server's scheduler thread, whose
    requests carry their own launch spans) emits none: each launch would
    otherwise open a trace of its own. (The JAX package's phases run at
    trace time, once per program; the port's run at every launch.)"""
    from heat2d_tpu_torch.obs import tracing

    parent = tracing.ambient() if tracing.enabled() else None
    span = (tracing.begin("phase." + name, kind="phase", parent=parent)
            if parent is not None else tracing.NULL_SPAN)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        span.end()
