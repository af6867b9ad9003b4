"""Profiler hooks: named phases in a ``torch.profiler`` trace.

``phase("stencil_chunk")`` and ``phase("residual_reduction")`` keep the
names the JAX package gives its phases (``heat2d_tpu/utils/profiling.py``),
so a trace of either stack attributes time to the same spans.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def phase(name: str):
    """A named range in the profiler's timeline (metadata only; it costs
    next to nothing when no profiler is recording)."""
    with torch.profiler.record_function(name):
        yield
