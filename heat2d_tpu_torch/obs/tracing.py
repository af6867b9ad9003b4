"""Distributed request tracing: Dapper-style spans with causality across
processes. The port's copy of ``heat2d_tpu/obs/tracing.py``, with its
schema, span-file names and record keys, so that either package's merger
(``heat2d-tpu-trace``, ``heat2d-tpu-torch-trace``) reads either's files.

A ``TraceContext`` (``trace_id``/``span_id``) is minted at request
admission and rides through the serving stack: the batcher's queue
(``serve.queue``), the launch (``serve.launch``, one per member), and the
solver CLI's run (``cli.run``, with ``phase.<name>`` spans under it).
``obs/trace_cli.py`` merges the per-process span files into one timeline
and a per-request critical path.

**Free when off.** Every hook site checks ``tracing.enabled()`` (one
module-level bool) first; spans are host bookkeeping and never touch a
tensor or a launch, so a traced run gives the same grid, bit for bit, and
the same launch counts as an untraced one (``tests/test_torch_
tracing.py``). Activation is opt-in: ``install(Tracer(...))`` or
``HEAT2D_TRACE_DIR`` in the environment (the JAX package's name).

Span records are one JSON object per line in
``<dir>/spans-<service>-<pid>.jsonl``::

    {"event": "span", "schema": ..., "service": "serve", "pid": 123,
     "trace_id": "4bf9...", "span_id": "00f3...", "parent_id": "...",
     "name": "serve.launch", "kind": "launch", "t0": ..., "t1": ...,
     "attrs": {"signature": "...", "first_launch": true}}

``t0``/``t1`` are epoch seconds from one per-process monotonic->epoch
anchor. Every span is also teed into the flight recorder's ring
(``obs/flight.py``) when one is installed. The writer takes the tracer's
lock around each line (spans are emitted from the submitting threads and
the batcher's scheduler thread alike).
"""

from __future__ import annotations

import dataclasses
import json
import os
import secrets
import threading
import time
from typing import Optional

from heat2d_tpu_torch.analysis.locks import AuditedLock, guarded_by

TRACE_SCHEMA = "heat2d-tpu/trace-span/v1"

#: span kinds the critical-path breakdown buckets by
#: (obs/trace_cli.py); "internal" is everything else.
SPAN_KINDS = ("request", "queue", "launch", "wire", "replay", "phase",
              "event", "internal")


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """One node of a request's causal tree: the globally-unique
    ``trace_id`` names the request, ``span_id`` names this operation.
    Plain data: it crosses a wire as two hex strings."""

    trace_id: str
    span_id: str

    def to_wire(self) -> dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    @classmethod
    def from_wire(cls, d) -> Optional["TraceContext"]:
        """A context from a wire dict, or None for anything malformed: a
        trace-less line parses as 'no trace', never as an error."""
        if not isinstance(d, dict):
            return None
        tid, sid = d.get("trace_id"), d.get("span_id")
        if not (isinstance(tid, str) and isinstance(sid, str)
                and tid and sid):
            return None
        return cls(trace_id=tid, span_id=sid)


def _new_trace_id() -> str:
    return secrets.token_hex(16)


def _new_span_id() -> str:
    return secrets.token_hex(8)


class Span:
    """One in-progress operation. Created by ``Tracer.begin``; ``end()``
    stamps the close time and emits the record. Spans may be ended from
    another thread than they began on (a request span begins on the
    submitting thread and ends where its future resolves): the tracer's
    emit path is thread-safe and ``end()`` is idempotent."""

    __slots__ = ("tracer", "name", "kind", "ctx", "parent_id", "t0",
                 "attrs", "_done")

    def __init__(self, tracer: "Tracer", name: str, kind: str,
                 ctx: TraceContext, parent_id: Optional[str],
                 t0: float, attrs: dict):
        self.tracer = tracer
        self.name = name
        self.kind = kind
        self.ctx = ctx
        self.parent_id = parent_id
        self.t0 = t0
        self.attrs = attrs
        self._done = False

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def end(self, **attrs) -> None:
        """Close the span (idempotent — a future's done-callback may
        race a failure path; first close wins)."""
        if self._done:
            return
        self._done = True
        if attrs:
            self.attrs.update(attrs)
        self.tracer._emit(self, time.monotonic())


class _NullSpan:
    """The disabled-path stand-in: every method a no-op, ``ctx`` is
    None, so hook sites can run unconditionally after one enabled()
    check."""

    ctx = None
    attrs: dict = {}

    def set(self, **attrs):
        return self

    def end(self, **attrs):
        pass


NULL_SPAN = _NullSpan()


@guarded_by("_lock", "_file")
class Tracer:
    """Per-process span sink. ``dir`` is the shared trace directory
    (one file per process inside it); ``sink`` (a callable taking the
    record dict) replaces the file for in-process tests. ``service``
    names this process's lane in the merged timeline ("router",
    "worker0", "cli")."""

    def __init__(self, dir: Optional[str] = None, *,
                 service: str = "main", sink=None):
        if dir is None and sink is None:
            raise ValueError("Tracer needs a dir or a sink")
        self.dir = dir
        self.service = service
        self.sink = sink
        self.pid = os.getpid()
        # ONE monotonic->epoch anchor per tracer: every span timestamp
        # is epoch0 + (mono - mono0), so in-process intervals are
        # monotonic-exact and never jump with wall-clock adjustments.
        self._epoch0 = time.time()
        self._mono0 = time.monotonic()
        self._lock = AuditedLock("obs.tracer")
        self._file = None
        self.path = (None if dir is None else os.path.join(
            dir, f"spans-{service}-{self.pid}.jsonl"))
        self.spans_emitted = 0

    # -- time ---------------------------------------------------------- #

    def epoch_of(self, mono: float) -> float:
        """Epoch seconds for a ``time.monotonic()`` stamp (how
        retroactive spans — queue waits recorded at dispatch — get
        consistent timestamps)."""
        return self._epoch0 + (mono - self._mono0)

    # -- span lifecycle ------------------------------------------------ #

    def mint(self, parent: Optional[TraceContext] = None) -> TraceContext:
        """A fresh context: same trace as ``parent`` (new span id), or
        a brand-new trace when there is no parent — request admission
        mints the root here."""
        return TraceContext(
            trace_id=parent.trace_id if parent else _new_trace_id(),
            span_id=_new_span_id())

    def begin(self, name: str, *, kind: str = "internal",
              parent: Optional[TraceContext] = None, **attrs) -> Span:
        ctx = self.mint(parent)
        sp = Span(self, name, kind, ctx,
                  parent.span_id if parent else None,
                  time.monotonic(), dict(attrs))
        # A span_start record the moment the span opens: a process
        # killed mid-span (the chaos scenario this subsystem exists
        # for) still leaves its open spans in the file/ring, so the
        # merged trace stays CONNECTED — the reader synthesizes an
        # "unfinished" span for any start without a matching end.
        self._write({
            "event": "span_start", "schema": TRACE_SCHEMA,
            "service": self.service, "pid": self.pid,
            "trace_id": ctx.trace_id, "span_id": ctx.span_id,
            "parent_id": sp.parent_id, "name": name, "kind": kind,
            "t0": self.epoch_of(sp.t0), "attrs": dict(sp.attrs),
        })
        return sp

    def emit_span(self, name: str, t0_mono: float, t1_mono: float, *,
                  kind: str = "internal",
                  parent: Optional[TraceContext] = None,
                  **attrs) -> TraceContext:
        """A retroactively-timed, already-finished span (e.g. the
        queue wait, known only at dispatch). Returns its context."""
        sp = Span(self, name, kind, self.mint(parent),
                  parent.span_id if parent else None, t0_mono,
                  dict(attrs))
        sp._done = True
        self._emit(sp, t1_mono)
        return sp.ctx

    def event(self, name: str, *, parent: Optional[TraceContext] = None,
              **attrs) -> TraceContext:
        """An instantaneous marker span (kind="event") — e.g. a wire
        line's receipt, a failover replay decision."""
        now = time.monotonic()
        return self.emit_span(name, now, now, kind="event",
                              parent=parent, **attrs)

    # -- emission ------------------------------------------------------ #

    def _emit(self, span: Span, t1_mono: float) -> None:
        rec = {
            "event": "span", "schema": TRACE_SCHEMA,
            "service": self.service, "pid": self.pid,
            "trace_id": span.ctx.trace_id, "span_id": span.ctx.span_id,
            "parent_id": span.parent_id,
            "name": span.name, "kind": span.kind,
            "t0": self.epoch_of(span.t0),
            "t1": self.epoch_of(t1_mono),
            "attrs": span.attrs,
        }
        self.spans_emitted += 1
        self._write(rec)

    def _write(self, rec: dict) -> None:
        from heat2d_tpu_torch.obs import flight
        flight.note_span(rec)
        if _span_taps:
            # live consumers (obs.perf.DutyCycleSampler): a tap must
            # never take the emitting path down, and an empty tap list
            # costs one truthiness check
            for tap in tuple(_span_taps):
                try:
                    tap(rec)
                except Exception:  # noqa: BLE001
                    pass
        with self._lock:
            if self.sink is not None:
                self.sink(rec)
                return
            try:
                if self._file is None:
                    os.makedirs(self.dir, exist_ok=True)
                    self._file = open(self.path, "a")
                # one line per record, flushed: a killed process's file
                # is complete up to the kill (torn-line tolerant
                # readers skip at most the final line)
                self._file.write(json.dumps(rec) + "\n")
                self._file.flush()
            except OSError:
                pass    # tracing must never take the serving path down

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None


# -- the process-global tracer (the install/env pattern) ---------------- #

_lock = AuditedLock("obs.tracing")
_tracer: Optional[Tracer] = None
_enabled = False        # fast-path guard: False == all hooks no-op
_env_checked = False
#: live span consumers teed from Tracer._write (obs.perf duty-cycle
#: sampling). Module-level so taps survive tracer swaps; empty ==
#: zero-cost.
_span_taps: list = []

ENV_DIR = "HEAT2D_TRACE_DIR"


def add_span_tap(fn) -> None:
    """Tee every emitted span record to ``fn(rec)`` (host-side, called
    on the emitting thread). Exceptions from taps are swallowed."""
    with _lock:
        if fn not in _span_taps:
            _span_taps.append(fn)


def remove_span_tap(fn) -> None:
    with _lock:
        if fn in _span_taps:
            _span_taps.remove(fn)


def install(tracer: Optional[Tracer]) -> None:
    """Activate a tracer programmatically; ``None`` disarms. A tracer
    being replaced is closed (its span file handle released)."""
    global _tracer, _enabled, _env_checked
    with _lock:
        if _tracer is not None and _tracer is not tracer:
            _tracer.close()
        _env_checked = True
        _tracer, _enabled = tracer, tracer is not None


def uninstall() -> None:
    """Disarm and forget; the environment is re-read on next use
    (fresh processes pick their campaign up from ``HEAT2D_TRACE_DIR``)."""
    global _tracer, _enabled, _env_checked
    with _lock:
        if _tracer is not None:
            _tracer.close()
        _tracer, _enabled, _env_checked = None, False, False


def activate_from_env(service: str = "main") -> Optional[Tracer]:
    """Install a tracer iff ``HEAT2D_TRACE_DIR`` is set (how worker
    subprocesses join the router's campaign — the supervisor passes
    the environment through). Idempotent: an already-installed tracer
    wins."""
    global _tracer, _enabled, _env_checked
    with _lock:
        if _tracer is not None:
            return _tracer
        d = os.environ.get(ENV_DIR)
        if d:
            _tracer = Tracer(d, service=service)
            _enabled = True
        _env_checked = True
        return _tracer


def tracer() -> Optional[Tracer]:
    """The active tracer, consulting the environment on first use."""
    if not _env_checked:
        activate_from_env()
    return _tracer


def enabled() -> bool:
    if not _env_checked:
        activate_from_env()
    return _enabled


# -- ambient context (thread-local) ------------------------------------ #

_ambient = threading.local()


def set_ambient(ctx: Optional[TraceContext]) -> None:
    """Set THIS thread's ambient parent context: what free-floating
    spans (``phase()`` entries) attach to when nothing explicit is in
    scope. The CLI's run root sets it; server paths never do (their
    parents are always explicit)."""
    _ambient.ctx = ctx


def ambient() -> Optional[TraceContext]:
    return getattr(_ambient, "ctx", None)


# -- hook-site conveniences (cheap no-ops when off) -------------------- #

def begin(name: str, *, kind: str = "internal",
          parent: Optional[TraceContext] = None, **attrs):
    """A live span, or ``NULL_SPAN`` when tracing is off — hook sites
    call ``.end()`` unconditionally."""
    t = tracer() if _enabled or not _env_checked else None
    if t is None:
        return NULL_SPAN
    return t.begin(name, kind=kind, parent=parent, **attrs)


def emit(name: str, t0_mono: float, t1_mono: float, *,
         kind: str = "internal", parent: Optional[TraceContext] = None,
         **attrs) -> Optional[TraceContext]:
    t = tracer() if _enabled or not _env_checked else None
    if t is None:
        return None
    return t.emit_span(name, t0_mono, t1_mono, kind=kind,
                       parent=parent, **attrs)


def event(name: str, *, parent: Optional[TraceContext] = None,
          **attrs) -> Optional[TraceContext]:
    t = tracer() if _enabled or not _env_checked else None
    if t is None:
        return None
    return t.event(name, parent=parent, **attrs)
