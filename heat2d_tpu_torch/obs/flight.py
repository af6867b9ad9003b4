"""Crash flight recorder: a bounded black box for post-mortems. The
port's copy of ``heat2d_tpu/obs/flight.py``, with its schema, file names
and digest sidecar, so that either package's ``load_postmortem`` verifies
either's files.

A bounded in-memory ring of the most recent spans and structured events
(plus a final metrics snapshot) flushes to a digest-sidecar'd JSONL file
when the process dies violently: on SIGTERM and on an unhandled exception
(main or any thread). A post-mortem reconstructs the process's last
seconds: which requests were in flight, what the registry counted. (The
JAX package also flushes at its chaos kill points; the port's
``resil/chaos.py`` has no hard-kill points yet.)

The ring is host-side and bounded (``deque(maxlen=ring)``), and recording
into it is a locked append. Like every obs hook it is opt-in
(``install(...)`` or ``HEAT2D_FLIGHT_DIR`` in the environment) and free
when off: the tracer's tee (``note_span``) checks one module-level flag.

Flush format (``flight-<service>-<pid>.jsonl``): a ``flight_header``
line (schema, reason, service, pid, timestamps), the ring's entries
oldest-first, then a ``metrics_snapshot`` line when a registry was
attached. The sidecar (``<path>.digest.json``) carries the file's
sha256 and line count, so ``load_postmortem`` can prove the post-mortem
is complete and untorn."""

from __future__ import annotations

import collections
import hashlib
import json
import os
import signal
import sys
import threading
import time
from typing import Optional

from heat2d_tpu_torch.analysis.locks import AuditedLock, guarded_by

FLIGHT_SCHEMA = "heat2d-tpu/flight-recorder/v1"

ENV_DIR = "HEAT2D_FLIGHT_DIR"
ENV_RING = "HEAT2D_FLIGHT_RING"

DEFAULT_RING = 2048


class PostmortemCorruptError(ValueError):
    """A flight-recorder file failed its integrity checks (sidecar
    sha256 mismatch, truncation, missing sidecar) — a torn flush, not
    a trustworthy post-mortem."""


@guarded_by("_lock", "_ring", "_flushed")
class FlightRecorder:
    """The ring + its flush. One per process; ``install()`` makes it
    the tracer's tee target and arms the crash hooks."""

    def __init__(self, path: str, *, ring: int = DEFAULT_RING,
                 service: str = "main", registry=None):
        self.path = path
        self.service = service
        self.registry = registry
        self._ring: collections.deque = collections.deque(maxlen=ring)
        self._lock = AuditedLock("obs.flight.recorder")
        self._flushed = False
        self.pid = os.getpid()
        self.started = time.time()

    # -- recording (hot path: bounded append) -------------------------- #

    def note(self, kind: str, **fields) -> None:
        """Append one structured event to the ring."""
        with self._lock:
            self._ring.append({"event": kind, "ts": time.time(),
                               **fields})

    def note_span(self, span_record: dict) -> None:
        """The tracer's tee: every finished span lands in the ring."""
        with self._lock:
            self._ring.append(span_record)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    # -- flush --------------------------------------------------------- #

    def flush(self, reason: str) -> Optional[str]:
        """Write the black box + digest sidecar; returns the path.
        First flush wins (a SIGTERM racing an excepthook must not
        interleave two dumps); never raises — the recorder must not
        make a dying process die harder."""
        with self._lock:
            if self._flushed:
                return None
            self._flushed = True
            entries = list(self._ring)
        try:
            lines = [json.dumps({
                "event": "flight_header", "schema": FLIGHT_SCHEMA,
                "reason": reason, "service": self.service,
                "pid": self.pid, "started": self.started,
                "flushed": time.time(), "entries": len(entries)})]
            lines += [json.dumps(e) for e in entries]
            if self.registry is not None:
                try:
                    lines.append(json.dumps(
                        {"event": "metrics_snapshot",
                         **self.registry.snapshot()}))
                except Exception:   # noqa: BLE001 — snapshot is best-
                    pass            # effort inside a crash handler
            blob = ("\n".join(lines) + "\n").encode()
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            tmp = self.path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            # the sidecar commits atomically too: a kill between the
            # two writes leaves body + .tmp sidecar, which
            # load_postmortem reports as missing-sidecar (torn), never
            # as a half-parsed digest
            side = self.path + ".digest.json"
            with open(side + ".tmp", "w") as f:
                json.dump({"schema": FLIGHT_SCHEMA, "reason": reason,
                           "sha256": hashlib.sha256(blob).hexdigest(),
                           "lines": len(lines)}, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(side + ".tmp", side)
            return self.path
        except Exception:   # noqa: BLE001 — see docstring
            return None


def load_postmortem(path: str, verify: bool = True) -> list:
    """The flushed entries (header first) as dicts. ``verify=True``
    (default) checks the sidecar digest and raises
    ``PostmortemCorruptError`` on any mismatch — a post-mortem you
    cannot trust is worse than none."""
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError as e:
        raise PostmortemCorruptError(f"{path}: unreadable: {e}") from e
    if verify:
        try:
            with open(path + ".digest.json") as f:
                side = json.load(f)
        except (OSError, ValueError) as e:
            raise PostmortemCorruptError(
                f"{path}: missing/unreadable digest sidecar: {e}") from e
        actual = hashlib.sha256(blob).hexdigest()
        if actual != side.get("sha256"):
            raise PostmortemCorruptError(
                f"{path}: sha256 mismatch (sidecar "
                f"{str(side.get('sha256'))[:12]}…, file {actual[:12]}…)")
    out = []
    for line in blob.decode(errors="replace").splitlines():
        if not line.strip():
            continue
        try:
            out.append(json.loads(line))
        except ValueError as e:
            raise PostmortemCorruptError(
                f"{path}: torn line in a digest-valid file: {e}") from e
    if verify and len(out) != side.get("lines"):
        raise PostmortemCorruptError(
            f"{path}: {len(out)} lines, sidecar says {side.get('lines')}")
    return out


def find_postmortems(dir: str) -> list:
    """Flight-recorder files under ``dir`` (newest last)."""
    import glob
    return sorted(glob.glob(os.path.join(dir, "flight-*.jsonl")))


# -- the process-global recorder --------------------------------------- #

_lock = AuditedLock("obs.flight")
_recorder: Optional[FlightRecorder] = None
_enabled = False


def install(recorder: Optional[FlightRecorder],
            crash_hooks: bool = True) -> None:
    """Make ``recorder`` the process black box (``None`` disarms) and,
    by default, arm the crash hooks (SIGTERM + unhandled exceptions).
    ``crash_flush`` flushes from any other crash path."""
    global _recorder, _enabled
    with _lock:
        _recorder, _enabled = recorder, recorder is not None
    if recorder is not None and crash_hooks:
        install_crash_hooks()


def uninstall() -> None:
    global _recorder, _enabled
    with _lock:
        _recorder, _enabled = None, False


def recorder() -> Optional[FlightRecorder]:
    return _recorder


def maybe_install_from_env(service: str = "main",
                           registry=None) -> Optional[FlightRecorder]:
    """Install a recorder iff ``HEAT2D_FLIGHT_DIR`` is set (how a child
    process arms its black box from its parent's environment).
    Idempotent; returns the active recorder (or None)."""
    with _lock:
        if _recorder is not None:
            return _recorder
    d = os.environ.get(ENV_DIR)
    if not d:
        return None
    try:
        ring = int(os.environ.get(ENV_RING) or DEFAULT_RING)
    except ValueError:
        ring = DEFAULT_RING
    rec = FlightRecorder(
        os.path.join(d, f"flight-{service}-{os.getpid()}.jsonl"),
        ring=ring, service=service, registry=registry)
    install(rec)
    return rec


# -- hooks (cheap no-ops when off) ------------------------------------- #

def note(kind: str, **fields) -> None:
    if _enabled and _recorder is not None:
        _recorder.note(kind, **fields)


def note_span(span_record: dict) -> None:
    if _enabled and _recorder is not None:
        _recorder.note_span(span_record)


def crash_flush(reason: str) -> Optional[str]:
    """Flush the black box if one is installed; safe to call from any
    crash path (signal handlers, a kill point) — never raises,
    no-op without a recorder or after the first flush."""
    rec = _recorder
    if rec is None:
        return None
    return rec.flush(reason)


_hooks_installed = False


def install_crash_hooks() -> None:
    """Arm SIGTERM + unhandled-exception flushing (idempotent). The
    previous handlers/hooks still run — the recorder observes the
    death, it does not change it. SIGKILL remains uncatchable by
    design; a hard exit (``os._exit``) flushes via ``crash_flush``
    first."""
    global _hooks_installed
    with _lock:
        if _hooks_installed:
            return
        _hooks_installed = True

    prev_except = sys.excepthook

    def _excepthook(tp, val, tb):
        crash_flush(f"unhandled:{tp.__name__}")
        prev_except(tp, val, tb)

    sys.excepthook = _excepthook

    prev_thread = threading.excepthook

    def _thread_hook(args):
        crash_flush(f"unhandled_thread:{args.exc_type.__name__}")
        prev_thread(args)

    threading.excepthook = _thread_hook

    try:
        prev_term = signal.getsignal(signal.SIGTERM)

        def _on_term(signum, frame):
            if prev_term is signal.SIG_IGN:
                # the process chose to SURVIVE SIGTERM: observing the
                # signal must not spend the one-shot flush, and must
                # certainly not start killing a process that ignores
                # it — the recorder observes deaths, it never causes
                # them
                return
            crash_flush("sigterm")
            if callable(prev_term):
                prev_term(signum, frame)
            else:
                # default disposition: die with the conventional code
                os._exit(128 + signum)

        signal.signal(signal.SIGTERM, _on_term)
    except (ValueError, OSError):
        pass    # not the main thread / unsupported platform
