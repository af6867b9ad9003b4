"""Audited locks: instrumented drop-ins for ``threading.Lock``/``RLock``
with lock-order and guarded-state checking. The port's copy of
``heat2d_tpu/analysis/locks.py``.

The port's threaded modules (the serve batcher and cache, the mesh
scheduler and health monitor, the async checkpoint writer, the chaos
controller, the obs recorders) take their mutexes from here. Two
conventions become checked invariants:

1. **Lock ordering.** Every ``acquire`` of an audited lock while another
   audited lock is held records a directed edge (held -> acquired) in a
   global acquisition graph. ``report()`` runs cycle detection over the
   graph: a cycle is a potential deadlock (thread 1 takes A then B,
   thread 2 takes B then A). The check is order-based, so it fires even
   when the interleaving that would deadlock never happened in the run.
2. **Guarded state.** ``@guarded_by("_lock", "attr", ...)`` registers
   which attributes of a class the named lock protects. Under audit,
   registered classes get a checking ``__setattr__``: a write to a
   guarded attribute without the owning lock held by the current thread
   is recorded as a violation. Writes before the lock has ever been held
   are exempt (``__init__`` publishes the object).

**Free when off**: ``AuditedLock()``/``AuditedRLock()``/
``AuditedCondition()`` return plain ``threading`` objects unless an
auditor is installed (``install()`` or ``HEAT2D_LOCK_AUDIT=1`` in the
environment), and ``guarded_by`` only records the registry:
``__setattr__`` is patched in at ``install()`` and restored at
``uninstall()``. ``analysis.launch_pin`` pins that the audit changes no
launch and no bit of a run.

The port's threaded test files (``tests/test_torch_serve.py``,
``tests/test_torch_mesh_fault.py``, ``tests/test_torch_resil.py``) run
under this auditor when ``HEAT2D_LOCK_AUDIT=1`` is set: a fixture of
their own installs one per test and fails the test on any cycle or
guarded-write violation.
"""

from __future__ import annotations

import os
import threading
import traceback
from typing import Dict, List, Optional, Set, Tuple, Union

ENV_VAR = "HEAT2D_LOCK_AUDIT"

_TRUE = ("1", "true", "on", "yes")


def _env_enabled() -> bool:
    return os.environ.get(ENV_VAR, "").strip().lower() in _TRUE


# ------------------------------------------------------------------ #
# per-thread held-lock stack
# ------------------------------------------------------------------ #

_tls = threading.local()


def _held_stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


# ------------------------------------------------------------------ #
# the auditor
# ------------------------------------------------------------------ #

class Violation:
    """One guarded-state write without the owning lock held."""

    __slots__ = ("cls", "attr", "lock_attr", "thread", "where")

    def __init__(self, cls: str, attr: str, lock_attr: str,
                 thread: str, where: str):
        self.cls = cls
        self.attr = attr
        self.lock_attr = lock_attr
        self.thread = thread
        self.where = where

    def __repr__(self) -> str:
        return (f"guarded-write: {self.cls}.{self.attr} written without "
                f"{self.cls}.{self.lock_attr} held (thread "
                f"{self.thread}) at {self.where}")


class AuditReport:
    """Snapshot of what an audit saw: the acquisition-order edges, any
    lock-order cycles (potential deadlocks), and any guarded-state
    violations."""

    def __init__(self, edges: Dict[Tuple[int, int], dict],
                 cycles: List[List[str]],
                 violations: List[Violation]):
        self.edges = edges
        self.cycles = cycles
        self.violations = violations

    @property
    def clean(self) -> bool:
        return not self.cycles and not self.violations

    def render(self) -> str:
        lines = []
        if self.cycles:
            lines.append(f"{len(self.cycles)} lock-order cycle(s) "
                         "(potential deadlock):")
            for cyc in self.cycles:
                lines.append("  " + " -> ".join(cyc + [cyc[0]]))
        if self.violations:
            lines.append(f"{len(self.violations)} guarded-state "
                         "violation(s):")
            for v in self.violations:
                lines.append("  " + repr(v))
        if not lines:
            lines.append("lock audit clean: "
                         f"{len(self.edges)} order edge(s), no cycles, "
                         "no guarded-state violations")
        return "\n".join(lines)


class LockAuditor:
    """Collects acquisition edges and guarded-write violations. One per
    ``install()``; all audited locks created while it is active feed it."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        #: (id(a), id(b)) -> {"names": (a, b), "thread": name}
        self.edges: Dict[Tuple[int, int], dict] = {}
        #: id -> lock name (nodes of the order graph)
        self.names: Dict[int, str] = {}
        self.violations: List[Violation] = []

    # -- recording ------------------------------------------------- #

    def note_acquire(self, lock: "_AuditedBase") -> None:
        held = _held_stack()
        if not held:
            return
        prev = held[-1]
        if prev is lock:            # re-entrant acquire: no ordering
            return
        key = (id(prev), id(lock))
        with self._mu:
            self.names[id(prev)] = prev.name
            self.names[id(lock)] = lock.name
            if key not in self.edges:
                self.edges[key] = {
                    "names": (prev.name, lock.name),
                    "thread": threading.current_thread().name,
                }

    def note_guard_violation(self, obj: object, attr: str,
                             lock_attr: str) -> None:
        # [-1] is this method, [-2] the patched __setattr__, [-3] the
        # actual write site.
        frames = traceback.extract_stack(limit=4)
        frame = frames[-3] if len(frames) >= 3 else frames[0]
        where = f"{frame.filename}:{frame.lineno}"
        with self._mu:
            self.violations.append(Violation(
                type(obj).__name__, attr, lock_attr,
                threading.current_thread().name, where))

    # -- analysis --------------------------------------------------- #

    def cycles(self) -> List[List[str]]:
        """Cycles in the acquisition-order graph, as lock-name lists.
        Iterative DFS with an on-stack set (the classic back-edge
        detection); each cycle reported once."""
        with self._mu:
            adj: Dict[int, Set[int]] = {}
            for (a, b) in self.edges:
                adj.setdefault(a, set()).add(b)
            names = dict(self.names)
        out: List[List[str]] = []
        seen_cycles: Set[Tuple[str, ...]] = set()
        WHITE, GRAY, BLACK = 0, 1, 2
        color = {n: WHITE for n in adj}
        for root in list(adj):
            if color.get(root, WHITE) != WHITE:
                continue
            stack: List[Tuple[int, list]] = [(root, list(adj.get(root, ())))]
            color[root] = GRAY
            path = [root]
            while stack:
                node, nbrs = stack[-1]
                if nbrs:
                    nxt = nbrs.pop()
                    c = color.get(nxt, WHITE)
                    if c == GRAY:            # back edge: a cycle
                        i = path.index(nxt)
                        cyc = [names.get(n, f"lock@{n:x}")
                               for n in path[i:]]
                        canon = tuple(sorted(cyc))
                        if canon not in seen_cycles:
                            seen_cycles.add(canon)
                            out.append(cyc)
                    elif c == WHITE:
                        color[nxt] = GRAY
                        path.append(nxt)
                        stack.append((nxt, list(adj.get(nxt, ()))))
                else:
                    stack.pop()
                    color[node] = BLACK
                    path.pop()
        return out

    def report(self) -> AuditReport:
        with self._mu:
            edges = dict(self.edges)
            violations = list(self.violations)
        return AuditReport(edges, self.cycles(), violations)


# ------------------------------------------------------------------ #
# audited lock types
# ------------------------------------------------------------------ #

class _AuditedBase:
    """Shared acquire/release bookkeeping over a real lock object."""

    def __init__(self, name: Optional[str], raw) -> None:
        self.name = name or f"lock@{id(self):x}"
        self._raw = raw
        self._owner: Optional[int] = None
        self._count = 0
        #: guarded-write checks only arm once the lock has been held —
        #: before that the owning object is still being constructed
        self._ever_held = False

    # the Lock protocol ------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        me = threading.get_ident()
        # Edges go to the LIVE auditor, resolved per acquire: audited
        # locks can outlive an install(fresh=True) cycle (module-level
        # locks, objects built in an earlier test) — binding the
        # auditor at construction would feed a dead collector and hide
        # their cycles from report().
        a = _auditor
        if a is not None and self._owner != me:
            a.note_acquire(self)    # re-entrant paths skip the edge
        got = self._raw.acquire(blocking, timeout)
        if got:
            self._owner = me
            self._count += 1
            self._ever_held = True
            _held_stack().append(self)
        return got

    def release(self) -> None:
        self._count -= 1
        if self._count == 0:
            self._owner = None
        st = _held_stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i] is self:
                del st[i]
                break
        self._raw.release()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._raw.locked() if hasattr(self._raw, "locked") \
            else self._owner is not None

    # threading.Condition integration ---------------------------------

    def _is_owned(self) -> bool:
        return self._owner == threading.get_ident()

    # audit surface ----------------------------------------------------

    def held_by_current_thread(self) -> bool:
        return self._owner == threading.get_ident()

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r}>"


class _AuditedLock(_AuditedBase):
    def __init__(self, name: Optional[str] = None):
        super().__init__(name, threading.Lock())


class _AuditedRLock(_AuditedBase):
    def __init__(self, name: Optional[str] = None):
        super().__init__(name, threading.RLock())


#: what an audited-lock factory may hand back
LockLike = Union[threading.Lock, _AuditedBase]


# ------------------------------------------------------------------ #
# install / factories
# ------------------------------------------------------------------ #

_auditor: Optional[LockAuditor] = None
_install_mu = threading.Lock()
#: classes registered via @guarded_by: cls -> (lock_attr, attrs)
GUARDS: Dict[type, Tuple[str, frozenset]] = {}
#: original __setattr__ of patched classes (for uninstall)
_PATCHED: Dict[type, object] = {}


def enabled() -> bool:
    """True when an auditor is active (installed or armed via env)."""
    return _auditor is not None or _env_enabled()


def install(fresh: bool = True) -> LockAuditor:
    """Activate auditing: subsequent ``AuditedLock()`` calls return
    instrumented locks feeding the returned auditor, and every class
    registered with ``@guarded_by`` gets the checking ``__setattr__``.
    Idempotent unless ``fresh`` (default) — then a new collector starts."""
    global _auditor
    with _install_mu:
        if _auditor is None or fresh:
            _auditor = LockAuditor()
        _patch_guarded()
        return _auditor


def uninstall() -> None:
    """Deactivate auditing and restore every patched ``__setattr__``."""
    global _auditor
    with _install_mu:
        _auditor = None
        for cls, orig in _PATCHED.items():
            cls.__setattr__ = orig      # type: ignore[method-assign]
        _PATCHED.clear()


def report() -> AuditReport:
    """The active (or last-installed) auditor's findings; an empty
    report when auditing never ran."""
    a = _auditor
    if a is None:
        return AuditReport({}, [], [])
    return a.report()


def _active_auditor() -> Optional[LockAuditor]:
    """The installed auditor, auto-installing when the env var arms
    audit for a whole process tree (spawned workers inherit it)."""
    if _auditor is not None:
        return _auditor
    if _env_enabled():
        return install(fresh=False)
    return None


def AuditedLock(name: Optional[str] = None) -> LockLike:
    """A mutex: plain ``threading.Lock`` when audit is off (zero
    overhead), an instrumented drop-in when on."""
    a = _active_auditor()
    if a is None:
        return threading.Lock()
    return _AuditedLock(name)


def AuditedRLock(name: Optional[str] = None) -> LockLike:
    """Re-entrant variant of ``AuditedLock``."""
    a = _active_auditor()
    if a is None:
        return threading.RLock()
    return _AuditedRLock(name)


def AuditedCondition(name: Optional[str] = None) -> threading.Condition:
    """A ``threading.Condition`` over an audited mutex (plain when audit
    is off). ``wait``/``notify`` go through the stdlib Condition; only
    the underlying mutex is instrumented."""
    a = _active_auditor()
    if a is None:
        return threading.Condition()
    audited = _AuditedLock(name)
    return threading.Condition(audited)  # type: ignore[arg-type]


# ------------------------------------------------------------------ #
# @guarded_by
# ------------------------------------------------------------------ #

def guarded_by(lock_attr: str, *attrs: str):
    """Class decorator: declare that writes to ``attrs`` require
    ``self.<lock_attr>`` to be held. Pure registration — the class is
    returned unchanged; ``install()`` patches the check in and
    ``uninstall()`` removes it, so production code pays nothing."""
    if not attrs:
        raise ValueError("guarded_by needs at least one guarded attr")

    def deco(cls: type) -> type:
        GUARDS[cls] = (lock_attr, frozenset(attrs))
        if _auditor is not None:        # installed before this class
            _patch_guarded()
        return cls

    return deco


def _lock_of(obj) -> Optional[_AuditedBase]:
    """Resolve a guard object to its audited mutex: audited locks pass
    through, a Condition yields its underlying lock, anything else
    (plain lock — audit was off when the owner was built) is
    uncheckable and returns None."""
    if isinstance(obj, _AuditedBase):
        return obj
    inner = getattr(obj, "_lock", None)     # threading.Condition
    if isinstance(inner, _AuditedBase):
        return inner
    return None


def _patch_guarded() -> None:
    for cls, (lock_attr, attrs) in GUARDS.items():
        if cls in _PATCHED:
            continue
        orig = cls.__setattr__

        def checking(self, key, value, _orig=orig, _lock_attr=lock_attr,
                     _attrs=attrs):
            if key in _attrs:
                a = _auditor
                if a is not None:
                    lk = _lock_of(getattr(self, _lock_attr, None))
                    if (lk is not None and lk._ever_held
                            and not lk.held_by_current_thread()):
                        a.note_guard_violation(self, key, _lock_attr)
            _orig(self, key, value)

        _PATCHED[cls] = orig
        cls.__setattr__ = checking      # type: ignore[method-assign]
