"""Per-slot health: probes, the quarantine book and the stall watchdog.
The port of ``heat2d_tpu/mesh/health.py``.

- ``HealthMonitor``: per-slot status, the reason and order of every
  quarantine decision, the surviving slots the mesh engine re-forms its
  mesh over, and the surviving capacity fraction.
- ``probe_device`` / ``HealthMonitor.probe``: a small place-compute-
  readback round trip per slot, checked against its known answer (a
  wrong answer is a failure too). The chaos hook ``device_probe_point``
  lets a campaign kill a slot deterministically.
- ``guarded_call``: the stall watchdog. It runs a launch on a helper
  thread under ``resil.retry.wait_for`` and raises ``MeshStallError``
  when the deadline passes. The abandoned launch keeps running (the host
  cannot preempt it), but its result is discarded and counted
  (``mesh_discarded_results_total``), never served.

On a card, a real fault (an illegal access, a launch failure) poisons
the whole CUDA context: every slot on that card then fails its probe and
is quarantined, and with no survivor left the engine raises, as the JAX
package does. Recovery (shrink-and-requeue, ABFT) is ``mesh/degrade.py``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional, Tuple

from heat2d_tpu_torch.analysis.locks import AuditedLock
from heat2d_tpu_torch.resil import chaos
from heat2d_tpu_torch.resil.retry import wait_for

#: probe payload length
PROBE_N = 16

#: per-slot probe deadline: a failing device can hang the round trip,
#: and an unbounded probe would wedge the sweep the stall watchdog hands
#: off to
PROBE_DEADLINE_S = 5.0

#: quarantine reasons (the ``mesh_quarantine_total{reason}`` labels)
QUARANTINE_REASONS = ("probe_failure", "device_fail", "mesh_stall",
                      "silent_corruption", "host_lost")

#: consecutive verified probe passes before ``parole`` re-admits a slot
PAROLE_PASSES = 3


class MeshStallError(RuntimeError):
    """A mesh launch outlived its stall deadline. The engine turns it into
    quarantine and requeue, or ``Rejected("mesh_stall")`` once the
    requeue budget is spent."""


def is_device_loss(exc: BaseException) -> bool:
    """Failures that name a device as the casualty: the injected
    ``DeviceLostError``, and torch's accelerator error (matched by class
    name, ``torch.AcceleratorError``, as the JAX package matches XLA's
    runtime errors)."""
    if isinstance(exc, chaos.DeviceLostError):
        return True
    return type(exc).__name__ == "AcceleratorError"


def probe_device(index: int, devices=None) -> bool:
    """One health probe of slot ``index`` of ``devices`` (default: the
    visible cards): an arange placed on the slot, plus one, read back and
    checked. Any exception or wrong answer is a failure."""
    if not chaos.device_probe_point(index):
        return False
    try:
        import torch

        from heat2d_tpu_torch.mesh.runner import attached_devices
        dev = attached_devices(None, devices)[index]
        x = torch.arange(PROBE_N, dtype=torch.float32, device=dev)
        got = (x + 1.0).cpu()
        want = torch.arange(1, PROBE_N + 1, dtype=torch.float32)
        return bool(torch.equal(got, want))
    except Exception:
        return False


class HealthMonitor:
    """The per-mesh quarantine book (module docstring). Thread-safe:
    decisions arrive from launch paths, watchdog threads and probe
    sweeps. ``clock`` stamps event rows (injectable)."""

    def __init__(self, n_devices: Optional[int] = None, registry=None,
                 clock: Callable[[], float] = time.monotonic,
                 devices=None):
        from heat2d_tpu_torch.mesh.runner import attached_devices

        self.devices = tuple(attached_devices(n_devices, devices))
        self.n_devices = len(self.devices)
        self.registry = registry
        self.clock = clock
        self._lock = AuditedLock("mesh.health")
        self._quarantined: dict = {}     # slot -> event row
        #: every quarantine decision, in order (the serving invariant's
        #: audit trail)
        self.events: list = []
        self._seq = 0

    def seq(self) -> int:
        """Event ordinal fence: launches capture it before choosing their
        slots, so 'quarantined before this launch' is an integer
        comparison."""
        with self._lock:
            return self._seq

    def is_quarantined(self, index: int) -> bool:
        with self._lock:
            return index in self._quarantined

    def quarantined(self) -> Tuple[int, ...]:
        with self._lock:
            return tuple(sorted(self._quarantined))

    def survivors(self) -> Tuple[int, ...]:
        """Slot indices the next mesh forms over (may be empty)."""
        with self._lock:
            return tuple(i for i in range(self.n_devices)
                         if i not in self._quarantined)

    def capacity_fraction(self) -> float:
        """The surviving share of the slots."""
        with self._lock:
            live = self.n_devices - len(self._quarantined)
        return live / self.n_devices if self.n_devices else 0.0

    def snapshot(self) -> dict:
        """Run-record block: quarantine set, events, capacity."""
        with self._lock:
            return {"n_devices": self.n_devices,
                    "quarantined": sorted(self._quarantined),
                    "capacity_fraction":
                        (self.n_devices - len(self._quarantined))
                        / self.n_devices if self.n_devices else 0.0,
                    "events": [dict(e) for e in self.events]}

    def quarantine(self, index: int, reason: str) -> bool:
        """Quarantine slot ``index`` (idempotent; False = already out).
        One-way: re-admission is ``parole``, not a retry."""
        if reason not in QUARANTINE_REASONS:
            raise ValueError(
                f"reason must be one of {QUARANTINE_REASONS}, got "
                f"{reason!r}")
        if not 0 <= index < self.n_devices:
            raise ValueError(
                f"device index {index} outside the "
                f"{self.n_devices}-device mesh")
        with self._lock:
            if index in self._quarantined:
                return False
            self._seq += 1
            row = {"seq": self._seq, "t": self.clock(),
                   "device": index, "reason": reason}
            self._quarantined[index] = row
            self.events.append(row)
            live = self.n_devices - len(self._quarantined)
        if self.registry is not None:
            self.registry.counter("mesh_quarantine_total",
                                  reason=reason)
            self.registry.gauge("mesh_quarantined_devices",
                                float(self.n_devices - live))
        return True

    def probe(self, devices: Optional[Tuple[int, ...]] = None,
              reason: str = "probe_failure") -> dict:
        """Probe slots ``devices`` (default: the survivors), quarantining
        every failure under ``reason``. Returns {index: ok}."""
        out = {}
        for i in (self.survivors() if devices is None else devices):
            try:
                # bounded on the wall clock: a hung probe convicts like a
                # wrong answer
                ok = guarded_call(
                    lambda d=i: probe_device(d, self.devices),
                    PROBE_DEADLINE_S)
            except MeshStallError:
                ok = False
            out[i] = ok
            if not ok:
                if self.registry is not None:
                    self.registry.counter("mesh_probe_failures_total")
                self.quarantine(i, reason)
        return out

    def parole(self, index: int, passes: int = PAROLE_PASSES,
               probe: Optional[Callable[[int], bool]] = None) -> bool:
        """Re-admit a quarantined slot after ``passes`` consecutive
        verified probe passes; one failure ends the hearing. Success
        appends a seq-fenced ``kind="readmit"`` event. ``probe`` is
        injectable (default: ``probe_device``)."""
        if passes < 1:
            raise ValueError(f"passes must be >= 1, got {passes}")
        if not 0 <= index < self.n_devices:
            raise ValueError(
                f"device index {index} outside the "
                f"{self.n_devices}-device mesh")
        if not self.is_quarantined(index):
            return False
        probe_fn = ((lambda i: probe_device(i, self.devices))
                    if probe is None else probe)
        for _ in range(passes):
            try:
                ok = guarded_call(lambda: probe_fn(index),
                                  PROBE_DEADLINE_S)
            except MeshStallError:
                ok = False
            if not ok:
                if self.registry is not None:
                    self.registry.counter("mesh_parole_total",
                                          outcome="denied")
                return False
        with self._lock:
            if index not in self._quarantined:
                return False
            self._seq += 1
            row = {"seq": self._seq, "t": self.clock(),
                   "device": index, "reason": "parole",
                   "kind": "readmit", "passes": passes}
            del self._quarantined[index]
            self.events.append(row)
            live = self.n_devices - len(self._quarantined)
        if self.registry is not None:
            self.registry.counter("mesh_parole_total", outcome="paroled")
            self.registry.gauge("mesh_quarantined_devices",
                                float(self.n_devices - live))
        return True


def guarded_call(fn: Callable[[], object],
                 deadline_s: Optional[float], *,
                 clock: Optional[Callable[[], float]] = None,
                 on_discard: Optional[Callable[[], None]] = None,
                 poll: float = 0.005):
    """Run ``fn()`` under the stall watchdog: its result (or its
    exception) when it finishes inside ``deadline_s``, else
    ``MeshStallError``. The stalled call runs on in its daemon thread,
    and when it completes ``on_discard`` fires: its result is never
    served. ``deadline_s=None`` is a plain call."""
    if deadline_s is None:
        return fn()

    lock = AuditedLock("mesh.health.guard")
    done = threading.Event()
    box: dict = {}
    state = {"done": False, "discarded": False}

    def run() -> None:
        try:
            value = fn()
            err = None
        except BaseException as e:     # noqa: BLE001 — re-raised below
            value, err = None, e
        with lock:
            box["value"], box["error"] = value, err
            state["done"] = True
            discarded = state["discarded"]
        done.set()
        if discarded and on_discard is not None:
            on_discard()

    t = threading.Thread(target=run, name="heat2d-mesh-launch",
                         daemon=True)
    t.start()
    wait_for(done.is_set, deadline_s, clock=clock, poll=poll,
             sleep=lambda s: done.wait(s))
    with lock:
        if state["done"]:
            err = box["error"]
            if err is not None:
                raise err
            return box["value"]
        # the verdict lands before the lock is released, so a finishing
        # thread cannot race past it
        state["discarded"] = True
    raise MeshStallError(
        f"mesh launch outlived its {deadline_s}s stall deadline")
