"""Mesh degradation: quarantine-driven shrink-and-requeue, and the ABFT
verify tier's host half. The port of ``heat2d_tpu/mesh/degrade.py``.

``mesh/health.py`` detects (probes, the stall watchdog); this module
decides and recovers. The contract, in the order the engine runs it:

1. **A launch fails on a slot** (``DeviceLostError`` / torch's
   accelerator error), **stalls** (``MeshStallError`` from the watchdog),
   or **fails its ABFT check** (``CorruptionError``).
2. The culprit is quarantined: the named device on a device loss, the
   checksum-mismatching members' OWNER devices on corruption, the
   probe sweep's casualties on a stall (a hang names nobody — the
   probes do). Results of the failed attempt are NEVER served.
3. The batch mesh is RE-FORMED over the surviving devices: the padded
   capacity re-pads to the new device multiple (``mesh_capacity``
   already takes the device count, so the O(log max_batch) compile
   ladder holds per mesh shape) and the SAME batch relaunches — the
   in-flight members ride their existing single-flight futures, so
   followers coalesced onto the leader are requeued for free, exactly
   like the fleet router's failover replay one layer up.
4. Recovery is MEASURED: every requeue episode records cause,
   casualty set, and detect->recover wall seconds into the degrader's
   event log (the run record's ``mesh_fault`` block) and the
   ``mesh_recovery_s`` histogram.

The requeue budget (``FaultPolicy.max_requeues``) bounds the loop;
past it the failure propagates structurally — ``Rejected("mesh_stall")``
for stalls, the original error otherwise — and the server's
retry/breaker plumbing takes over.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Tuple

from heat2d_tpu_torch.mesh.health import HealthMonitor, guarded_call

#: requeue causes (the ``mesh_requeue_total{cause}`` label vocabulary)
REQUEUE_CAUSES = ("device_fail", "mesh_stall", "silent_corruption")


@dataclasses.dataclass(frozen=True)
class FaultPolicy:
    """Opt-in mesh fault tolerance, everything off by default."""

    #: hung-collective deadline (seconds on ``clock``); None = no
    #: stall watchdog (and no per-launch helper thread)
    stall_deadline_s: Optional[float] = None
    #: ABFT checksum verify tier (ops/abft.py) on the batch route
    abft: bool = False
    #: tolerance multiplier (ops/abft.tolerance ``factor``)
    abft_tol_factor: float = 64.0
    #: shrink-and-requeue attempts per launch before the failure
    #: propagates structurally
    max_requeues: int = 2
    #: probe the survivors after a stall to find the casualty
    probe_on_stall: bool = True

    def __post_init__(self):
        if self.max_requeues < 0:
            raise ValueError(
                f"max_requeues must be >= 0, got {self.max_requeues}")
        if (self.stall_deadline_s is not None
                and self.stall_deadline_s <= 0):
            raise ValueError(
                f"stall_deadline_s must be > 0, got "
                f"{self.stall_deadline_s}")


class CorruptionError(RuntimeError):
    """An ABFT checksum mismatch — silent data corruption caught
    before serving. Carries the mismatching member indices and their
    owner devices."""

    def __init__(self, members: List[int], devices: List[int]):
        super().__init__(
            f"ABFT checksum mismatch on members {members} "
            f"(devices {devices})")
        self.members = members
        self.devices = devices


def member_owner(member: int, capacity: int,
                 devices: Tuple[int, ...]) -> int:
    """The slot that computed ``member`` of a ``capacity``-padded batch
    split over ``devices``: contiguous equal parts in slot order
    (``mesh/runner.py``)."""
    per = capacity // len(devices)
    return devices[member // per]


class MeshDegrader:
    """Per-engine fault orchestration state (module docstring)."""

    def __init__(self, policy: FaultPolicy, monitor: HealthMonitor,
                 registry=None, clock=None):
        self.policy = policy
        self.monitor = monitor
        self.registry = registry
        #: the stall watchdog's clock (injectable; None = wall)
        self.clock = clock
        #: one row per recovery episode: cause, devices quarantined,
        #: measured seconds from detection to the recovered launch —
        #: the run record's proof that recovery happened and how fast
        self.events: List[dict] = []

    def now(self) -> float:
        """The fault stack's ONE clock: the injected clock when a test
        froze time, wall monotonic otherwise — detection stamps and
        recovery rows live in the same domain as the stall deadline."""
        return (self.clock or time.monotonic)()

    # -- the guarded launch -------------------------------------------- #

    def guarded(self, fn: Callable[[], object]):
        """Run one launch attempt under the stall watchdog."""
        return guarded_call(fn, self.policy.stall_deadline_s,
                            clock=self.clock,
                            on_discard=self._count_discard)

    def _count_discard(self) -> None:
        if self.registry is not None:
            self.registry.counter("mesh_discarded_results_total",
                                  cause="mesh_stall")

    # -- failure classification ---------------------------------------- #

    def on_device_lost(self, exc: BaseException) -> List[int]:
        """Quarantine after a device-loss failure: the named device
        when the error carries one, else whatever the probe sweep
        convicts. Returns the newly quarantined set."""
        index = getattr(exc, "device_index", None)
        if index is not None:
            self.monitor.quarantine(index, "device_fail")
            return [index]
        failed = [i for i, ok in self.monitor.probe().items() if not ok]
        return failed

    def on_stall(self) -> List[int]:
        """Quarantine after a stall verdict: a hang names nobody, so
        the probe sweep does (``probe_on_stall``), convicting under
        the stall's own reason label."""
        if self.registry is not None:
            self.registry.counter("mesh_stall_total")
        if not self.policy.probe_on_stall:
            return []
        return [i for i, ok in
                self.monitor.probe(reason="mesh_stall").items()
                if not ok]

    def on_corruption(self, exc: CorruptionError) -> List[int]:
        for d in exc.devices:
            self.monitor.quarantine(d, "silent_corruption")
        return list(exc.devices)

    # -- accounting ---------------------------------------------------- #

    def record_requeue(self, cause: str) -> None:
        if cause not in REQUEUE_CAUSES:
            raise ValueError(f"unknown requeue cause {cause!r}")
        if self.registry is not None:
            self.registry.counter("mesh_requeue_total", cause=cause)

    def record_recovery(self, cause: str, casualties: List[int],
                        t_detect: float, devices: Tuple[int, ...],
                        requeues: int) -> dict:
        """Close a recovery episode (called when the relaunch
        SUCCEEDED): wall seconds are measured detect -> now, never
        scheduled."""
        row = {"cause": cause, "quarantined": sorted(casualties),
               "recovery_s": self.now() - t_detect,
               "devices": list(devices), "requeues": requeues}
        self.events.append(row)
        if self.registry is not None:
            self.registry.observe("mesh_recovery_s", row["recovery_s"])
        return row

    def snapshot(self) -> dict:
        """Run-record ``mesh_fault`` block."""
        return {"policy": dataclasses.asdict(self.policy),
                "recoveries": [dict(r) for r in self.events],
                "health": self.monitor.snapshot()}


def serving_invariant(monitor: HealthMonitor,
                      launch_log: List[dict]) -> dict:
    """``no_quarantined_serving``: every SERVED mesh launch ran on a
    device set disjoint from everything quarantined before that
    launch picked its devices (rows carry the monitor's event ``seq``
    fence captured at selection time — a pure ordering check, no
    clock races). The structural twin of the control plane's
    ``no_unvalidated_serving``.

    Parole-aware: a device's status at a launch's fence is decided by
    the LATEST health event at or before the fence — a conviction is
    a violation, a ``kind="readmit"`` parole row clears it. A device
    re-convicted after its parole violates again for later launches,
    so the invariant stays provable through the whole quarantine →
    parole → (maybe re-quarantine) lifecycle."""
    violations = []
    events = monitor.snapshot()["events"]
    for row in launch_log:
        mesh = row.get("mesh") or {}
        devices = mesh.get("devices")
        seq = mesh.get("health_seq")
        if devices is None or seq is None:
            continue
        # events are appended in seq order: last write <= fence wins
        status = {}
        for ev in events:
            if ev["seq"] <= seq:
                status[ev["device"]] = ev
        for d in devices:
            ev = status.get(d)
            if ev is not None and ev.get("kind") != "readmit":
                violations.append({"launch": row.get("signature"),
                                   "device": d,
                                   "event": dict(ev)})
    return {"ok": not violations, "checked": len(launch_log),
            "violations": violations}
