"""The actuator: control-plane advice in, fleet/mesh actions out (the
port of ``heat2d_tpu/autoscale/actuator.py``).

``Actuator.observe`` consumes one ``load/capacity.advise`` sizing row
per control tick and converges the worker pool toward it through the
``AutoscalePolicy`` guardrails — never above ``max_workers``, never
below ``min_workers``, scale-ups rate-limited by a cooldown, scale-downs
additionally gated behind ``down_hold_ticks`` consecutive quiet
observations (one quiet window is noise, N in a row is a trough).

Actions are executed, not just recommended:

- **scale-up** — ``FleetServer.add_worker``: the new worker rides the
  warm-restart machinery (spawned ``via="scale_up"``, cold-gated by
  the router until its hot signatures are compiled — it is UNROUTABLE
  until then, so a scale-up can never serve a cold compile to a
  client).
- **scale-down** — ``Actuator.retire``: any long-running inverse jobs
  attached to the victim are live-migrated first (pause → wire ticket
  → resume on the lowest-numbered survivor), then
  ``FleetServer.retire_worker`` runs the fence-then-drain protocol
  (router fenced BEFORE the shutdown line, in-flight work flushed by
  pipe FIFO order or replayed on an unclean drain).
- **parole** — quarantined mesh devices get a hearing
  (``HealthMonitor.parole``): N consecutive verified probe passes
  re-admit the device under a seq-fenced event, so
  ``no_quarantined_serving`` stays provable across the re-admission.
- **mesh resize** — voluntary ``MeshEnsembleEngine.resize`` in either
  direction (over the engine's slots: on one card,
  ``parallel.mesh.host_devices``).

The actuator also keeps the chip-seconds ledger: the integral of
pool size over wall time, compared in ``summary()`` against the static
baseline (``max_workers`` for the whole window) that a non-elastic
deployment would have paid. That ratio is the elastic soak's "cheaper
than static provisioning" verdict.
"""

from __future__ import annotations

import json
import logging
from typing import Dict, List, Optional

from heat2d_tpu_torch.analysis.locks import AuditedLock
from heat2d_tpu_torch.autoscale.policy import AutoscalePolicy
from heat2d_tpu_torch.autoscale import migrate as _migrate

log = logging.getLogger("heat2d_tpu_torch.autoscale")


class Actuator:
    """Executes sizing advice against a live ``FleetServer`` (and,
    optionally, a mesh engine + health monitor). See module docstring.

    ``clock`` is injectable (tests drive cooldowns deterministically);
    production uses ``time.monotonic``. ``device``: where a migrated
    inverse job resumes (the card unless ``"cpu"``; the ticket carries no
    device)."""

    def __init__(self, fleet, policy: Optional[AutoscalePolicy] = None,
                 *, registry=None, clock=None, mesh_engine=None,
                 health=None, device: str = "cuda"):
        import time as _time
        self.fleet = fleet
        self.policy = policy or AutoscalePolicy()
        self.registry = registry
        self.clock = clock or _time.monotonic
        self.mesh_engine = mesh_engine
        self.health = health
        self.device = device
        self._lock = AuditedLock("autoscale.actuator")
        #: audit trail of every action taken, in order
        self.actions: List[dict] = []
        #: one row per migrated inverse job
        self.migrations: List[dict] = []
        #: (t, pool_size) samples — one per observe(), for the
        #: capacity-vs-envelope plot/assert
        self.trace: List[tuple] = []
        self._jobs: Dict[int, List[object]] = {}
        self._below = 0                 # consecutive below-target ticks
        self._last_up: Optional[float] = None
        self._last_down: Optional[float] = None
        # chip-seconds ledger: integral of pool_size dt since first
        # observation
        self._t0: Optional[float] = None
        self._last_t: Optional[float] = None
        self._chip_seconds = 0.0

    # -- ledger ---------------------------------------------------------- #

    def pool_size(self) -> int:
        return self.fleet.sup.pool_size()

    def _integrate(self, now: float) -> None:
        if self._t0 is None:
            self._t0 = now
        elif now > self._last_t:
            self._chip_seconds += (now - self._last_t) * self.pool_size()
        self._last_t = now
        if self.registry is not None:
            self.registry.gauge("autoscale_chip_seconds",
                                self._chip_seconds)

    def _record(self, action: str, **fields) -> dict:
        row = {"t": self._last_t, "action": action, **fields}
        self.actions.append(row)
        if self.registry is not None:
            self.registry.counter("autoscale_actions_total",
                                  action=action)
            self.registry.gauge("autoscale_workers",
                                float(self.pool_size()))
        return row

    # -- the control-tick entry point ------------------------------------ #

    def observe(self, advice: Optional[dict]) -> List[dict]:
        """Consume one sizing row (or ``None`` — still integrates the
        ledger) and take at most one action's worth of steps. Returns
        the action rows appended this tick."""
        pol = self.policy
        now = self.clock()
        with self._lock:
            self._integrate(now)
            cur = self.pool_size()
            self.trace.append((now, cur))
            if advice is None:
                return []
            target = int(advice.get("needed_units", cur))
            target = max(pol.min_workers, min(pol.max_workers, target))
            taken: List[dict] = []
            if target > cur:
                self._below = 0
                if (self._last_up is not None
                        and now - self._last_up < pol.up_cooldown_s):
                    return []
                k = min(target - cur, pol.max_step_up)
                slots = [self.fleet.add_worker() for _ in range(k)]
                self._last_up = now
                taken.append(self._record(
                    "scale_up", slots=slots, pool=self.pool_size(),
                    target=target))
                log.info("scale-up +%d -> %d (target %d)", k,
                         self.pool_size(), target)
            elif target < cur:
                self._below += 1
                if self._below < pol.down_hold_ticks:
                    return []
                if (self._last_down is not None
                        and now - self._last_down < pol.down_cooldown_s):
                    return []
                k = min(cur - target, pol.max_step_down)
                # victims: the highest-numbered provisioned slots —
                # the most recently added, so the steady-state pool
                # keeps its longest-warmed workers
                victims = self.fleet.sup.provisioned_slots()[-k:]
                self._last_down = now
                self._below = 0
                for slot in victims:
                    taken.append(self._retire_locked(slot, target))
            else:
                self._below = 0
            return taken

    # -- scale-down / migration ------------------------------------------ #

    def attach_job(self, slot: int, job) -> None:
        """Pin a long-running ``migrate.InverseJob`` to a worker slot:
        if that slot is ever retired, the job is live-migrated to a
        survivor first."""
        with self._lock:
            self._jobs.setdefault(int(slot), []).append(job)

    def jobs_on(self, slot: int) -> List[object]:
        with self._lock:
            return list(self._jobs.get(int(slot), ()))

    def retire(self, slot: int) -> dict:
        """Explicitly retire one worker (migrating its jobs). The
        scale-down path in ``observe`` funnels through the same code."""
        with self._lock:
            if self._last_t is None:
                self._integrate(self.clock())
            return self._retire_locked(slot, target=None)

    def _retire_locked(self, slot: int, target: Optional[int]) -> dict:
        migrated = self._migrate_jobs(slot)
        clean = self.fleet.retire_worker(
            slot, timeout=self.policy.drain_timeout_s)
        row = self._record("scale_down", slot=slot, clean=clean,
                           migrated=migrated, pool=self.pool_size(),
                           target=target)
        log.info("retired worker %d (clean=%s, migrated %d job(s))",
                 slot, clean, len(migrated))
        return row

    def _migrate_jobs(self, slot: int) -> List[dict]:
        """Checkpoint every job attached to ``slot``, ship each ticket
        through a JSON round trip (proving wire transportability), and
        resume on the lowest-numbered surviving slot. Caller holds the
        lock."""
        jobs = self._jobs.pop(int(slot), [])
        out: List[dict] = []
        for job in jobs:
            ticket = job.checkpoint()
            if ticket is None:
                # finished before the pause landed — nothing to move
                out.append({"from": slot, "to": None,
                            "iteration": job.completed_iterations(),
                            "resumed": False})
                continue
            wire_line = json.dumps(ticket)
            resumed = _migrate.resume_job(wire_line,
                                          registry=self.registry,
                                          device=self.device)
            survivors = [s for s in self.fleet.sup.provisioned_slots()
                         if s != slot]
            dest = survivors[0] if survivors else None
            if dest is not None:
                self._jobs.setdefault(dest, []).append(resumed)
            rec = {"from": slot, "to": dest,
                   "iteration": ticket["state"]["iteration"],
                   "bytes": len(wire_line), "resumed": True}
            out.append(rec)
            self.migrations.append(rec)
            if self.registry is not None:
                self.registry.counter("autoscale_migrations_total")
            log.info("migrated inverse job %d -> %s at iteration %d "
                     "(%d wire bytes)", slot, dest, rec["iteration"],
                     rec["bytes"])
        return out

    # -- mesh actions ---------------------------------------------------- #

    def parole_all(self, passes: Optional[int] = None) -> List[dict]:
        """Give every quarantined device a parole hearing. Re-admission
        requires ``passes`` consecutive verified probe passes; a single
        failure denies (the device stays quarantined, no event)."""
        if self.health is None:
            return []
        if self._last_t is None:
            self._integrate(self.clock())
        n = self.policy.parole_passes if passes is None else int(passes)
        rows: List[dict] = []
        for dev in sorted(self.health.quarantined()):
            ok = self.health.parole(dev, passes=n)
            rows.append(self._record(
                "parole", device=dev,
                outcome="paroled" if ok else "denied"))
        return rows

    def resize_mesh(self, n: int) -> Optional[dict]:
        if self.mesh_engine is None:
            return None
        if self._last_t is None:
            self._integrate(self.clock())
        row = self.mesh_engine.resize(n)
        return self._record("mesh_resize", **row)

    # -- the verdict ------------------------------------------------------ #

    def summary(self) -> dict:
        """The soak's closing ledger: what was done, what it cost, and
        how that compares to static provisioning at ``max_workers``."""
        import dataclasses
        with self._lock:
            self._integrate(self.clock())
            elapsed = ((self._last_t - self._t0)
                       if self._t0 is not None else 0.0)
            static = elapsed * self.policy.max_workers
            sizes = [p for _, p in self.trace] or [self.pool_size()]
            return {
                "policy": dataclasses.asdict(self.policy),
                "elapsed_s": elapsed,
                "chip_seconds": self._chip_seconds,
                "static_chip_seconds": static,
                "savings_fraction": (
                    1.0 - self._chip_seconds / static if static > 0
                    else 0.0),
                "workers_min": min(sizes),
                "workers_max": max(sizes),
                "scale_ups": sum(1 for a in self.actions
                                 if a["action"] == "scale_up"),
                "scale_downs": sum(1 for a in self.actions
                                   if a["action"] == "scale_down"),
                "paroles": sum(1 for a in self.actions
                               if a["action"] == "parole"
                               and a["outcome"] == "paroled"),
                "migrations": len(self.migrations),
                "actions": list(self.actions),
                "migration_rows": list(self.migrations),
                "trace": list(self.trace),
            }


__all__ = ["Actuator"]
