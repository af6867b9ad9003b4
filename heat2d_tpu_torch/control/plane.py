"""The SLO-driven control plane — telemetry -> decision -> action (the
port of ``heat2d_tpu/control/plane.py``).

Every sensor and actuator this loop closes over already exists; the
plane is the policy that connects them, running beside the router in
the fleet supervisor process:

- sustained per-signature burn (``obs.slo.BurnWindow``) -> pre-emptive
  shed: lower the standard-priority watermark
  (``FleetServer.set_preemptive_shed``) so low-priority tenants shed
  BEFORE the ``DegradedMode`` breaker trips;
- sustained burn, fleet off-peak -> retune: stage a candidate db for
  the burning/hot signatures (``control.retuner``);
- sustained burn + a fitted capacity model (``load.capacity``) ->
  capacity advice: units needed for the observed rate vs deployed;
- staged candidate -> safe rollout: canary -> parity -> observe ->
  promote or auto-revert (``control.rollout``);
- burn clears -> lift the shed.

Each ``tick()`` is one evaluation pass (the background thread runs one
per ``interval``); every decision lands in the decision log the
``kind="control"`` run record carries, plus the ``control_*`` metric
families (the README's "Port metric families" table).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, Optional

from heat2d_tpu_torch.analysis.locks import AuditedLock
from heat2d_tpu_torch.obs import slo

log = logging.getLogger("heat2d_tpu_torch.control")


class ControlPlane:
    """The loop. ``policy`` judges per-signature burn; ``retuner`` is
    optional (without one, retune decisions are recorded as wanted but
    nothing stages); ``capacity_fit`` is a fitted model dict from
    ``load.capacity.fit_capacity`` (optional)."""

    def __init__(self, fleet, *, policy: Optional[slo.SLOPolicy] = None,
                 interval: float = 0.5,
                 burn_threshold: float = 1.0, sustain: int = 3,
                 shed_watermark: float = 0.4,
                 retuner=None, capacity_fit: Optional[dict] = None,
                 registry=None, mesh_health=None, sentinel=None,
                 actuator=None):
        """``sentinel``: an optional ``obs.perf.AnomalySentinel`` —
        each tick evaluates one sentinel window and its findings land
        in the decision log as ``perf_anomaly`` rows beside burn,
        closing telemetry->detection for performance regressions the
        SLO burn machinery can't see (a rate that quietly halved, a
        tail that grew inside its SLO, a roofline fraction that sagged).

        ``mesh_health``: an optional ``mesh.HealthMonitor`` — the
        device-quarantine book feeds capacity decisions: every
        quarantine transition lands in the decision log, the
        ``control_quarantined_devices`` gauge tracks the count, and
        sizing advice discounts deployed units by the surviving
        capacity fraction (7 of 8 chips alive = 7/8 of the modeled
        capacity actually serving).

        ``actuator``: an optional ``autoscale.Actuator`` — with one
        armed, sizing advice is EXECUTED, not just recorded: every
        tick (not only under sustained burn — trough scale-down needs
        the quiet ticks too) feeds the advice row to the actuator,
        which converges the worker pool toward it under its policy's
        guardrails. Actions taken land in the decision log as
        ``autoscale_*`` rows."""
        self.fleet = fleet
        self.actuator = actuator
        self.mesh_health = mesh_health
        self.sentinel = sentinel
        self._last_quarantined: Optional[int] = None
        self._last_quarantine_seq = 0
        self.policy = policy or slo.SLOPolicy(latency_p99_s=30.0)
        self.interval = interval
        self.shed_watermark = shed_watermark
        self.retuner = retuner
        self.capacity_fit = capacity_fit
        from heat2d_tpu_torch.obs.metrics import CounterDeltas
        self.registry = (registry if registry is not None
                         else getattr(fleet, "registry", None))
        self.burn = slo.BurnWindow(self.policy, prefix="fleet",
                                   threshold=burn_threshold,
                                   sustain=sustain)
        self._deltas = CounterDeltas()
        self.decisions: list = []
        self.rollouts: list = []
        self.staged: list = []
        self.retune_wanted: set = set()
        #: signatures already attempted this burn episode — staging is
        #: once per episode, not once per tick (cleared when the burn
        #: clears, so a future episode may re-stage)
        self._retuned: set = set()
        self._shed_active = False
        self._burning = False
        self._last_advice_units = None
        self._rollout_active = False
        self._last_t = None
        self._lock = AuditedLock("control.plane")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ------------------------------------------------------- #

    def start(self) -> "ControlPlane":
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="heat2d-control-plane",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        if self._shed_active:
            # never leave a stopped plane's shed in force
            self.fleet.set_preemptive_shed(None)
            self._shed_active = False

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.tick()
            except Exception:
                # the plane is an OPERATOR, not a dependency: a broken
                # tick must not take serving down with it
                log.exception("control tick failed")

    # -- the loop body --------------------------------------------------- #

    def _decide(self, action: str, **fields) -> None:
        row = {"t": time.monotonic(), "action": action, **fields}
        with self._lock:
            self.decisions.append(row)
        if self.registry is not None:
            self.registry.counter("control_actions_total",
                                  action=action)
        log.info("control decision: %s %s", action, fields or "")

    def _observed_rps(self) -> float:
        """Fleet-wide completion rate since the previous tick."""
        reg = self.registry
        if reg is None:
            return 0.0
        done = sum(d for k, d in self._deltas.tick(
            reg, "fleet_requests_total").items()
            if dict(k).get("outcome") == "completed")
        now = time.monotonic()
        last_t, self._last_t = self._last_t, now
        if last_t is None or now <= last_t:
            return 0.0
        return max(0.0, done) / (now - last_t)

    def tick(self) -> Dict[str, dict]:
        """One telemetry->decision->action pass; returns the burn
        window's result (test hook)."""
        res = self.burn.tick(self.registry)
        sustained = self.burn.sustained(res)
        if self.registry is not None:
            self.registry.gauge("control_burning_signatures",
                                len(sustained))
        rps = self._observed_rps()

        capacity_fraction = 1.0
        if self.mesh_health is not None:
            # device quarantine -> capacity decisions: transitions are
            # decision rows (deduped like shed/unshed — an hour of a
            # quarantined chip is ONE row), the live count is a gauge,
            # and the capacity fraction discounts the sizing advice.
            # Per-tick reads use the cheap accessors; the full event
            # book is copied only on a transition.
            q = len(self.mesh_health.quarantined())
            capacity_fraction = self.mesh_health.capacity_fraction()
            if self.registry is not None:
                self.registry.gauge("control_quarantined_devices",
                                    float(q))
            if self._last_quarantined is None:
                # startup: a healthy mesh needs no "nothing is
                # quarantined" decision row, but quarantines that
                # PRE-DATE the plane (a restart mid-incident) are
                # state the audit trail must carry — baseline at 0 so
                # a nonzero first tick logs them like any transition
                self._last_quarantined = 0
            if q != self._last_quarantined:
                snap = self.mesh_health.snapshot()
                # only the events of THIS transition (seq past the
                # last logged fence): a mesh losing chips one by one
                # logs each conviction once, not a growing history
                fresh = [e for e in snap["events"]
                         if e["seq"] > self._last_quarantine_seq]
                self._decide("device_quarantine",
                             quarantined=snap["quarantined"],
                             capacity_fraction=capacity_fraction,
                             events=[{"device": e["device"],
                                      "reason": e["reason"]}
                                     for e in fresh])
                if fresh:
                    self._last_quarantine_seq = max(
                        e["seq"] for e in fresh)
                self._last_quarantined = q

        if self.sentinel is not None and self.registry is not None:
            # one sentinel window per tick: EWMA+MAD findings are
            # decision rows beside burn (obs/perf.AnomalySentinel) —
            # detection only; actuation stays with the burn machinery
            for f in self.sentinel.tick(self.registry):
                self._decide("perf_anomaly", **f)

        if sustained and not self._shed_active:
            # escalate BEFORE the breaker: shed the low-priority
            # tenants while priority-0 traffic and cache hits keep
            # answering
            self.fleet.set_preemptive_shed(self.shed_watermark)
            self._shed_active = True
            self._decide("shed", watermark=self.shed_watermark,
                         signatures=sustained)
        elif not sustained and self._shed_active:
            self.fleet.set_preemptive_shed(None)
            self._shed_active = False
            self._retuned.clear()       # a new episode may retune
            self._decide("unshed")
        if self.registry is not None:
            self.registry.gauge("control_shed_active",
                                1.0 if self._shed_active else 0.0)

        if sustained:
            fresh = [s for s in sustained
                     if s not in self.retune_wanted
                     and s not in self._retuned]
            if fresh:
                self.retune_wanted.update(fresh)
                self._decide("retune_wanted", signatures=fresh)
        advice = None
        if self.capacity_fit and (sustained
                                  or self.actuator is not None):
            from heat2d_tpu_torch.load import capacity
            # with an actuator armed, "deployed" means the provisioned
            # pool (retired slots excluded), not merely whoever is
            # alive this instant mid-restart
            current = (self.actuator.pool_size()
                       if self.actuator is not None
                       else len(self.fleet.sup.alive_slots()))
            advice = capacity.advise(self.capacity_fit, rps, current)
            if capacity_fraction < 1.0:
                # quarantined chips don't serve: the deployed
                # units' EFFECTIVE capacity shrinks by the
                # surviving fraction, so the add-units gap grows
                advice["capacity_fraction"] = capacity_fraction
                advice["effective_units"] = (
                    advice["current_units"] * capacity_fraction)
                need = advice.get("needed_units")
                if need is not None:
                    import math
                    advice["add_units"] = max(
                        0, math.ceil(
                            need - advice["effective_units"]))
            # advice rows dedupe on state transitions (like shed/
            # unshed): an hour-long burn must not append thousands
            # of identical rows to the decision log. The key
            # includes add_units so a mid-burn quarantine that
            # shrinks effective capacity (same needed_units,
            # bigger gap) emits the corrected advice. Quiet-tick
            # advice (actuator-only) stays out of the decision log —
            # the ACTIONS it triggers are the record.
            if sustained:
                advice_key = (advice.get("needed_units"),
                              advice.get("add_units"))
                if (not self._burning
                        or advice_key != self._last_advice_units):
                    self._decide("capacity_advice", **advice)
                    self._last_advice_units = advice_key
            if (self.registry is not None
                    and advice.get("needed_units")):
                self.registry.gauge("control_capacity_needed_units",
                                    advice["needed_units"])
        self._burning = bool(sustained)

        if self.actuator is not None:
            # execution: the actuator converges the pool toward the
            # advice under its guardrails; every action it takes is a
            # decision row (autoscale_scale_up / autoscale_scale_down)
            for row in self.actuator.observe(advice):
                fields = {k: v for k, v in row.items()
                          if k not in ("t", "action")}
                self._decide(f"autoscale_{row['action']}", **fields)

        # no staging while a rollout is live: stage_candidate rewrites
        # candidate_path, and the rollout's promote guard would (
        # correctly) revert on the epoch change — don't invite it
        if self.retuner is not None and self.retune_wanted \
                and not self._rollout_active \
                and self.retuner.off_peak():
            staged = None
            for sig in sorted(self.retune_wanted):
                staged = self.retuner.stage_candidate(sig)
                if staged is not None:
                    break
            # one attempt per burn episode, staged or not: a sustained
            # burn must not re-run the search every idle tick
            self._retuned.update(self.retune_wanted)
            self.retune_wanted.clear()
            if staged is not None:
                with self._lock:
                    self.staged.append(staged)
                self._decide("retune_staged", **staged)
        return res

    # -- rollouts -------------------------------------------------------- #

    def run_rollout(self, cfg) -> dict:
        """Run one safe rollout (control/rollout.py) and record its
        outcome. The caller supplies the RolloutConfig (probe spec,
        candidate/validated paths, observation knobs)."""
        from heat2d_tpu_torch.control.rollout import Rollout
        self._decide("rollout", epoch=_db_epoch(cfg.candidate_path))
        self._rollout_active = True
        try:
            out = Rollout(self.fleet, cfg, policy=self.policy,
                          registry=self.registry).run()
        finally:
            self._rollout_active = False
        with self._lock:
            self.rollouts.append(out)
        return out

    # -- the record ------------------------------------------------------ #

    def serving_invariant(self, gens=None) -> dict:
        """The chaos gate's assertion: across every worker generation
        the supervisor ever saw ready, only generations spawned BY a
        rollout (``via="rollout"`` with an env overlay) may report a
        non-validated tune db — a crash/monitor restart must always
        rejoin on the validated incumbent. Pass ``gens`` to evaluate
        an already-taken snapshot (``summary()`` does, so its verdict
        and the generation log it rides with describe the SAME set)."""
        if gens is None:
            gens = self.fleet.sup.generations_snapshot()
        violations = [
            g for g in gens
            if not (g.get("via") == "rollout" and g.get("overlay"))
            and g.get("tune") is not None
            and not g["tune"].get("validated", True)]
        return {"generations": len(gens),
                "unvalidated_serving": violations,
                "no_unvalidated_serving": not violations}

    def summary(self) -> dict:
        """The ``kind="control"`` run-record payload."""
        with self._lock:
            out = {
                "decisions": list(self.decisions),
                "rollouts": list(self.rollouts),
                "staged": list(self.staged),
                "shed_active": self._shed_active,
            }
        gens = self.fleet.sup.generations_snapshot()
        out.update(self.serving_invariant(gens))
        out["generation_log"] = gens
        if self.actuator is not None:
            out["autoscale"] = self.actuator.summary()
        return out


def _db_epoch(path: str) -> int:
    """The epoch stamp of the db at ``path`` (0 when absent)."""
    from heat2d_tpu_torch.tune.db import TuningDB
    return TuningDB(path).epoch
