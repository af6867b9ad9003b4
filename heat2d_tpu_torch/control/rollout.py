"""Safe tuning rollout — canary, bitwise parity, observation,
promote-or-revert (the port of ``heat2d_tpu/control/rollout.py``).

A staged candidate db (control/retuner.py) reaches the fleet
worker-by-worker, and every gate between the stages is MEASURED, not
scheduled:

1. **baseline** — probe an incumbent worker (``FleetServer.probe``:
   targeted, cache-bypassing) and keep its answer bytes: the bitwise
   reference every later parity check compares against.
2. **canary** — restart ONE worker with the candidate db handed in as
   a one-generation env overlay (``Supervisor.restart_worker``). The
   overlay is the safety property: a crash restart — including a kill
   storm landing right now — rebuilds the worker env from the durable
   config, so the failure path can only ever resurrect the VALIDATED
   incumbent, never the candidate.
3. **parity** — the canary must answer the probe bitwise-identically
   to the incumbent. A tuned config that changes a single bit is a
   different program, not a faster one; mismatch reverts immediately.
4. **observe** — for ``observe_s``, paired canary/incumbent probes
   measure relative latency while a ``BurnWindow`` (obs/slo.py) watches
   the fleet's per-signature SLO burn. A sustained burn, a canary
   latency regression past ``latency_ratio`` x the incumbent, a probe
   failure, or the canary LOSING ITS CANDIDATE (a storm restarted it
   onto the incumbent — nothing left to observe) all revert.
5. **promote** — the candidate is stamped ``validated`` at its epoch,
   atomically becomes the content of the validated path, and the
   remaining workers (canary included — it still points at the
   candidate FILE) are deliberately restarted one at a time onto the
   durable env. Every restart from here on, deliberate or crash,
   loads the newly validated db.
6. **revert** — the canary is restarted onto the durable env (if a
   storm has not already done so) and re-probed: the post-revert
   answer must be BITWISE the pre-rollout baseline, asserted in the
   outcome the control gate reads (the fleet CLI's control legs,
   ``chip_smoke.py``'s ``control`` phase).

``resil.chaos.rollout_point`` is announced at each window boundary so
a chaos campaign (``HEAT2D_CHAOS_ROLLOUT_KILL_PHASE``) can land a
kill storm at the worst possible moment; the storm callback kills
workers through the supervisor, never the control plane itself.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional

from heat2d_tpu_torch.obs import slo
from heat2d_tpu_torch.resil import chaos
from heat2d_tpu_torch.resil.retry import wait_for
from heat2d_tpu_torch.serve.schema import Rejected, SolveRequest
from heat2d_tpu_torch.tune.db import TuningDB

log = logging.getLogger("heat2d_tpu_torch.control")


@dataclasses.dataclass(frozen=True)
class RolloutConfig:
    """One rollout's knobs. ``probe_spec`` is the canonical request
    dict (serve/schema.py) parity and latency probes solve: on the card
    a one-member request on method ``pallas`` is the one whose launch
    takes a candidate's H5 chunk depth K (``models.ensemble.
    tuned_config``); ``extra_canary_env`` rides the canary's
    one-generation overlay (the control gate injects a deliberately-bad
    candidate through it, ``HEAT2D_CHAOS_SLOW_WORKER_S``-style)."""

    candidate_path: str
    validated_path: str
    probe_spec: dict
    observe_s: float = 2.0
    observe_probes: int = 4
    latency_ratio: float = 3.0
    latency_floor_s: float = 0.25
    burn_threshold: float = 1.0
    sustain: int = 2
    probe_timeout: float = 60.0
    ready_timeout: float = 120.0
    extra_canary_env: dict = dataclasses.field(default_factory=dict)


def _median(xs: list) -> float:
    s = sorted(xs)
    return s[len(s) // 2] if s else float("inf")


class Rollout:
    """Execute one rollout end to end (``run()``); the control plane
    threads it beside live traffic. All decisions and probe digests
    land in the returned summary — the ``rollouts`` rows of the
    ``kind="control"`` run record."""

    def __init__(self, fleet, cfg: RolloutConfig, *,
                 policy: Optional[slo.SLOPolicy] = None, registry=None):
        self.fleet = fleet
        self.cfg = cfg
        self.policy = policy or slo.SLOPolicy(latency_p99_s=30.0)
        self.registry = (registry if registry is not None
                         else getattr(fleet, "registry", None))
        self.out: dict = {"phases": [], "outcome": None,
                          "canary": None, "epoch": None,
                          "post_revert_parity": None}
        self._pre_bytes: Optional[bytes] = None

    # -- helpers -------------------------------------------------------- #

    def _phase(self, name: str, **fields) -> None:
        self.out["phases"].append({"phase": name, **fields})
        log.info("rollout phase %s %s", name, fields or "")

    def _storm_cb(self, n: int):
        """The chaos hook's kill action: hard-kill ``n`` alive workers
        (0 = all) through the supervisor — the monitor's normal death
        path then fences, replays, and restarts them from the DURABLE
        env."""
        alive = self.fleet.sup.alive_slots()
        targets = alive if not n else alive[:n]
        log.warning("chaos storm: killing worker(s) %s mid-rollout",
                    targets)
        for s in targets:
            self.fleet.sup.kill_worker(s)

    def _probe(self, slot: int):
        """(bytes, latency_s) of one targeted probe, or (None, reason)
        on failure."""
        import numpy as np
        req = SolveRequest.from_dict(dict(self.cfg.probe_spec))
        t0 = time.monotonic()
        try:
            res = self.fleet.probe(
                slot, req, timeout=self.cfg.probe_timeout).result(
                self.cfg.probe_timeout + 30)
        except Rejected as e:
            return None, e.code
        except Exception as e:  # noqa: BLE001 — a probe failure is a
            #                     rollout decision, not a crash
            return None, repr(e)
        return np.asarray(res.u).tobytes(), time.monotonic() - t0

    def _wait_ready(self, slot: int, *, want_path: Optional[str],
                    deadline_s: float) -> Optional[dict]:
        """Poll until ``slot`` is alive+ready (and, when ``want_path``
        is given, reporting that tune-db path). Returns the worker's
        ready info, or None on timeout. Deadline semantics via
        ``resil.retry.wait_for`` — the one injectable-clock dispatch-
        guard convention (the supervisor's clock, when it has one)."""
        found: list = []

        def check() -> bool:
            if slot not in self.fleet.sup.alive_slots():
                return False
            info = self.fleet.sup.worker_info(slot)
            if info is None:
                return False
            path = (info.get("tune") or {}).get("path")
            if want_path is None or path == want_path:
                found.append(info)
                return True
            return False

        if wait_for(check, deadline_s, clock=self.fleet.sup.clock,
                    poll=0.05):
            return found[-1]
        return None

    def _canary_still_candidate(self, slot: int) -> bool:
        info = self.fleet.sup.worker_info(slot)
        return (info is not None
                and (info.get("tune") or {}).get("path")
                == self.cfg.candidate_path)

    def _count_outcome(self, outcome: str) -> None:
        if self.registry is not None:
            self.registry.counter("control_rollouts_total",
                                  outcome=outcome)

    # -- the state machine ---------------------------------------------- #

    def run(self) -> dict:
        cfg = self.cfg
        candidate = TuningDB(cfg.candidate_path)
        self.out["epoch"] = candidate.epoch
        if candidate.validated:
            return self._abort("candidate is already validated — "
                               "nothing to roll out")
        alive = self.fleet.sup.alive_slots()
        if len(alive) < 2:
            return self._abort(
                f"need >= 2 alive workers to canary (have "
                f"{len(alive)}): an incumbent must keep serving while "
                f"the canary proves itself")
        canary, incumbent = alive[-1], alive[0]
        self.out["canary"] = canary

        # 1 -- baseline: the bitwise reference, from an incumbent
        pre, lat = self._probe(incumbent)
        if pre is None:
            return self._abort(f"baseline probe failed: {lat}")
        self._pre_bytes = pre
        self._phase("baseline", incumbent=incumbent,
                    latency_s=round(lat, 6))

        # 2 -- canary: one worker, candidate db, ONE-generation overlay
        chaos.rollout_point("canary", self._storm_cb)
        overlay = {"HEAT2D_TUNE_DB": cfg.candidate_path,
                   **cfg.extra_canary_env}
        self.fleet.sup.restart_worker(canary, env_overlay=overlay)
        info = self._wait_ready(canary, want_path=cfg.candidate_path,
                                deadline_s=cfg.ready_timeout)
        if info is None:
            # a storm may have raced the spawn: whatever runs in the
            # slot now came from the durable env — revert formally so
            # the record carries the post-revert parity proof
            return self._revert(canary, "canary_never_ready")
        tune = info.get("tune") or {}
        self._phase("canary", slot=canary, tune=tune,
                    overlay_keys=sorted(overlay))
        if tune.get("validated", True) or tune.get("epoch") \
                != candidate.epoch:
            return self._revert(canary, "canary_stamp_mismatch")

        # 3 -- parity: bitwise, or it never rolls
        chaos.rollout_point("parity", self._storm_cb)
        got, lat = self._probe(canary)
        if got is None:
            return self._revert(canary, f"parity_probe_failed:{lat}")
        match = got == pre
        if self.registry is not None:
            self.registry.counter("control_probe_parity_total",
                                  result="match" if match
                                  else "mismatch")
        self._phase("parity", match=match, latency_s=round(lat, 6))
        if not match:
            return self._revert(canary, "parity_mismatch")

        # 4 -- observe: paired probes + windowed SLO burn
        chaos.rollout_point("observe", self._storm_cb)
        burn = slo.BurnWindow(self.policy, prefix="fleet",
                              threshold=cfg.burn_threshold,
                              sustain=cfg.sustain)
        burn.tick(self.registry)            # baseline window
        can_lat, inc_lat = [], []
        pause = max(0.05, cfg.observe_s / max(1, cfg.observe_probes))
        t_end = time.monotonic() + cfg.observe_s
        while True:
            time.sleep(pause)
            if not self._canary_still_candidate(canary):
                # a storm took the canary: its replacement rejoined on
                # the durable (validated) env — by construction nothing
                # unvalidated is serving, and there is nothing left to
                # observe
                return self._revert(canary, "canary_lost_in_storm")
            b, lc = self._probe(canary)
            if b is None:
                return self._revert(canary, f"canary_probe_failed:{lc}")
            if b != pre:
                return self._revert(canary, "parity_drift_in_observe")
            _b2, li = self._probe(incumbent)
            if _b2 is not None:
                inc_lat.append(li)
            can_lat.append(lc)
            sustained = burn.sustained(burn.tick(self.registry))
            if sustained:
                self._phase("observe", burned=sustained)
                return self._revert(canary, "slo_burn")
            if time.monotonic() >= t_end:
                break
        if not inc_lat:
            # no incumbent sample landed (it died/restarted all
            # window): there is no baseline to judge the canary
            # against, and "no evidence" reverts — an unbounded bar
            # would wave an arbitrarily slow canary through
            return self._revert(canary, "no_incumbent_latency")
        cm, im = _median(can_lat), _median(inc_lat)
        bar = max(cfg.latency_ratio * im, cfg.latency_floor_s)
        self._phase("observe", canary_median_s=round(cm, 6),
                    incumbent_median_s=round(im, 6),
                    bar_s=round(bar, 6), probes=len(can_lat))
        if cm > bar:
            return self._revert(canary, "latency_regression")

        # 5 -- promote: candidate becomes the validated epoch, then
        # every worker deliberately restarts onto it, one at a time
        chaos.rollout_point("promote", self._storm_cb)
        candidate = TuningDB(cfg.candidate_path)
        if candidate.epoch != self.out["epoch"] or candidate.validated:
            # the file changed under us (a concurrent re-stage, an
            # external writer): whatever it now holds was NEVER
            # canaried — promoting it would validate unproven content
            return self._revert(canary, "candidate_changed_mid_rollout")
        candidate.mark_entries(validated=True, epoch=candidate.epoch)
        candidate.stamp_rollout(epoch=candidate.epoch, validated=True)
        candidate.save()
        validated = TuningDB(cfg.validated_path)
        import copy as _copy
        validated.data = _copy.deepcopy(candidate.data)
        validated.save()        # atomic: tmp + fsync + os.replace
        if self.registry is not None:
            self.registry.gauge("control_epoch", candidate.epoch)
        self._phase("promote", epoch=candidate.epoch)
        rolled = []
        for slot in list(self.fleet.sup.alive_slots()):
            # the canary re-rolls too: it must leave the candidate
            # FILE for the validated path like everyone else
            self.fleet.sup.restart_worker(slot)
            if self._wait_ready(slot, want_path=None,
                                deadline_s=cfg.ready_timeout) is None:
                log.warning("slot %d slow to rejoin after promote "
                            "(the monitor will keep restarting it)",
                            slot)
            rolled.append(slot)
        self._phase("roll", slots=rolled)
        self.out["outcome"] = "promoted"
        self._count_outcome("promoted")
        return self.out

    # -- failure exits --------------------------------------------------- #

    def _abort(self, reason: str) -> dict:
        """Pre-canary failure: nothing was changed, nothing to revert."""
        self._phase("abort", reason=reason)
        self.out["outcome"] = f"aborted:{reason.split(' ')[0]}"
        self.out["reason"] = reason
        self._count_outcome("aborted")
        return self.out

    def _revert(self, canary: int, reason: str) -> dict:
        """Auto-revert: put the canary back on the durable (validated)
        env — unless a storm already did — and PROVE the revert with a
        bitwise post-revert probe against the pre-rollout baseline.
        The still-candidate check re-runs AFTER every wait: a canary
        whose spawn outlived its ready window surfaces the candidate
        db only once it finally reports ready, and leaving it serving
        would be exactly the non-validated leak this subsystem
        exists to prevent."""
        log.warning("rollout auto-revert: %s", reason)
        deadline = time.monotonic() + self.cfg.ready_timeout
        post = None
        while True:
            if self._canary_still_candidate(canary):
                self.fleet.sup.restart_worker(canary)
            left = deadline - time.monotonic()
            if left <= 0:
                break
            if self._wait_ready(canary, want_path=None,
                                deadline_s=left) is None:
                break           # never came up: parity stays unproven
            if self._canary_still_candidate(canary):
                continue        # late candidate spawn: restart it
            post, _lat = self._probe(canary)
            break
        parity = (post is not None and self._pre_bytes is not None
                  and post == self._pre_bytes)
        self.out["post_revert_parity"] = parity
        self._phase("revert", reason=reason, parity=parity)
        self.out["outcome"] = f"reverted:{reason}"
        self._count_outcome("reverted")
        if self.registry is not None:
            self.registry.counter("control_probe_parity_total",
                                  result="match" if parity
                                  else "mismatch")
        return self.out
