"""Continuous retuner: re-measure hot signatures off-peak, stage
candidates (the port of ``heat2d_tpu/control/retuner.py``).

The fleet's router already knows per-signature demand (the
``fleet_signature_requests_total`` counters it feeds ``obs/slo.py``
with), and ``tune/`` already owns measurement (``measure_candidate``)
and persistence (``TuningDB``). The retuner closes the gap between them:

1. **What to tune**: the hottest signatures by windowed request-count
   delta (cumulative counters differentiated per call, so a signature
   that WAS hot yesterday does not dominate forever).
2. **When to tune**: off-peak only. A measurement on the card runs on
   the card the workers serve from, so staging waits until the router's
   in-flight count sits at or below ``idle_inflight``.
3. **What it produces**: a CANDIDATE ``TuningDB`` at ``candidate_path``,
   stamped ``validated=False`` at epoch ``incumbent + 1`` (``tune/db.py``
   rollout provenance). Staging never touches the validated db: only a
   rollout's promote step does (``control/rollout.py``), and only after
   the canary proved the candidate bitwise-compatible and SLO-clean.

Measurement defaults to the deterministic ``SimulatedBackend``, as in
the JAX package (the search logic is the subject; its entries are keyed
under the simulated card's kind, ``"sim-h100"``, so no worker on a real
card takes them). Pass ``backend=None`` to measure on ``device`` through
``tune/measure`` (the card by default): that candidate's entries are
keyed under the card's name, and a canary serving it runs the measured
plan.
"""

from __future__ import annotations

import ast
import copy
import io
import logging
from typing import Optional

from heat2d_tpu_torch.tune.db import TuningDB

log = logging.getLogger("heat2d_tpu_torch.control")


def problem_from_signature(sig_str: str):
    """The tune-space ``Problem`` for a serve signature string, or None
    for signatures that carry no kernel shape to tune (inverse requests
    tune through their forward solves). Signature strings are
    ``str(req.signature())``: literal Python tuples (the same contract
    ``load/replay.py`` parses)."""
    from heat2d_tpu_torch.tune.space import Problem
    try:
        sig = ast.literal_eval(sig_str)
    except (ValueError, SyntaxError):
        return None
    if not isinstance(sig, tuple) or not sig or sig[0] == "inverse":
        return None
    try:
        nx, ny = int(sig[0]), int(sig[1])
        dtype = str(sig[3]) if len(sig) > 3 else "float32"
    except (TypeError, ValueError, IndexError):
        return None
    return Problem(nx, ny, dtype=dtype)


class Retuner:
    """Stage candidate tuning dbs for the control plane's rollouts.
    ``fleet`` needs only a registry and a ``_total_inflight``-bearing
    router surface (``FleetServer``, or a test double). ``device``: where
    a ``backend=None`` search measures (the card unless ``"cpu"``, which
    ``tune.cli.search_problem`` refuses)."""

    def __init__(self, fleet, *, candidate_path: str,
                 validated_path: str, backend="simulated",
                 idle_inflight: int = 2, registry=None,
                 device: str = "cuda"):
        from heat2d_tpu_torch.obs.metrics import CounterDeltas
        from heat2d_tpu_torch.tune.measure import SimulatedBackend
        self.fleet = fleet
        self.candidate_path = str(candidate_path)
        self.validated_path = str(validated_path)
        self.backend = (SimulatedBackend() if backend == "simulated"
                        else backend)
        self.idle_inflight = idle_inflight
        self.device = device
        self.registry = (registry if registry is not None
                         else getattr(fleet, "registry", None))
        self._deltas = CounterDeltas()

    # -- the router's demand signal ------------------------------------- #

    def hot_signatures(self) -> list:
        """[(signature string, requests since last call)], hottest
        first, from the fleet's per-signature outcome counters."""
        reg = getattr(self.fleet, "registry", None)
        if reg is None:
            return []
        per_sig: dict = {}
        for k, d in self._deltas.tick(
                reg, "fleet_signature_requests_total").items():
            sig = dict(k).get("signature")
            if sig is not None and d > 0:
                per_sig[sig] = per_sig.get(sig, 0.0) + d
        return sorted(per_sig.items(), key=lambda p: -p[1])

    def off_peak(self) -> bool:
        """True when the router is idle enough that a measurement cannot
        contend with client traffic."""
        return (getattr(self.fleet, "_total_inflight", 0)
                <= self.idle_inflight)

    # -- staging --------------------------------------------------------- #

    def stage_candidate(self, sig_str: str) -> Optional[dict]:
        """Re-measure one signature's shape and stage the result as a
        candidate db. Returns the staging summary ({signature, problem,
        epoch, best, measured, path}) or None when the signature has
        nothing to tune. The candidate db is seeded from the VALIDATED
        incumbent (shapes the retune did not touch keep their proven
        configs) and restamped ``validated=False`` at the next epoch."""
        problem = problem_from_signature(sig_str)
        if problem is None:
            return None
        from heat2d_tpu_torch.tune.cli import search_problem

        incumbent = TuningDB(self.validated_path)
        candidate = TuningDB(self.candidate_path)
        # the candidate starts as a copy of the incumbent: a rollout
        # replaces the WHOLE db a worker loads, so untouched shapes must
        # ride along unchanged
        candidate.data = copy.deepcopy(incumbent.data)
        epoch = incumbent.epoch + 1
        summary = search_problem(candidate, problem, backend=self.backend,
                                 registry=self.registry,
                                 device=self.device, out=io.StringIO())
        candidate.mark_entries(validated=False, epoch=epoch)
        candidate.stamp_rollout(epoch=epoch, validated=False)
        candidate.save()
        if self.registry is not None:
            self.registry.counter("control_retunes_total")
        log.info("staged candidate epoch %d for %s at %s (best %s)",
                 epoch, sig_str, self.candidate_path, summary.get("best"))
        return {"signature": sig_str, "problem": summary.get("problem"),
                "epoch": epoch, "best": summary.get("best"),
                "measured": summary.get("measured"),
                "path": self.candidate_path}
