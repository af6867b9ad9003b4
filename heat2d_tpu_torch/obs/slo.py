"""Per-signature SLO objectives: latency targets and error-budget burn,
computed from the metrics registry. The port's copy of
``heat2d_tpu/obs/slo.py``: fed the same registry, both give the same rows
and gauges.

An SLO is a promise per signature: "p99 end-to-end latency under T
seconds, failure ratio under B". The server already records what it
needs (``serve_signature_latency_s{signature=...}`` and the
per-signature outcome counters), so evaluation is registry arithmetic,
run at export time (the serve CLI calls it once before writing the run
record), never on the serving path.

Burn rate is the SRE convention, ``error_rate / error_budget``: 1.0
spends the budget exactly as fast as allowed, more than 1 violates the
objective if the rate holds. Results are exported as ``slo_*`` gauges
and as the ``slo`` rows of the run record."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

#: outcomes that spend error budget: structured rejections that mean
#: the SERVER failed the request (shed/timeout/fault), not that the
#: request was invalid.
FAILURE_OUTCOMES_EXCLUDED = ("completed", "cache_hit", "coalesced",
                             "rejected_invalid")


@dataclasses.dataclass(frozen=True)
class SLOPolicy:
    """One objective: a p99 latency target (seconds) and an error
    budget (allowed failure fraction, e.g. 0.001 == 99.9%)."""

    latency_p99_s: float
    error_budget: float = 0.001

    def __post_init__(self):
        if self.latency_p99_s <= 0:
            raise ValueError(f"latency_p99_s must be > 0, got "
                             f"{self.latency_p99_s}")
        if not (0 < self.error_budget <= 1):
            raise ValueError(f"error_budget must be in (0, 1], got "
                             f"{self.error_budget}")


def evaluate(registry, *, prefix: str = "serve",
             default: Optional[SLOPolicy] = None,
             policies: Optional[Dict[str, SLOPolicy]] = None) -> list:
    """Evaluate SLOs against the ``<prefix>_signature_*`` families.

    ``policies`` maps signature strings to objectives; ``default``
    covers every signature not named (None = signatures without a
    policy are reported but not judged). Returns one row per observed
    signature and exports the ``slo_*`` gauges as a side effect."""
    policies = policies or {}
    rows = []
    hists = registry.find_histograms(prefix + "_signature_latency_s")
    counts = registry.find_counters(prefix + "_signature_requests_total")

    sigs = sorted(({dict(k).get("signature") for k in hists}
                   | {dict(k).get("signature") for k in counts})
                  - {None})
    for sig in sigs:
        pol = policies.get(sig, default)
        summary = None
        for k, v in hists.items():
            if dict(k).get("signature") == sig:
                summary = v
                break
        total = failures = 0.0
        for k, v in counts.items():
            kd = dict(k)
            if kd.get("signature") != sig:
                continue
            total += v
            if kd.get("outcome") not in FAILURE_OUTCOMES_EXCLUDED:
                failures += v
        row = {
            "signature": sig,
            "requests": total,
            "failures": failures,
            "error_rate": (failures / total) if total else 0.0,
            "p50_s": summary["p50"] if summary else None,
            "p99_s": summary["p99"] if summary else None,
        }
        if pol is not None and total == 0:
            # Zero traffic: there is nothing to judge. A burn rate of
            # 0/0 is not "healthy", it is ABSENT — no slo_burn_rate
            # gauge, and no ok verdict AT ALL: consumers uniformly do
            # ``row.get("ok", True)`` (serve CLI violation print, the
            # load gate's slo_ok), so the verdict key must be MISSING,
            # not None — a None would read as a violation and fail a
            # gate over a route nobody called. The row still reports
            # the objective so the signature's silence is visible.
            row.update(latency_target_p99_s=pol.latency_p99_s,
                       error_budget=pol.error_budget)
        elif pol is not None:
            burn = row["error_rate"] / pol.error_budget
            latency_ok = (summary is None
                          or summary["p99"] <= pol.latency_p99_s)
            row.update(
                latency_target_p99_s=pol.latency_p99_s,
                latency_ok=latency_ok,
                error_budget=pol.error_budget,
                burn_rate=burn,
                budget_ok=burn <= 1.0,
                ok=latency_ok and burn <= 1.0)
            if registry is not None:
                if summary is not None:
                    # no latency samples (e.g. every request failed):
                    # no p99 gauge — a NaN would poison strict JSON
                    # consumers of the metrics snapshot
                    registry.gauge("slo_latency_p99_s",
                                   summary["p99"], signature=sig)
                registry.gauge("slo_latency_target_s",
                               pol.latency_p99_s, signature=sig)
                registry.gauge("slo_burn_rate", burn, signature=sig)
                registry.gauge("slo_ok", 1.0 if row["ok"] else 0.0,
                               signature=sig)
        rows.append(row)
    return rows


def stamp_record(extra: dict, rows: list) -> dict:
    """Attach the SLO evaluation to a run-record payload IN PLACE
    (returns it) — the ``slo`` schema row in docs/OBSERVABILITY.md."""
    extra["slo"] = rows
    return extra


class BurnWindow:
    """Windowed, SUSTAINED burn-rate detection (the JAX package's
    control-plane trigger; the port's ``control/`` is still to come).

    ``evaluate`` above is cumulative: ten minutes of clean serving
    dilute a current outage below any threshold. The control plane
    needs the opposite — the burn rate *right now*, held long enough
    to act on. ``tick(registry)`` differentiates the per-signature
    outcome counters since the previous tick (one tick == one window),
    computes each signature's windowed ``error_rate / error_budget``,
    and tracks a consecutive-window streak per signature: a signature
    is **sustained** once its burn exceeded ``threshold`` for
    ``sustain`` ticks in a row. One clean window resets the streak; a
    ZERO-TRAFFIC window is no evidence either way — it neither grows
    nor resets the streak (and, like ``evaluate``, contributes no
    burn gauge).

    Windowed burns are exported as ``slo_windowed_burn_rate``
    gauges beside the cumulative ``slo_burn_rate`` family."""

    def __init__(self, policy: SLOPolicy, *, prefix: str = "fleet",
                 threshold: float = 1.0, sustain: int = 2):
        if sustain < 1:
            raise ValueError(f"sustain must be >= 1, got {sustain}")
        if threshold <= 0:
            raise ValueError(
                f"threshold must be > 0, got {threshold}")
        from heat2d_tpu_torch.obs.metrics import CounterDeltas
        self.policy = policy
        self.prefix = prefix
        self.threshold = threshold
        self.sustain = sustain
        self._deltas = CounterDeltas()
        self._streak: Dict[str, int] = {}

    def tick(self, registry) -> Dict[str, dict]:
        """One window: {signature: {requests, failures, burn_rate,
        windows, sustained}}. ``burn_rate`` is None on a zero-traffic
        window; a registry-less caller gets an empty window, not a
        crash."""
        if registry is None:
            return {}
        totals: Dict[str, list] = {}
        for k, d in self._deltas.tick(
                registry,
                self.prefix + "_signature_requests_total").items():
            kd = dict(k)
            sig = kd.get("signature")
            if sig is None:
                continue
            t = totals.setdefault(sig, [0.0, 0.0])
            t[0] += d
            if kd.get("outcome") not in FAILURE_OUTCOMES_EXCLUDED:
                t[1] += d
        out: Dict[str, dict] = {}
        for sig, (dt, df) in sorted(totals.items()):
            if dt <= 0:
                streak = self._streak.get(sig, 0)
                out[sig] = {"requests": 0.0, "failures": 0.0,
                            "burn_rate": None, "windows": streak,
                            "sustained": streak >= self.sustain}
                continue
            burn = (df / dt) / self.policy.error_budget
            streak = (self._streak.get(sig, 0) + 1
                      if burn > self.threshold else 0)
            self._streak[sig] = streak
            registry.gauge("slo_windowed_burn_rate", burn,
                           signature=sig)
            out[sig] = {"requests": dt, "failures": df,
                        "burn_rate": burn, "windows": streak,
                        "sustained": streak >= self.sustain}
        return out

    def sustained(self, result: Optional[Dict[str, dict]] = None) -> list:
        """Signatures currently over their sustain threshold. Pass a
        ``tick`` result to avoid consuming a fresh window."""
        if result is not None:
            return sorted(s for s, r in result.items() if r["sustained"])
        return sorted(s for s, n in self._streak.items()
                      if n >= self.sustain)
