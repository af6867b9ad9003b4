"""The serving-regression gate — a committed baseline surface vs the
measured one, with explicit margins. The port's copy of
``heat2d_tpu/load/gate.py``: the same baseline schema string and
failure texts, so a baseline document from either package gates in the
other. The port's card baseline is ``load/baseline_h100.json``,
measured on an H100 by ``chip_smoke.py``'s load phase.

``heat2d-tpu-torch-load --gate --baseline FILE`` compares a measured
surface point-by-point against a committed BENCH-style JSON and fails
on a serving regression — before production does.

Margins are deliberately explicit and generous-by-default: the gate
runs on shared hosts whose absolute speed varies run to run, so
each check is stated as "no worse than baseline by MORE than the
margin" rather than an absolute bound. A genuine regression (a chaos-
slowed worker, a batching bug, an accidental serial path) moves the
surface by multiples, not percentages — the margins separate noise
from signal:

- **throughput** — achieved req/s >= (1 - margin) x baseline's;
- **latency** — p99 <= baseline p99 x factor + slack (the additive
  slack absorbs the near-zero baselines small CPU solves produce,
  where a pure ratio would gate on microseconds);
- **shedding** — shed rate <= baseline + slack;
- **capacity** — fitted max sustainable req/s >= (1 - margin) x
  baseline's fit.

Rows are matched by offered rate (nearest, within 25% relative) so a
baseline sweep and a measured sweep tolerate rate jitter; a measured
point with no baseline partner (or vice versa) is itself a failure —
a gate that silently skips points is not a gate.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

BASELINE_SCHEMA = "heat2d-tpu/load-baseline/v1"

#: relative offered-rate distance within which rows pair up
MATCH_TOLERANCE = 0.25


@dataclasses.dataclass(frozen=True)
class GateMargins:
    """The explicit no-worse-than-baseline bounds (module docstring
    for rationale)."""

    throughput_margin: float = 0.3
    p99_factor: float = 3.0
    p99_slack_s: float = 0.25
    shed_slack: float = 0.05
    capacity_margin: float = 0.5


def build_baseline(rows: List[dict], fit: dict,
                   meta: Optional[dict] = None) -> dict:
    """The committed-baseline document for a measured surface: the
    per-point numbers the gate compares plus the capacity fit and
    provenance meta (profile/seed/target — a baseline must say what
    workload produced it)."""
    return {
        "schema": BASELINE_SCHEMA,
        "meta": dict(meta or {}),
        "rows": [{
            "offered_rps": r["offered_rps"],
            "achieved_rps": r["achieved_rps"],
            "p99_s": (r.get("latency") or {}).get("p99"),
            "shed_rate": r["shed_rate"],
            "slo_ok": bool(r.get("slo_ok", True)),
        } for r in rows],
        "capacity": {
            "max_sustainable_rps": fit.get("max_sustainable_rps"),
            "per_unit_rps": fit.get("per_unit_rps"),
            "units": fit.get("units"),
        },
    }


def _match(baseline_rows: list, offered: float) -> Optional[dict]:
    best, dist = None, None
    for b in baseline_rows:
        off = b.get("offered_rps", 0.0)
        if off <= 0:
            continue
        d = abs(off - offered) / off
        if dist is None or d < dist:
            best, dist = b, d
    if best is None or dist > MATCH_TOLERANCE:
        return None
    return best


def compare(rows: List[dict], fit: dict, baseline: dict,
            margins: GateMargins = GateMargins()) -> List[str]:
    """Gate the measured surface+fit against ``baseline``; returns
    the failure list (empty == pass). Every failure names the point,
    the numbers, and the bound so a red gate line is actionable."""
    failures: List[str] = []
    if baseline.get("schema") != BASELINE_SCHEMA:
        return [f"baseline schema {baseline.get('schema')!r} != "
                f"{BASELINE_SCHEMA!r} — refusing to gate against an "
                f"unknown document"]
    brows = baseline.get("rows", [])
    if not brows:
        return ["baseline has no surface rows"]
    matched = 0
    for r in rows:
        off = r.get("offered_rps", 0.0)
        b = _match(brows, off)
        if b is None:
            failures.append(
                f"measured point {off:g} rps has no baseline partner "
                f"(baseline offered rates: "
                f"{[x['offered_rps'] for x in brows]})")
            continue
        matched += 1
        floor = (1.0 - margins.throughput_margin) * b["achieved_rps"]
        if r["achieved_rps"] < floor:
            failures.append(
                f"throughput regression at {off:g} rps offered: "
                f"achieved {r['achieved_rps']:g} < {floor:g} "
                f"(baseline {b['achieved_rps']:g}, margin "
                f"{margins.throughput_margin})")
        p99 = (r.get("latency") or {}).get("p99")
        bp99 = b.get("p99_s")
        if p99 is not None and bp99 is not None:
            limit = bp99 * margins.p99_factor + margins.p99_slack_s
            if p99 > limit:
                failures.append(
                    f"latency regression at {off:g} rps offered: p99 "
                    f"{p99:.4g}s > {limit:.4g}s (baseline "
                    f"{bp99:.4g}s x {margins.p99_factor} + "
                    f"{margins.p99_slack_s}s)")
        limit = b.get("shed_rate", 0.0) + margins.shed_slack
        if r.get("shed_rate", 0.0) > limit:
            failures.append(
                f"shed-rate regression at {off:g} rps offered: "
                f"{r['shed_rate']:.4g} > {limit:.4g} (baseline "
                f"{b.get('shed_rate', 0.0):.4g} + "
                f"{margins.shed_slack})")
    if matched == 0:
        failures.append("no measured point matched any baseline "
                        "point — the gate compared nothing")
    # the reverse direction: a baseline point nothing measured is a
    # silently-shrunk sweep, not a pass
    measured_offered = [r.get("offered_rps", 0.0) for r in rows]
    for b in brows:
        off = b.get("offered_rps", 0.0)
        if off > 0 and not any(
                abs(m - off) / off <= MATCH_TOLERANCE
                for m in measured_offered):
            failures.append(
                f"baseline point {off:g} rps was never measured "
                f"(measured offered rates: {measured_offered}) — "
                f"shrink the baseline, not the sweep")
    bcap = (baseline.get("capacity") or {}).get("max_sustainable_rps")
    mcap = fit.get("max_sustainable_rps", 0.0)
    if bcap:
        floor = (1.0 - margins.capacity_margin) * bcap
        if mcap < floor:
            failures.append(
                f"capacity regression: fitted max sustainable "
                f"{mcap:g} rps < {floor:g} (baseline {bcap:g}, "
                f"margin {margins.capacity_margin})")
    return failures
