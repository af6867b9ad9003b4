"""Capacity model — from a measured latency/throughput surface to
"chips needed for N req/s at this SLO". The port's copy of
``heat2d_tpu/load/capacity.py``: the same model string and arithmetic,
so a surface gives the same fit in either package.

The reference's report answers sizing questions by table lookup over
19 hand-built benchmark tables; the serving analogue is a fitted
model over the sweep the load runner measures. The model is
deliberately simple and stated in the record so its assumptions are
auditable:

1. A sweep point QUALIFIES when the target kept up (achieved within
   ``keepup_margin`` of offered), shed at most ``max_shed_rate``, and
   met its SLO (p99 target + error budget, when one was given).
2. **Max sustainable throughput** = the largest qualifying offered
   rate's achieved req/s. If the TOP sweep point qualifies the system
   never saturated and the fit is flagged ``saturated: false`` — the
   capacity is a lower bound, and sizing from it is conservative.
3. **Per-unit rate** = max sustainable / serving units (fleet
   workers, or the cards a mesh engine spans — the target says which
   it counted), assuming near-linear unit scaling serve-side;
   ``units_for(N)`` is then a ceiling division.

``fit_capacity`` is pure arithmetic over surface rows — no clocks, no
torch — so it is unit-testable against synthetic sweeps with known
capacity.
"""

from __future__ import annotations

import math
from typing import List, Optional

CAPACITY_MODEL = "heat2d-tpu/capacity-linear-per-unit/v1"


def _qualifies(row: dict, keepup_margin: float,
               max_shed_rate: float) -> bool:
    if row.get("offered_rps", 0.0) <= 0:
        return False
    keepup = row.get("achieved_rps", 0.0) \
        >= (1.0 - keepup_margin) * row["offered_rps"]
    shed_ok = row.get("shed_rate", 0.0) <= max_shed_rate
    slo_ok = bool(row.get("slo_ok", True))
    return keepup and shed_ok and slo_ok


def fit_capacity(rows: List[dict], units: int, *,
                 chips_per_unit: int = 1,
                 keepup_margin: float = 0.2,
                 max_shed_rate: float = 0.01) -> dict:
    """Fit the capacity model over surface ``rows`` (each carrying
    ``offered_rps`` / ``achieved_rps`` / ``shed_rate`` / ``slo_ok``).
    Returns the fit dict published into ``kind="load"`` run records
    and gate baselines.

    ``chips_per_unit``: devices behind ONE serving unit — 1 for the
    classic single-chip targets, the mesh size when the mesh engine is
    active (a mesh ``ServeTarget`` is one unit spanning N chips), so
    the fit (and ``advise``) can speak in chips, not just workers."""
    if units < 1:
        raise ValueError(f"units must be >= 1, got {units}")
    if chips_per_unit < 1:
        raise ValueError(f"chips_per_unit must be >= 1, got "
                         f"{chips_per_unit}")
    ranked = sorted(rows, key=lambda r: r.get("offered_rps", 0.0))
    qualifying = [r for r in ranked
                  if _qualifies(r, keepup_margin, max_shed_rate)]
    if qualifying:
        best = qualifying[-1]
        max_rps = best["achieved_rps"]
        saturated = best is not ranked[-1]
    else:
        max_rps, saturated = 0.0, True
    per_unit = max_rps / units
    chips = units * chips_per_unit
    return {
        "model": CAPACITY_MODEL,
        "units": int(units),
        "chips_per_unit": int(chips_per_unit),
        "chips": int(chips),
        "points": len(ranked),
        "qualifying_points": len(qualifying),
        "max_sustainable_rps": round(max_rps, 4),
        "per_unit_rps": round(per_unit, 4),
        "per_chip_rps": round(max_rps / chips, 4),
        #: False == the sweep never found the knee: capacity is a
        #: LOWER bound (every offered rate qualified)
        "saturated": bool(saturated),
        "criteria": {"keepup_margin": keepup_margin,
                     "max_shed_rate": max_shed_rate},
    }


def units_for(fit: dict, target_rps: float) -> Optional[int]:
    """Serving units needed to sustain ``target_rps`` under the
    fitted per-unit rate (the "chips for N req/s" answer). ``None``
    when the fit found no sustainable point — the model cannot size
    what it never saw succeed."""
    per_unit = fit.get("per_unit_rps", 0.0)
    if per_unit <= 0:
        return None
    return max(1, math.ceil(target_rps / per_unit))


def chips_for(fit: dict, target_rps: float) -> Optional[int]:
    """``units_for`` stated in CHIPS: units x the fit's
    ``chips_per_unit`` (1 on pre-mesh fits, so the two answers agree
    wherever both exist)."""
    units = units_for(fit, target_rps)
    if units is None:
        return None
    return units * int(fit.get("chips_per_unit", 1))


def sustainable_at(fit: dict, units: int) -> float:
    """The model's predicted sustainable req/s at ``units`` serving
    units (linear extrapolation from the fitted per-unit rate)."""
    return round(fit.get("per_unit_rps", 0.0) * units, 4)


def advise(fit: dict, observed_rps: float, current_units: int) -> dict:
    """Capacity advice for the control plane: under
    sustained SLO burn, how many serving units the fitted model says
    the OBSERVED rate needs vs what is deployed. Pure arithmetic — the
    plane records the advice; acting on it (adding chips/workers) is
    an operator/orchestrator decision, deliberately outside the loop
    this repo automates. ``needed_units`` is None when the model never
    saw a sustainable point; an unsaturated fit makes the advice
    conservative (the fit is a lower bound)."""
    need = units_for(fit, observed_rps)
    cpu = int(fit.get("chips_per_unit", 1))
    return {
        "model": fit.get("model"),
        "observed_rps": round(float(observed_rps), 4),
        "current_units": int(current_units),
        "needed_units": need,
        "add_units": (None if need is None
                      else max(0, need - int(current_units))),
        # the same advice in CHIPS (mesh engines span chips_per_unit
        # devices per serving unit; 1 everywhere else, where these
        # rows equal the unit rows)
        "chips_per_unit": cpu,
        "current_chips": int(current_units) * cpu,
        "needed_chips": None if need is None else need * cpu,
        "fit_saturated": bool(fit.get("saturated", True)),
        "sustainable_at_current": sustainable_at(fit, current_units),
    }
