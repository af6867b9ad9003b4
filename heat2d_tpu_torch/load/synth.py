"""Seeded synthetic workload generators — production-shaped traffic
from a seed. The port's copy of ``heat2d_tpu/load/synth.py``: the same
profiles and the same draws from one ``random.Random(seed)``, so a
(profile, rate, duration, seed) tuple gives the JAX package's schedule,
fingerprint for fingerprint.

The fleet soak's load (fleet/cli.py) is a uniform closed loop: one
request shape, constant concurrency, no tenants. Real traffic is none
of those things, and the reference's 37-page benchmark report earned
its conclusions by sweeping SHAPES, not just rates. This module
generates parameterized arrival processes:

- **signature skew** — requests draw their compiled signature from a
  zipf distribution (``zipf_s`` > 0: a hot head and a long cold tail,
  the shape that stresses per-signature compile caches and rendezvous
  routing; 0 == uniform);
- **burst modulation** — an MMPP-style two-state (ON/OFF) modulated
  Poisson process: exponential dwell times per state, the ON state
  multiplying the base rate ``burst_factor``x. Inter-arrival CV > 1 —
  burstier than Poisson, the queueing regime where p99s live;
- **diurnal modulation** — a sinusoidal rate envelope (amplitude,
  period) over the burst process — the day/night cycle compressed to
  a test-sized period;
- **tenant mixes** — arrivals carry a tenant drawn from a weighted
  mix with per-tenant priority tiers (fleet targets turn these into
  ``TenantPolicy`` quotas);
- **inverse heavy tails** — a fraction of arrivals are inverse
  optimization requests whose iteration budgets draw from a Pareto
  tail (capped): the multi-second stragglers that prove the dedicated
  inverse lane and shedding actually isolate batch work.

Everything is driven by ONE ``random.Random(seed)`` consumed in a
fixed order, so a (profile, rate, duration, seed) tuple names a
workload exactly: same inputs, bit-identical ``Schedule`` (the
determinism contract ``tests/test_torch_load.py`` pins, and what makes a
committed gate baseline meaningful).

Arrival times come from thinning: candidate gaps are drawn at the
process's peak rate and accepted with probability ``rate(t)/peak`` —
the textbook non-homogeneous Poisson construction, exact for any
bounded rate envelope.
"""

from __future__ import annotations

import bisect
import dataclasses
import math
import random
from typing import Optional, Tuple

from heat2d_tpu_torch.load.schedule import Arrival, Schedule


def zipf_weights(n: int, s: float) -> list:
    """Normalized zipf weights over ranks 1..n: w_i ∝ (i+1)^-s.
    ``s=0`` degenerates to uniform."""
    if n < 1:
        raise ValueError(f"need n >= 1 signatures, got {n}")
    raw = [(i + 1) ** -s for i in range(n)]
    total = sum(raw)
    return [w / total for w in raw]


@dataclasses.dataclass(frozen=True)
class MixProfile:
    """One named workload shape. All knobs compose: a profile may be
    simultaneously zipf-skewed, bursty, diurnal, multi-tenant, and
    inverse-heavy (the ``production`` profile is)."""

    name: str
    #: distinct solve signatures (signature i solves ``steps + i``
    #: steps — distinct compiled programs, same grid)
    signatures: int = 4
    zipf_s: float = 0.0
    nx: int = 16
    ny: int = 16
    steps: int = 4
    method: str = "jnp"
    #: MMPP burst: ON-state rate multiplier (1.0 == modulation off)
    #: and mean exponential dwell per state
    burst_factor: float = 1.0
    burst_on_s: float = 2.0
    burst_off_s: float = 6.0
    #: diurnal sinusoid: rate *= 1 + amplitude * sin(2πt/period)
    diurnal_amplitude: float = 0.0
    diurnal_period_s: float = 30.0
    #: (tenant, weight, priority) rows; priority 0 == critical
    #: (fleet admission may use the reserved headroom)
    tenants: Tuple[tuple, ...] = (("default", 1.0, 0),)
    #: fraction of arrivals that are inverse optimization requests
    inverse_fraction: float = 0.0
    #: inverse iteration budget ~ min(cap, min * Pareto(alpha)):
    #: a heavy tail of long optimization loops
    inverse_iters_min: int = 8
    inverse_iters_cap: int = 64
    inverse_tail_alpha: float = 1.5

    def __post_init__(self):
        if self.signatures < 1:
            raise ValueError(
                f"signatures must be >= 1, got {self.signatures}")
        if self.burst_factor < 1.0:
            raise ValueError("burst_factor must be >= 1 (the ON state "
                             f"speeds traffic up), got {self.burst_factor}")
        if not (0.0 <= self.diurnal_amplitude < 1.0):
            raise ValueError("diurnal_amplitude must be in [0, 1), got "
                             f"{self.diurnal_amplitude}")
        if not (0.0 <= self.inverse_fraction <= 1.0):
            raise ValueError("inverse_fraction must be in [0, 1], got "
                             f"{self.inverse_fraction}")
        if not self.tenants:
            raise ValueError("a profile needs at least one tenant")

    def quotas(self, max_inflight: int) -> dict:
        """The fleet-side ``TenantPolicy`` map this mix implies:
        every named tenant gets its priority tier and a share of the
        global in-flight budget proportional to its weight (floored
        at 1)."""
        from heat2d_tpu_torch.fleet.router import TenantPolicy
        total = sum(w for _n, w, _p in self.tenants)
        return {
            name: TenantPolicy(
                max_inflight=max(1, int(round(max_inflight * w / total))),
                priority=int(prio))
            for name, w, prio in self.tenants
        }


#: the named mixes the CLI exposes (--profile); ``smoke`` is the CPU
#: gate's mix — small and fast but still skewed + bursty + two-tenant.
#: They are the JAX package's, unchanged: small grids on method "jnp",
#: which on the card is the plain loop in torch ops and launches no hand
#: kernel. Full-width card traffic is a ``MixProfile`` built by the
#: caller (``chip_smoke.py``'s load phase: 640x1024 and 4096^2 on
#: method "auto") or a replayed trace.
PROFILES = {
    "uniform": MixProfile(name="uniform"),
    "zipf": MixProfile(name="zipf", signatures=8, zipf_s=1.1),
    "bursty": MixProfile(name="bursty", burst_factor=4.0,
                         burst_on_s=1.5, burst_off_s=4.5),
    "diurnal": MixProfile(name="diurnal", diurnal_amplitude=0.8,
                          diurnal_period_s=20.0),
    "multitenant": MixProfile(
        name="multitenant", signatures=6, zipf_s=1.1,
        tenants=(("interactive", 0.7, 0), ("batch", 0.3, 1))),
    "inverse_heavy": MixProfile(
        name="inverse_heavy", signatures=4, zipf_s=0.9,
        inverse_fraction=0.2),
    "production": MixProfile(
        name="production", signatures=8, zipf_s=1.1,
        burst_factor=3.0, burst_on_s=2.0, burst_off_s=6.0,
        diurnal_amplitude=0.5, diurnal_period_s=30.0,
        tenants=(("interactive", 0.6, 0), ("batch", 0.3, 1),
                 ("analytics", 0.1, 2)),
        inverse_fraction=0.05),
    "smoke": MixProfile(
        name="smoke", signatures=2, zipf_s=1.0, nx=12, ny=12, steps=3,
        burst_factor=2.0, burst_on_s=1.0, burst_off_s=2.0,
        tenants=(("interactive", 0.8, 0), ("batch", 0.2, 1))),
}


def _burst_toggles(rng: random.Random, profile: MixProfile,
                   duration: float) -> list:
    """ON/OFF state toggle times over [0, duration]: exponential
    dwells, starting OFF. Returns the sorted toggle instants (state
    at t = ON iff an odd number of toggles precede t)."""
    toggles, t = [], 0.0
    on = False
    while t < duration:
        mean = profile.burst_on_s if on else profile.burst_off_s
        t += rng.expovariate(1.0 / mean)
        toggles.append(t)
        on = not on
    return toggles


def _rate_factor(t: float, profile: MixProfile, toggles: list) -> float:
    """Instantaneous rate multiplier at ``t``: burst state x diurnal
    envelope (both 1.0 when the profile turns them off)."""
    f = 1.0
    if profile.burst_factor > 1.0:
        if bisect.bisect_right(toggles, t) % 2 == 1:    # ON state
            f *= profile.burst_factor
    if profile.diurnal_amplitude > 0.0:
        f *= 1.0 + profile.diurnal_amplitude * math.sin(
            2.0 * math.pi * t / profile.diurnal_period_s)
    return f


def _solve_spec(profile: MixProfile, sig_index: int,
                rng: random.Random) -> dict:
    """One solve spec on signature ``sig_index``: the signature fields
    are deterministic (grid, steps+i, method); the diffusivities vary
    per arrival (they are traced operands, not compile keys — varying
    them defeats result caches the way production payloads do) inside
    the explicit-stability box."""
    return {
        "nx": profile.nx, "ny": profile.ny,
        "steps": profile.steps + sig_index,
        "cx": round(0.05 + 0.15 * rng.random(), 6),
        "cy": round(0.05 + 0.15 * rng.random(), 6),
        "method": profile.method,
    }


def _inverse_spec(profile: MixProfile, rng: random.Random) -> dict:
    """One inverse spec with a Pareto-tailed iteration budget and a
    seeded sparse observation set (every 3rd cell of a seeded smooth
    field — identifiable, cheap, deterministic)."""
    iters = min(profile.inverse_iters_cap,
                int(profile.inverse_iters_min
                    * rng.paretovariate(profile.inverse_tail_alpha)))
    nx, ny = profile.nx, profile.ny
    idx, vals = [], []
    a = rng.uniform(0.5, 2.0)
    b = rng.uniform(0.5, 2.0)
    for i in range(1, nx - 1):
        for j in range(1, ny - 1):
            if (i * ny + j) % 3 == 0:
                idx.append(i * ny + j)
                vals.append(round(
                    a * math.sin(math.pi * i / nx)
                    * math.sin(math.pi * b * j / ny), 6))
    return {
        "nx": nx, "ny": ny, "steps": profile.steps,
        "obs_indices": idx, "obs_values": vals,
        "iterations": max(profile.inverse_iters_min, iters),
        "lr": 0.05,
    }


def synthesize(profile: MixProfile, rate: float, duration: float,
               seed: int = 0,
               max_arrivals: Optional[int] = None) -> Schedule:
    """Generate the (profile, rate, duration, seed) workload.

    ``rate`` is the BASE Poisson rate (req/s) before burst/diurnal
    modulation — the schedule's realized ``offered_rps()`` is the
    measured truth a surface row records. ``max_arrivals`` bounds
    runaway high-rate sweeps."""
    if rate <= 0:
        raise ValueError(f"rate must be > 0, got {rate}")
    if duration <= 0:
        raise ValueError(f"duration must be > 0, got {duration}")
    rng = random.Random(seed)
    toggles = (_burst_toggles(rng, profile, duration)
               if profile.burst_factor > 1.0 else [])
    peak = (rate * profile.burst_factor
            * (1.0 + profile.diurnal_amplitude))
    sig_weights = zipf_weights(profile.signatures, profile.zipf_s)
    sig_pop = list(range(profile.signatures))
    tenant_pop = [name for name, _w, _p in profile.tenants]
    tenant_weights = [w for _n, w, _p in profile.tenants]

    arrivals = []
    t = 0.0
    while True:
        t += rng.expovariate(peak)
        if t >= duration:
            break
        # thinning: accept with prob rate(t)/peak
        if rng.random() * peak > rate * _rate_factor(t, profile,
                                                     toggles):
            continue
        tenant = rng.choices(tenant_pop, weights=tenant_weights)[0]
        if rng.random() < profile.inverse_fraction:
            arrivals.append(Arrival(
                t=t, kind="inverse",
                spec=_inverse_spec(profile, rng), tenant=tenant))
        else:
            sig = rng.choices(sig_pop, weights=sig_weights)[0]
            arrivals.append(Arrival(
                t=t, kind="solve",
                spec=_solve_spec(profile, sig, rng), tenant=tenant))
        if max_arrivals is not None and len(arrivals) >= max_arrivals:
            break
    return Schedule(arrivals, meta={
        "source": "synth", "profile": profile.name,
        "rate": float(rate), "duration_s": float(duration),
        "seed": int(seed)})
