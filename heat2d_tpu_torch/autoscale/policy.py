"""Autoscaler guardrails — the knobs between advice and action (the
port of ``heat2d_tpu/autoscale/policy.py``).

A raw ``capacity.advise`` row is a point-in-time estimate from a noisy
rate window; executing it verbatim would thrash the pool (spawn a
worker, retire it two ticks later, spawn again). The policy encodes
the standard stabilizers, all deliberately asymmetric in the
scale-down direction — adding capacity late costs latency, removing
it early costs correctness-adjacent churn (drains, migrations):

- hard bounds (``min_workers``/``max_workers`` — the static baseline
  the chip-hours ledger is judged against is ``max_workers``);
- per-direction cooldowns (a fresh scale-up must be allowed to absorb
  the load before the next resize is even considered);
- a consecutive-tick HOLD before any scale-down (``down_hold_ticks``:
  one quiet window is noise, N in a row is a trough);
- step limits per action (``max_step_up``/``max_step_down``).
"""

from __future__ import annotations

import dataclasses

from heat2d_tpu_torch.mesh.health import PAROLE_PASSES


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """Guardrails for one ``Actuator`` (module docstring)."""

    #: pool bounds; ``max_workers`` doubles as the static-provisioning
    #: baseline in the chip-seconds ledger
    min_workers: int = 1
    max_workers: int = 4
    #: seconds (actuator clock) between scale-ups / between scale-downs
    up_cooldown_s: float = 1.0
    down_cooldown_s: float = 3.0
    #: consecutive below-target observations before a scale-down is
    #: admitted (hysteresis — one quiet window is noise)
    down_hold_ticks: int = 3
    #: workers added / retired per action
    max_step_up: int = 2
    max_step_down: int = 1
    #: drain deadline for a retiring worker (then kill + replay)
    drain_timeout_s: float = 30.0
    #: consecutive verified probe passes a parole hearing requires
    parole_passes: int = PAROLE_PASSES

    def __post_init__(self):
        if self.min_workers < 1:
            raise ValueError(
                f"min_workers must be >= 1, got {self.min_workers}")
        if self.max_workers < self.min_workers:
            raise ValueError(
                f"max_workers ({self.max_workers}) must be >= "
                f"min_workers ({self.min_workers})")
        if self.down_hold_ticks < 1:
            raise ValueError(
                f"down_hold_ticks must be >= 1, got "
                f"{self.down_hold_ticks}")
        if self.max_step_up < 1 or self.max_step_down < 1:
            raise ValueError("step limits must be >= 1")
        if self.up_cooldown_s < 0 or self.down_cooldown_s < 0:
            raise ValueError("cooldowns must be >= 0")
        if self.drain_timeout_s <= 0:
            raise ValueError(
                f"drain_timeout_s must be > 0, got "
                f"{self.drain_timeout_s}")
        if self.parole_passes < 1:
            raise ValueError(
                f"parole_passes must be >= 1, got {self.parole_passes}")
