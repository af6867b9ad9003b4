"""Fleet control plane: the port of ``heat2d_tpu/control/``. It closes
the loop from live telemetry back into tuning, shedding and capacity
decisions, on a pool of workers that serve from the card.

- ``plane.ControlPlane``: the tick loop. Sustained SLO burn
  (``obs/slo.BurnWindow``) -> pre-emptive shed / retune / capacity
  advice, escalating before the ``DegradedMode`` breaker trips.
- ``retuner.Retuner``: re-measure hot signatures off-peak and stage
  candidate ``TuningDB`` s (``validated=False``, next epoch), on the
  simulated backend or, with ``backend=None``, on the card.
- ``rollout.Rollout``: canary one worker, assert bitwise parity, observe
  SLO burn and relative latency, promote worker by worker or auto-revert
  with a bitwise post-revert proof; kill-storm-safe by construction
  (one-generation env overlays).
"""

from heat2d_tpu_torch.control.plane import ControlPlane
from heat2d_tpu_torch.control.retuner import Retuner, problem_from_signature
from heat2d_tpu_torch.control.rollout import Rollout, RolloutConfig

__all__ = ["ControlPlane", "Retuner", "Rollout", "RolloutConfig",
           "problem_from_signature"]
