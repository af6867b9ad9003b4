"""Elastic capacity: the port of ``heat2d_tpu/autoscale/``, the
actuation layer that EXECUTES the control plane's advice.

The control plane (``heat2d_tpu_torch/control/``) advises capacity
(``load/capacity.advise`` sizing rows, discounted by mesh quarantine);
this package acts on it:

- ``policy.AutoscalePolicy``: the guardrails (min/max workers,
  per-direction cooldowns, the scale-down hold, step limits, drain
  timeout, parole passes).
- ``actuator.Actuator``: turns one sizing row per control tick into at
  most a handful of concrete actions: ``FleetServer.add_worker``
  (warm-gated scale-up: a new worker is unroutable until its hot
  signatures have run), ``FleetServer.retire_worker`` (fence-then-drain
  scale-down), ``HealthMonitor.parole`` (verified re-admission of
  quarantined slots), ``MeshEnsembleEngine.resize`` (voluntary mesh
  resize). It also keeps the chip-seconds ledger the "cheaper than
  static provisioning" verdict is computed from.
- ``migrate``: live migration of long-running inverse jobs off a
  retiring worker: pause at an iteration boundary, checkpoint the Adam
  state (``diff.inverse.AdamState``), serialize it wire-style (base64
  numpy, the ``fleet/wire`` idiom), resume on a survivor, bitwise equal
  to an unmigrated run on the same device.

The elastic soak (``heat2d-tpu-torch-fleet --autoscale``) drives the
whole loop under the compressed diurnal profile from ``load/synth.py``.
"""

from heat2d_tpu_torch.autoscale.actuator import Actuator  # noqa: F401
from heat2d_tpu_torch.autoscale.policy import AutoscalePolicy  # noqa: F401
