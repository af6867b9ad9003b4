"""Static analysis and correctness tooling of the port (the counterpart of
``heat2d_tpu/analysis``):

- ``analysis.lint``: the AST linter of the port's conventions (rules
  R001-R006), gated by ``heat2d-tpu-torch-lint`` (``analysis/cli.py``)
  at zero findings not in ``analysis/baseline.json``;
- ``analysis.locks``: audited drop-in locks, lock-order inversion
  (deadlock cycle) detection and ``@guarded_by`` guarded-state checks,
  opt in with ``HEAT2D_LOCK_AUDIT=1``, plain ``threading`` objects when
  off;
- ``analysis.recompile``: the kernel-build sentinel (``nvcc`` builds and
  library loads, the serve engine's O(log max_batch) capacity ladder);
- ``analysis.launch_pin``: the "free when off" pins (route, residual
  reads, bits and launches, armed against disarmed);
- ``analysis.implicit_gate``: the implicit routes' acceptance gate.

The JAX package's jaxpr verifier (``ir``, ``footprint``, ``dtype_flow``)
has no counterpart yet (ROADMAP.md, A5.3b).
"""

from heat2d_tpu_torch.analysis.locks import (AuditedCondition, AuditedLock,
                                             AuditedRLock, guarded_by)

__all__ = ["AuditedCondition", "AuditedLock", "AuditedRLock",
           "guarded_by"]
