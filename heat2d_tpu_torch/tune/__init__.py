"""The tuning subsystem of the port (the JAX package's ``heat2d_tpu/tune``):
a search of the kernels' knobs on the card, kept in a per-device tuning
db that the planners, the engines and the mesh scheduler consult.

- ``space``: the candidates of a (shape, dtype) problem over the card's
  routes (H4's chunk depth K; H2's sweep depth T and tile height; H14's
  overlap depth), pruned by the port's own planners;
- ``measure``: the two-point marginal step-time protocol (which
  ``bench_torch.py`` and ``chip_smoke.py``'s headline also time with),
  one search point on the card with its failure classified, and a
  deterministic simulated backend for the CPU;
- ``db``: the persistent JSON db (the JAX package's document format),
  keyed by device kind, problem key and code-version salt, with atomic
  writes and a three-tier lookup;
- ``runtime``: the opt-in consults (``HEAT2D_TUNE_DB``), each answer
  re-validated against the live planners; with no db every consult
  returns None and nothing changes;
- ``cli``: ``heat2d-tpu-torch-tune``.
"""

from heat2d_tpu_torch.tune.db import TunedConfig, TuningDB, current_salt
from heat2d_tpu_torch.tune.runtime import (active_db, applied_configs,
                                           set_tuning_db)
from heat2d_tpu_torch.tune.space import Candidate, Problem, candidate_space

__all__ = [
    "Candidate", "Problem", "TunedConfig", "TuningDB", "active_db",
    "applied_configs", "candidate_space", "current_salt",
    "set_tuning_db",
]
