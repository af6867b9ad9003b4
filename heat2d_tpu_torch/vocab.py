"""The vocabularies the port's config validation needs.

A copy of the atoms of ``heat2d_tpu/vocab.py`` (``TIME_METHODS``,
``EXPLICIT_ROUTES``, ``SERVE_METHODS``, ``DIFF_METHODS``, ``PROBLEMS``,
``DEFAULT_PROBLEM`` and the family constants ``ADVECTION_VELOCITY``, ``REACTION_RATE``):
the port imports nothing of the JAX package, and
``tests/test_torch_config.py`` holds the two copies equal.
"""

from __future__ import annotations

#: Unconditionally stable time-stepping routes (they skip the explicit
#: stability box).
IMPLICIT_METHODS = ("adi", "mg")

#: Time-stepping schemes; "explicit" is the reference's forward Euler.
TIME_METHODS = ("explicit",) + IMPLICIT_METHODS

#: Explicit-scheme kernel routes of the batched ensemble runners:
#: the batched golden step, the resident kernel, the tile sweeps.
EXPLICIT_ROUTES = ("jnp", "pallas", "band")

#: Everything a serve request's ``method`` may name: 'auto' resolves per
#: shape, the explicit routes are kernel choices, the implicit methods
#: are different math.
SERVE_METHODS = ("auto",) + EXPLICIT_ROUTES + IMPLICIT_METHODS

#: Routes the differentiable solves cover (``diff/adjoint.py``), derived by
#: exclusion from the serve vocabulary: the resident kernel has no pullback
#: and mg's V-cycle recursion is not differentiated.
_NON_DIFFERENTIABLE = ("pallas", "mg")
DIFF_METHODS = tuple(m for m in SERVE_METHODS
                     if m not in _NON_DIFFERENTIABLE)

#: Problem families (the spatial-operator axis); "heat5" is the
#: reference's 5-point operator.
PROBLEMS = ("heat5", "varcoef", "heat9", "advdiff", "reactdiff")

#: The default family, the reference problem.
DEFAULT_PROBLEM = "heat5"

#: advdiff's dimensionless advection velocities (v * dt / dx): fixed
#: family constants (a request's two knobs stay (cx, cy)), inside the
#: advection bounds of ``ops.stability.check_advdiff_stability`` at the
#: default diffusivities.
ADVECTION_VELOCITY = (0.1, 0.1)

#: reactdiff's dimensionless reaction rate (r * dt) for the saturating
#: source ``r * u / (1 + u)``, inside the explicit reaction-rate bound of
#: ``ops.stability.check_reactdiff_stability``.
REACTION_RATE = 0.25
