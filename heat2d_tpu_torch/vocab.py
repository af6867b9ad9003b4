"""The vocabularies the port's config validation needs.

A copy of the atoms of ``heat2d_tpu/vocab.py`` (``TIME_METHODS``,
``EXPLICIT_ROUTES``, ``SERVE_METHODS``, ``PROBLEMS``, ``DEFAULT_PROBLEM``):
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

#: Problem families (the spatial-operator axis); "heat5" is the
#: reference's 5-point operator.
PROBLEMS = ("heat5", "varcoef", "heat9", "advdiff", "reactdiff")

#: The default family, the reference problem.
DEFAULT_PROBLEM = "heat5"
