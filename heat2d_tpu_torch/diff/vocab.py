"""The diff package's vocabulary, one definition each (the port's copy of
``heat2d_tpu/diff/vocab.py``; ``tests/test_torch_diff.py`` holds the two
equal)."""

from heat2d_tpu_torch import vocab as _vocab

#: Coefficient forms of the differentiable solve: scalar (cx, cy), or
#: per-cell (kx, ky) fields.
COEFFS = ("const", "var")

#: Reverse-mode storage: every K-th state with recompute, or every state.
ADJOINTS = ("checkpoint", "full")

#: Primal routes ("adi" is the implicit Crank-Nicolson step: other math,
#: whose pullback runs through the tridiagonal solves' own backward),
#: derived from the port's method vocabulary by exclusion.
METHODS = _vocab.DIFF_METHODS

#: Inverse-problem recovery targets.
TARGETS = ("init", "diffusivity")
