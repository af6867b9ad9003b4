"""Explicit-scheme stability: the cx + cy <= 1/2 box, the families'
bounds, and the box the inverse solves project their diffusivity
iterates into.

The port's copy of the checks of ``heat2d_tpu/ops/stability.py``, with
the same limits and error text. The implicit methods (adi, mg) are
unconditionally stable and never call them (``is_implicit``).
"""

from __future__ import annotations

import torch

from heat2d_tpu_torch.config import ConfigError
from heat2d_tpu_torch.vocab import (ADVECTION_VELOCITY, IMPLICIT_METHODS,
                                    REACTION_RATE)

#: The dimensionless coefficient-sum bound: cx + cy <= 1/2.
EXPLICIT_COEFF_LIMIT = 0.5

#: heat9's box: the 4th-order operator's worst von Neumann mode has the
#: eigenvalue 16/3 per axis, so cx + cy <= 3/8.
HEAT9_COEFF_LIMIT = 0.375

#: The box of a projected isotropic diffusivity iterate (kx = ky = kappa,
#: ``diff/inverse.py``): 2 kappa <= 1/2 with margin below the exact 0.25,
#: and a floor that keeps the field physical and the solve sensitive to
#: it.
KAPPA_MIN, KAPPA_MAX = 1e-4, 0.24


def stability_limit(dx: float = 1.0, dy: float = 1.0) -> float:
    """The largest stable ``alpha * dt`` for the explicit scheme on
    spacings (dx, dy): 1/4 at unit spacing."""
    if dx <= 0 or dy <= 0:
        raise ConfigError(f"grid spacings must be > 0, got dx={dx} "
                          f"dy={dy}")
    return 0.5 / (dx ** -2 + dy ** -2)


def is_implicit(method: str) -> bool:
    """True for the unconditionally stable methods, which skip
    ``check_explicit_stability`` by design."""
    return method in IMPLICIT_METHODS


def check_explicit_stability(cx: float, cy: float,
                             where: str = "explicit step") -> None:
    """Raise a ``ConfigError`` naming the limit when (cx, cy) lie outside
    the stability box."""
    if cx < 0 or cy < 0:
        raise ConfigError(
            f"{where}: diffusivity coefficients must be >= 0, got "
            f"cx={cx} cy={cy}")
    if cx + cy > EXPLICIT_COEFF_LIMIT:
        raise ConfigError(
            f"{where}: cx + cy = {cx + cy:g} exceeds the explicit "
            f"stability limit cx + cy <= {EXPLICIT_COEFF_LIMIT} "
            f"(alpha*dt <= {stability_limit():g} at unit spacing - "
            f"ops/stability.py). Use an implicit method "
            f"(--method adi or mg), which is unconditionally stable, "
            f"or reduce the time step")


def check_heat9_stability(cx: float, cy: float,
                          where: str = "heat9 step") -> None:
    """heat9's guard: the 5-point contract with the tighter box
    ``cx + cy <= 3/8``."""
    if cx < 0 or cy < 0:
        raise ConfigError(
            f"{where}: diffusivity coefficients must be >= 0, got "
            f"cx={cx} cy={cy}")
    if cx + cy > HEAT9_COEFF_LIMIT:
        raise ConfigError(
            f"{where}: cx + cy = {cx + cy:g} exceeds the heat9 "
            f"(4th-order 9-point) stability limit cx + cy <= "
            f"{HEAT9_COEFF_LIMIT} (worst-mode eigenvalue 16/3 per "
            f"axis - ops/stability.py); reduce the time step")


def check_advdiff_stability(cx: float, cy: float,
                            where: str = "advdiff step") -> None:
    """advdiff's guard: the diffusion box and the central-advection
    bounds ``vx^2 <= 2 cx`` and ``vy^2 <= 2 cy`` (the family velocities
    are ``vocab.ADVECTION_VELOCITY``)."""
    check_explicit_stability(cx, cy, where=where)
    vx, vy = ADVECTION_VELOCITY
    for axis, v, c in (("x", vx, cx), ("y", vy, cy)):
        if v * v > 2.0 * c:
            raise ConfigError(
                f"{where}: advection CFL (cell-Reynolds) bound "
                f"v{axis}^2 <= 2*c{axis} violated: {v:g}^2 = "
                f"{v * v:g} > {2.0 * c:g} (family velocity "
                f"v{axis} = {v:g}, vocab.ADVECTION_VELOCITY - "
                f"ops/stability.py); increase c{axis} or use a "
                f"diffusivity of at least {v * v / 2.0:g}")


def check_reactdiff_stability(cx: float, cy: float,
                              where: str = "reactdiff step") -> None:
    """reactdiff's guard: the diffusion box and the reaction-rate bound
    ``r <= 1/2`` for the source ``r u / (1 + u)`` (r is
    ``vocab.REACTION_RATE``)."""
    check_explicit_stability(cx, cy, where=where)
    r = REACTION_RATE
    if r > 0.5:
        raise ConfigError(
            f"{where}: explicit reaction-rate bound r <= 1/2 "
            f"violated: r = {r:g} (vocab.REACTION_RATE - "
            f"ops/stability.py); reduce the reaction time step")


#: problem -> its explicit guard (varcoef's fields are bounded by
#: (cx, cy) pointwise, so the 5-point box governs it).
_PROBLEM_CHECKS = {
    "heat5": check_explicit_stability,
    "varcoef": check_explicit_stability,
    "heat9": check_heat9_stability,
    "advdiff": check_advdiff_stability,
    "reactdiff": check_reactdiff_stability,
}


def check_problem_stability(problem: str, cx: float, cy: float,
                            where: str = "explicit step") -> None:
    """Each family's explicit bound, named in its error."""
    try:
        check = _PROBLEM_CHECKS[problem]
    except KeyError:
        raise ConfigError(
            f"no stability bound registered for problem "
            f"{problem!r} (known: {tuple(_PROBLEM_CHECKS)})") from None
    check(cx, cy, where=where)


def project_stable(kappa):
    """Clamp an isotropic per-cell diffusivity field into
    [KAPPA_MIN, KAPPA_MAX]: the inverse driver's projection of each
    iterate."""
    return torch.clamp(kappa, KAPPA_MIN, KAPPA_MAX)
