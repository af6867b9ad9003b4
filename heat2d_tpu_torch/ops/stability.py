"""Explicit-scheme stability: the cx + cy <= 1/2 box.

The port's copy of ``check_explicit_stability`` from
``heat2d_tpu/ops/stability.py``, with the same limit and error text.
"""

from __future__ import annotations

from heat2d_tpu_torch.config import ConfigError

#: The dimensionless coefficient-sum bound: cx + cy <= 1/2.
EXPLICIT_COEFF_LIMIT = 0.5


def stability_limit(dx: float = 1.0, dy: float = 1.0) -> float:
    """The largest stable ``alpha * dt`` for the explicit scheme on
    spacings (dx, dy): 1/4 at unit spacing."""
    if dx <= 0 or dy <= 0:
        raise ConfigError(f"grid spacings must be > 0, got dx={dx} "
                          f"dy={dy}")
    return 0.5 / (dx ** -2 + dy ** -2)


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
