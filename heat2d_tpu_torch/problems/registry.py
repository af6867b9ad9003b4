"""Problem registry: each family's spec bound to its plain updates. The
port of ``heat2d_tpu/problems/registry.py``.

    fam = get_family("advdiff")
    fam.step(u, cx, cy)               # the plain step
    fam.step(u, *scalars)             # the same, constants as operands
    fam.scalars(cxs, cys)             # the (B,) scalar operands, S of them

``register()`` adds or replaces a family; the capability gates read the
spec it carries.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

from heat2d_tpu_torch.ops import analytic
from heat2d_tpu_torch.problems import kernels as _k
from heat2d_tpu_torch.problems.base import FAMILY_SPECS, FamilySpec


@dataclasses.dataclass(frozen=True)
class Family:
    """One registered family: the declared spec and its updates.

    - ``step(u, cx, cy, *constants)``: the plain step (serial mode, the
      jnp route); with all ``spec.n_scalars`` operands it is the update
      the batched kernels compute;
    - ``scalars(cxs, cys)``: the request's two knobs as those operands;
    - ``np_step(u, cx, cy)``: the numpy float64 oracle;
    - ``mode_factor(nx, ny, cx, cy)``: the analytic per-step amplification
      of the lowest sine mode, where the family has one.
    """

    spec: FamilySpec
    step: Callable
    scalars: Callable
    np_step: Callable
    mode_factor: Optional[Callable] = None

    @property
    def name(self) -> str:
        return self.spec.name


_FAMILIES: Dict[str, Family] = {}


def register(family: Family) -> Family:
    """Add (or replace) a family."""
    _FAMILIES[family.name] = family
    return family


def get_family(problem: str) -> Family:
    try:
        return _FAMILIES[problem]
    except KeyError:
        raise ValueError(
            f"unknown problem {problem!r}; registered families: "
            f"{tuple(_FAMILIES)}") from None


def family_names():
    return tuple(_FAMILIES)


register(Family(
    spec=FAMILY_SPECS["heat5"],
    step=_k.heat5_step,
    scalars=_k.heat5_scalars,
    np_step=_k.heat5_np_step,
    mode_factor=analytic.explicit_mode_factor,
))

register(Family(
    spec=FAMILY_SPECS["varcoef"],
    step=_k.varcoef_step,
    scalars=_k.varcoef_scalars,
    np_step=_k.varcoef_np_step,
))

register(Family(
    spec=FAMILY_SPECS["heat9"],
    step=_k.heat9_step,
    scalars=_k.heat9_scalars,
    np_step=_k.heat9_np_step,
    mode_factor=_k.heat9_mode_factor,
))

register(Family(
    spec=FAMILY_SPECS["advdiff"],
    step=_k.advdiff_step,
    scalars=_k.advdiff_scalars,
    np_step=_k.advdiff_np_step,
))

register(Family(
    spec=FAMILY_SPECS["reactdiff"],
    step=_k.reactdiff_step,
    scalars=_k.reactdiff_scalars,
    np_step=_k.reactdiff_np_step,
))
