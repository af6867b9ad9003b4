"""Problem-family contract: what each family declares about itself. The
port's copy of ``heat2d_tpu/problems/base.py``.

A problem family is one spatial operator. ``FamilySpec`` is pure data;
config validation and serving admission read it alone, and never touch
a kernel (those are bound in ``problems/registry.py``). Capability gating
follows from the declared properties:

- ``time_methods``: the time discretizations the kernels serve for the
  operator. The implicit routes (ADI's constant-coefficient tridiagonal
  solves, MG's 5-point smoother) are built for heat5 only; a nonlinear
  source rules them out as well.
- ``kernel_routes``: the explicit batched kernel routes with a template
  for the family (varcoef's per-cell coefficient fields have none).
- ``halo_width``: the operator's spatial radius, the depth of the held
  boundary ring, and per step the shrink of a tile's valid region.

The reason strings of ``supports_method`` are the JAX package's word for
word: they become the ``ConfigError`` and ``Rejected`` messages of both
stacks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from heat2d_tpu_torch.vocab import (DEFAULT_PROBLEM, IMPLICIT_METHODS,
                                    PROBLEMS)


@dataclasses.dataclass(frozen=True)
class FamilySpec:
    """What one problem family declares about itself."""

    name: str
    title: str
    #: spatial radius: per-step valid-region shrink, halo ring depth, and
    #: the width of the boundary ring the update holds.
    halo_width: int
    #: linear in u (the property the implicit gates derive from).
    linear: bool
    #: grid-sized device arrays per member (u + coefficient fields).
    state_arrays: int
    #: grid arrays read per plain step (u + coefficient fields).
    reads_per_step: int
    #: per-member scalar operands of the batched kernels (cx, cy, then
    #: the family constants).
    n_scalars: int
    #: time discretizations the kernels serve (subset of TIME_METHODS).
    time_methods: Tuple[str, ...]
    #: explicit batched kernel routes with a template for this family.
    kernel_routes: Tuple[str, ...]
    #: the ABFT checksum recurrence applies.
    abft: bool
    #: the adjoints cover this operator.
    adjoint: bool
    #: why the non-declared methods are missing, quoted by the gates.
    gate_reason: str
    #: (src, dst) dtype casts the JAX package's IR verifier accepts in
    #: this family's programs; kept so the two specs compare field by
    #: field.
    cast_allowlist: Tuple[Tuple[str, str], ...] = ()

    @property
    def min_grid(self) -> int:
        """Smallest nx/ny with at least one interior cell: the held
        boundary ring is ``halo_width`` deep on each side."""
        return 2 * self.halo_width + 1

    def supports_method(self, method: str) -> Tuple[bool, Optional[str]]:
        """(ok, reason) for a solve ``method`` against the declared
        capabilities: 'explicit' and the implicit methods check
        ``time_methods``, 'auto' and the explicit routes check
        ``kernel_routes``. The reason names the combination."""
        if method == "explicit":
            if "explicit" in self.time_methods:
                return True, None
            return False, (
                f"problem {self.name!r} does not support explicit "
                f"time stepping (supported time methods: "
                f"{self.time_methods})")
        if method in IMPLICIT_METHODS:
            if method in self.time_methods:
                return True, None
            return False, (
                f"problem {self.name!r} does not support method "
                f"{method!r}: {self.gate_reason} (supported time "
                f"methods: {self.time_methods})")
        if method == "auto" or method in self.kernel_routes:
            return True, None
        return False, (
            f"problem {self.name!r} has no {method!r} kernel template "
            f"(available routes: {self.kernel_routes}); use one of "
            f"those or 'auto'")


_IMPLICIT_5PT = ("the batched tridiagonal (ADI) and multigrid kernels "
                 "are built for the constant-coefficient 5-point "
                 "operator")

#: Every family's spec, keyed by name (the order of vocab.PROBLEMS).
FAMILY_SPECS = {
    "heat5": FamilySpec(
        name="heat5",
        title="5-point constant-coefficient heat (the reference)",
        halo_width=1, linear=True, state_arrays=1, reads_per_step=1,
        n_scalars=2,
        time_methods=("explicit",) + IMPLICIT_METHODS,
        kernel_routes=("jnp", "pallas", "band"),
        abft=True, adjoint=True,
        gate_reason="(fully supported)"),
    "varcoef": FamilySpec(
        name="varcoef",
        title="variable-coefficient (heterogeneous-material) diffusion",
        halo_width=1, linear=True, state_arrays=3, reads_per_step=3,
        n_scalars=2,
        time_methods=("explicit",),
        kernel_routes=("jnp",),
        abft=False, adjoint=True,
        gate_reason=_IMPLICIT_5PT,
        cast_allowlist=(("float64", "float32"),)),
    "heat9": FamilySpec(
        name="heat9",
        title="4th-order 9-point (wide-stencil) heat",
        halo_width=2, linear=True, state_arrays=1, reads_per_step=1,
        n_scalars=2,
        time_methods=("explicit",),
        kernel_routes=("jnp", "pallas", "band"),
        abft=False, adjoint=False,
        gate_reason=_IMPLICIT_5PT + " (the 4th-order operator is "
                    "pentadiagonal per axis)"),
    "advdiff": FamilySpec(
        name="advdiff",
        title="advection-diffusion (central advection)",
        halo_width=1, linear=True, state_arrays=1, reads_per_step=1,
        n_scalars=4,
        time_methods=("explicit",),
        kernel_routes=("jnp", "pallas", "band"),
        abft=False, adjoint=False,
        gate_reason=_IMPLICIT_5PT + " (no advection terms in the "
                    "tridiagonal systems)"),
    "reactdiff": FamilySpec(
        name="reactdiff",
        title="reaction-diffusion (saturating nonlinear source)",
        halo_width=1, linear=False, state_arrays=1, reads_per_step=1,
        n_scalars=3,
        time_methods=("explicit",),
        kernel_routes=("jnp", "pallas", "band"),
        abft=False, adjoint=False,
        gate_reason="the nonlinear source term rules out the "
                    "Crank-Nicolson linear solves (and the ABFT "
                    "checksum recurrence); nonlinear families get "
                    "explicit stepping + probe/quarantine only"),
}

if tuple(FAMILY_SPECS) != PROBLEMS:
    raise ImportError("FAMILY_SPECS and vocab.PROBLEMS drifted")


def spec_for(problem: str) -> FamilySpec:
    """The declared spec, or a ValueError naming the vocabulary."""
    try:
        return FAMILY_SPECS[problem]
    except KeyError:
        raise ValueError(
            f"unknown problem {problem!r}; registered families: "
            f"{PROBLEMS}") from None


def supports_method(problem: str, method: str):
    """(ok, reason): ``spec_for(problem).supports_method(method)``."""
    return spec_for(problem).supports_method(method)


def state_arrays(problem: str = DEFAULT_PROBLEM) -> int:
    """Grid-sized device arrays per member."""
    return spec_for(problem).state_arrays


def capability_matrix() -> dict:
    """problem -> {time_methods, kernel_routes, abft, adjoint, linear,
    halo_width}."""
    return {
        name: {
            "time_methods": spec.time_methods,
            "kernel_routes": spec.kernel_routes,
            "abft": spec.abft,
            "adjoint": spec.adjoint,
            "linear": spec.linear,
            "halo_width": spec.halo_width,
        }
        for name, spec in FAMILY_SPECS.items()
    }
