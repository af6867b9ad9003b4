"""Configuration surface of the port: the same ``HeatConfig`` as the JAX
package (``heat2d_tpu/config.py``), field for field.

One config dict builds both stacks (``HeatConfig.from_dict`` on either
side of ``to_dict``), and an invalid config raises ``ConfigError`` in
both. ``pallas`` keeps its name as the mode of the kernel route, so run
records of the two stacks compare field by field; here it runs the
hand-written CUDA kernels of ``ops/cuda_stencil.py``.

Validation follows the JAX package's checks: for a family other than
heat5, its capability matrix, minimum grid and stability bound
(``problems/base.py``, ``ops/stability.py``); for heat5, the explicit
stability box, or for the implicit methods the single-device modes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from heat2d_tpu_torch import vocab as _vocab


class ConfigError(ValueError):
    """Invalid solver configuration (the framework's MPI_Abort analogue)."""


#: Execution modes, the JAX package's names:
#:   serial  - plain PyTorch golden model on one device
#:   pallas  - the hand-written kernel route on one device
#:   dist1d  - row strips over a (numworkers, 1) mesh (mpi_heat2Dn.c)
#:   dist2d  - 2D blocks over a (gridx, gridy) mesh (grad1612_mpi_heat.c)
#:   hybrid  - dist2d's mesh with a hand kernel per shard
#:             (grad1612_hybrid_heat.c)
MODES = ("serial", "pallas", "dist1d", "dist2d", "hybrid")

#: The distributed modes: a mesh of shards (``parallel/``).
SHARDED_MODES = ("dist1d", "dist2d", "hybrid")

#: Halo-exchange routes of the distributed modes.
HALO_ROUTES = ("collective", "fused")

TIME_METHODS = _vocab.TIME_METHODS
PROBLEMS = _vocab.PROBLEMS


@dataclasses.dataclass(frozen=True)
class HeatConfig:
    # -- shared knobs (grad1612_mpi_heat.c:5-21) ----------------------------
    nxprob: int = 10          # NXPROB - x dimension of problem grid
    nyprob: int = 10          # NYPROB - y dimension of problem grid
    steps: int = 100          # STEPS  - number of time steps
    cx: float = 0.1           # CX     - x diffusivity coefficient
    cy: float = 0.1           # CY     - y diffusivity coefficient
    debug: bool = False       # DEBUG  - extra messages

    # -- decomposition (grad1612_mpi_heat.c:10-12) --------------------------
    gridx: int = 1
    gridy: int = 1
    reorganisation: bool = True

    # -- convergence (grad1612_mpi_heat.c:14-16) ----------------------------
    convergence: bool = False  # CONVERGENCE - early exit on the residual
    interval: int = 20         # INTERVAL - steps between residual checks
    sensitivity: float = 0.1   # SENSITIVITY - residual threshold

    # -- execution ----------------------------------------------------------
    mode: str = "serial"
    method: str = "explicit"
    problem: str = "heat5"
    halo_depth: Optional[int] = None
    halo: str = "collective"
    # Storage is float32; "float64" evaluates each update the way the C
    # reference promotes it through its double literals.
    accum_dtype: str = "float32"   # "float32" | "float64"
    # Kernel step form of the pallas mode: False = the FMA factoring,
    # True = the literal reference expression, bitwise equal to serial.
    bitwise_parity: bool = False

    # -- baseline-mode knobs (mpi_heat2Dn.c:32-33) --------------------------
    numworkers: Optional[int] = None
    strict_baseline: bool = False

    def __post_init__(self):
        if self.mode not in MODES:
            raise ConfigError(
                f"mode must be one of {MODES}, got {self.mode!r}")
        if self.nxprob < 3 or self.nyprob < 3:
            raise ConfigError(
                f"grid must be at least 3x3 to have interior cells, got "
                f"{self.nxprob}x{self.nyprob}")
        if self.steps < 0:
            raise ConfigError(f"steps must be >= 0, got {self.steps}")
        if self.accum_dtype not in ("float32", "float64"):
            raise ConfigError(
                "accum_dtype must be float32 or float64, got "
                f"{self.accum_dtype!r}")
        if self.gridx < 1 or self.gridy < 1:
            raise ConfigError("gridx/gridy must be >= 1")
        if self.mode in ("dist2d", "hybrid"):
            if self.nxprob % self.gridx or self.nyprob % self.gridy:
                raise ConfigError(
                    f"ERROR: ({self.nxprob}/{self.gridx}) or "
                    f"({self.nyprob}/{self.gridy}) is not an integer")
        if self.mode == "dist1d":
            nw = self.numworkers or self.gridx
            if self.strict_baseline and not (3 <= nw <= 8):
                raise ConfigError(
                    "ERROR: the number of tasks must be between 4 and 9.")
        if self.convergence and self.interval < 1:
            raise ConfigError("interval must be >= 1 when convergence is on")
        if self.halo_depth is not None and self.halo_depth < 1:
            raise ConfigError("halo_depth must be >= 1 (or None for auto)")
        if self.halo not in HALO_ROUTES:
            raise ConfigError(
                f"halo must be one of {HALO_ROUTES}, got {self.halo!r}")
        if self.method not in TIME_METHODS:
            raise ConfigError(
                f"method must be one of {TIME_METHODS}, got "
                f"{self.method!r}")
        if self.problem not in PROBLEMS:
            raise ConfigError(
                f"problem must be one of {PROBLEMS}, got "
                f"{self.problem!r}")
        if self.problem != _vocab.DEFAULT_PROBLEM:
            # The families: capability matrix, grid floor and stability
            # bound (problems/base.py), as the JAX package checks them.
            from heat2d_tpu_torch.problems.base import spec_for
            spec = spec_for(self.problem)
            if self.mode != "serial":
                raise ConfigError(
                    f"problem {self.problem!r} runs mode 'serial' "
                    f"only in the solver (the pallas/distributed "
                    f"modes are built for the heat5 operator; use "
                    f"the ensemble/serve path for batched kernel "
                    f"routes) — got mode {self.mode!r}")
            ok, reason = spec.supports_method(self.method)
            if not ok:
                raise ConfigError(reason)
            if min(self.nxprob, self.nyprob) < spec.min_grid:
                raise ConfigError(
                    f"problem {self.problem!r} (halo width "
                    f"{spec.halo_width}) needs a grid of at least "
                    f"{spec.min_grid}x{spec.min_grid} for interior "
                    f"cells, got {self.nxprob}x{self.nyprob}")
            if self.method == "explicit":
                from heat2d_tpu_torch.ops.stability import (
                    check_problem_stability)
                check_problem_stability(self.problem, self.cx, self.cy,
                                        where="explicit scheme")
        elif self.method == "explicit":
            from heat2d_tpu_torch.ops.stability import (
                check_explicit_stability)
            check_explicit_stability(self.cx, self.cy,
                                     where="explicit scheme")
        elif self.mode not in ("serial", "pallas"):
            raise ConfigError(
                f"method {self.method!r} runs single-device modes "
                f"(serial/pallas) only; distributed implicit sweeps "
                f"are not built yet — got mode {self.mode!r}")

    @property
    def shape(self) -> tuple[int, int]:
        return (self.nxprob, self.nyprob)

    @property
    def xcell(self) -> int:
        """Per-shard rows in the 2D decomposition (grad1612_mpi_heat.c:47)."""
        return self.nxprob // self.gridx

    @property
    def ycell(self) -> int:
        """Per-shard cols in the 2D decomposition (grad1612_mpi_heat.c:48)."""
        return self.nyprob // self.gridy

    @property
    def n_shards(self) -> int:
        if self.mode == "dist1d":
            return self.numworkers or self.gridx
        return self.gridx * self.gridy

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "HeatConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})

    def replace(self, **kw) -> "HeatConfig":
        return dataclasses.replace(self, **kw)


#: mpi_heat2Dn.c:29-31 - 10x10 grid, 100 steps.
BASELINE_DEFAULTS = dict(nxprob=10, nyprob=10, steps=100)

#: grad1612_cuda_heat.cu:6-8 - 640x1024 grid, 10000 steps.
CUDA_DEFAULTS = dict(nxprob=640, nyprob=1024, steps=10000)
