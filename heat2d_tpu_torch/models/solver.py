"""Heat2DSolver: the port of ``heat2d_tpu/models/solver.py`` for one
device.

====================  ====================================================
mode / method         what runs
====================  ====================================================
serial, explicit      plain PyTorch golden model on the chosen device (no
                      kernel): the reference's 1-task runs; a problem
                      family other than heat5 steps with its plain update
                      (``problems.get_family(problem).step``)
pallas, explicit      the hand-written CUDA kernels,
                      ``ops.cuda_stencil.make_single_chip_runner`` (the
                      grad1612_cuda_heat.cu counterpart; heat5 only)
pallas, adi           Crank-Nicolson ADI with its tridiagonal solves
                      through H10/H11 (``ops.tridiag.batched_adi_kernel``)
serial, adi           the same ADI through the plain solve
                      (``ops.tridiag.adi_multi_step``)
mg                    Crank-Nicolson stepped by multigrid V-cycles
                      (``ops.multigrid``, plain PyTorch in both modes)
====================  ====================================================

The distributed modes raise a ``ConfigError`` that names the slice of
ROADMAP.md they wait for. The solver runs on ``cuda`` unless it is given
``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from heat2d_tpu_torch.config import ConfigError, HeatConfig
from heat2d_tpu_torch.interop import state_from_numpy
from heat2d_tpu_torch.models import engine
from heat2d_tpu_torch.ops.init import inidat
from heat2d_tpu_torch.ops.stencil import residual_sq, stencil_step
from heat2d_tpu_torch.utils.device import resolve_device
from heat2d_tpu_torch.utils.timing import _fence, timed_call

#: (what the config asks for) -> the ROADMAP.md slice that ports it.
_UNPORTED_MODES = {
    "dist1d": "slice 5 (multi-device)",
    "dist2d": "slice 5 (multi-device)",
    "hybrid": "slice 5 (multi-device)",
}


def check_ported(config: HeatConfig) -> None:
    """Raise a ``ConfigError`` for a mode this port does not run yet,
    naming the ROADMAP.md slice it waits for."""
    if config.mode in _UNPORTED_MODES:
        raise ConfigError(
            f"mode {config.mode!r} is not ported to PyTorch/CUDA yet; it "
            f"waits for {_UNPORTED_MODES[config.mode]} of ROADMAP.md "
            f"(ported: modes 'serial' and 'pallas')")


@dataclasses.dataclass
class RunResult:
    u: np.ndarray           # final grid, host-side, row-major
    steps_done: int
    elapsed: float          # seconds, reference timing protocol
    config: HeatConfig
    # Wall-clock of the untimed warmup run (the kernels' build and load
    # included); None when untimed or when the warmup was skipped.
    warmup_s: Optional[float] = None
    route: str = "serial"
    # Host reads of the residual (one per convergence check).
    residual_reads: int = 0
    device: str = "cuda"

    @property
    def mcells_per_s(self) -> float:
        """Cell updates per second, in millions."""
        if self.elapsed <= 0 or self.steps_done == 0:
            return float("nan")
        nx, ny = self.config.shape
        return nx * ny * self.steps_done / self.elapsed / 1e6

    def to_record(self) -> dict:
        """The run record: the JAX package's payload keys, plus the route
        and the residual reads, under the envelope that names the card."""
        from heat2d_tpu_torch.obs.record import build_record
        return build_record(
            "run", config=self.config, steps_done=self.steps_done,
            elapsed_s=self.elapsed, mcells_per_s=self.mcells_per_s,
            warmup_s=self.warmup_s,
            extra={"route": self.route,
                   "residual_reads": self.residual_reads},
            device=self.device)


def _serial_runner(cfg: HeatConfig) -> engine.Runner:
    """The golden model's runner: plain PyTorch steps, convergence through
    the chunked loop (same plane sequence and steps_done as the JAX
    serial mode). A family other than heat5 steps with its plain update,
    which evaluates in the storage dtype as in the JAX package."""
    accum = getattr(torch, cfg.accum_dtype)
    if cfg.problem != "heat5":
        from heat2d_tpu_torch.problems import get_family
        fam = get_family(cfg.problem)

        def step(u):
            return fam.step(u, cfg.cx, cfg.cy)
    else:
        def step(u):
            return stencil_step(u, cfg.cx, cfg.cy, accum)

    def multi(u, n):
        for _ in range(n):
            u = step(u)
        return u

    def run(u):
        if cfg.convergence:
            return engine.run_convergence_chunked(
                multi, step, lambda a, b: residual_sq(a, b, accum), u,
                cfg.steps, cfg.interval, cfg.sensitivity, tap=runner.tap)
        return engine.run_fixed(step, u, cfg.steps)

    runner = engine.Runner(run, "serial")
    return runner


def _implicit_runner(cfg: HeatConfig, device) -> engine.Runner:
    """The runner of the implicit methods (adi, mg): the engine loops
    drive a Crank-Nicolson step instead of the explicit stencil, fixed
    steps through one multi-step, convergence through the chunked loop
    with the usual residual pair. ``(cx, cy)`` are diffusion numbers,
    unconditionally stable. Mode pallas with adi runs H10/H11 (route
    ``adi-kernel``); mode serial with adi the plain solve
    (``adi-scan``); mg is plain PyTorch in both modes."""
    from heat2d_tpu_torch.ops import multigrid as mgrid
    from heat2d_tpu_torch.ops import tridiag as td
    accum = getattr(torch, cfg.accum_dtype)

    if cfg.method == "adi" and cfg.mode == "pallas":
        cxa = torch.full((1,), cfg.cx, dtype=torch.float32, device=device)
        cya = torch.full((1,), cfg.cy, dtype=torch.float32, device=device)
        route = "adi-kernel"

        def step(u):
            return td.adi_sweep_kernel(u[None], cxa, cya)[0]

        def multi(u, n):
            return td.batched_adi_kernel(u[None], cxa, cya, steps=n)[0]
    elif cfg.method == "adi":
        route = "adi-scan"

        def step(u):
            return td.adi_step(u, cfg.cx, cfg.cy)

        def multi(u, n):
            return td.adi_multi_step(u, n, cfg.cx, cfg.cy)
    else:
        route = "mg"

        def step(u):
            return mgrid.mg_step(u, cfg.cx, cfg.cy)

        def multi(u, n):
            return mgrid.mg_multi_step(u, n, cfg.cx, cfg.cy)

    def run(u):
        if cfg.convergence:
            return engine.run_convergence_chunked(
                multi, step, lambda a, b: residual_sq(a, b, accum), u,
                cfg.steps, cfg.interval, cfg.sensitivity, tap=runner.tap)
        return multi(u, cfg.steps), cfg.steps

    runner = engine.Runner(run, route)
    return runner


class Heat2DSolver:
    def __init__(self, config: HeatConfig, device=None):
        check_ported(config)
        self.config = config
        self.device = resolve_device(device)
        self._runner = None

    def init_state(self):
        cfg = self.config
        return inidat(cfg.nxprob, cfg.nyprob, device=self.device)

    def place(self, u):
        """A host grid as a float32 tensor on this solver's device."""
        return state_from_numpy(u, self.device)

    def make_runner(self):
        """``u0 -> (u_final, steps_done)``; serial is the plain PyTorch
        golden model, pallas the kernel route, adi/mg the implicit
        runner."""
        if self._runner is None:
            if self.config.method != "explicit":
                self._runner = _implicit_runner(self.config, self.device)
            elif self.config.mode == "pallas":
                from heat2d_tpu_torch.ops.cuda_stencil import (
                    make_single_chip_runner)
                self._runner = make_single_chip_runner(self.config,
                                                       self.device)
            else:
                self._runner = _serial_runner(self.config)
        return self._runner

    def run(self, u0=None, timed: bool = True,
            warmup: bool = True) -> RunResult:
        """Init (unless given), step, copy back to the host. Timing follows
        the reference protocol: warmup excluded, fenced."""
        if u0 is None:
            u0 = self.init_state()
        runner = self.make_runner()
        warmup_s = None
        if timed:
            tc = timed_call(runner, u0, warmup=warmup)
            (u, k), elapsed = tc
            warmup_s = tc.warmup_s
        else:
            u, k = runner(u0)
            _fence(u)
            elapsed = float("nan")
        return RunResult(u=u.cpu().numpy(), steps_done=int(k),
                         elapsed=elapsed, config=self.config,
                         warmup_s=warmup_s, route=runner.route,
                         residual_reads=runner.residual_reads,
                         device=str(self.device))
