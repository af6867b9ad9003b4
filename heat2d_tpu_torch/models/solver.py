"""Heat2DSolver: the port of ``heat2d_tpu/models/solver.py``.

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
dist1d, dist2d        the golden loop over a mesh of shards
                      (``parallel.sharded``): row strips of mpi_heat2Dn.c,
                      blocks of grad1612_mpi_heat.c
hybrid                the mesh with a hand kernel per shard (H12/H13, or
                      H14 with ``halo='fused'``): grad1612_hybrid_heat.c
====================  ====================================================

The solver runs on ``cuda`` unless it is given ``device="cpu"``. A mesh
takes its slots from ``devices`` (default: the visible devices of that
type); ``parallel.mesh.host_devices(n)`` lets n shards share fewer cards.
In a multi-process world ``owners`` names each slot's process
(``parallel.multihost.world_slots``) and every process runs its own
shards.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from heat2d_tpu_torch.config import SHARDED_MODES, ConfigError, HeatConfig
from heat2d_tpu_torch.interop import sharded_from_numpy, state_from_numpy
from heat2d_tpu_torch.models import engine
from heat2d_tpu_torch.ops.init import inidat
from heat2d_tpu_torch.ops.stencil import residual_sq, stencil_step
from heat2d_tpu_torch.utils.device import resolve_device
from heat2d_tpu_torch.utils.profiling import phase
from heat2d_tpu_torch.utils.timing import _fence, timed_call


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
    # Sharded runs: resolve_halo_route's dict (route, tier, depth, mesh,
    # shard) and the mesh the run used; None on one device.
    halo: Optional[dict] = None
    mesh: object = None
    # Every process's own elapsed seconds, in process order (``elapsed``
    # is their max, the reference's MPI_Reduce(MPI_MAX)); None untimed.
    elapsed_by_process: Optional[list] = None
    # This process's cross-process halo totals over the timed run
    # (``TimedCall.exchange``); None in one process or untimed.
    exchange: Optional[dict] = None

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
        from heat2d_tpu_torch.obs.record import build_record, halo_record
        extra = {"route": self.route, "residual_reads": self.residual_reads}
        if self.elapsed_by_process is not None:
            extra["elapsed_by_process"] = self.elapsed_by_process
        if self.halo is not None:
            from heat2d_tpu_torch.parallel.mesh import mesh_devices_summary
            extra["halo"] = halo_record(self.halo, self.mesh)
            extra["mesh"] = mesh_devices_summary(self.mesh)
        return build_record(
            "run", config=self.config, steps_done=self.steps_done,
            elapsed_s=self.elapsed, mcells_per_s=self.mcells_per_s,
            warmup_s=self.warmup_s, extra=extra, device=self.device)


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
        coefs = {}

        def axes(u):
            # (cp, mi) of both axes, computed once per grid shape
            if u.shape not in coefs:
                coefs[u.shape] = td.adi_coeffs(u[None], cxa, cya)
            return coefs[u.shape]

        def step(u):
            return td.adi_sweep_kernel(u[None], cxa, cya, axes(u))[0]

        def multi(u, n):
            return td.batched_adi_kernel(u[None], cxa, cya, steps=n,
                                         coefs=axes(u))[0]
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
    def __init__(self, config: HeatConfig, device=None, devices=None,
                 owners=None, telemetry=None):
        """``devices``: the slots of a distributed mode's mesh (default:
        every visible device of ``device``'s type); ``owners``: the
        process of each slot, for a mesh that spans processes;
        ``telemetry``: an ``obs.stream.TelemetryStream`` that receives
        every residual the convergence loops read."""
        with phase("solve.construct"):
            self._construct(config, device, devices, owners, telemetry)

    def _construct(self, config, device, devices, owners, telemetry):
        self.config = config
        self.telemetry = telemetry
        self.mesh = None
        if config.mode in SHARDED_MODES:
            from heat2d_tpu_torch.parallel.mesh import (make_mesh,
                                                        visible_devices)
            if devices is None:
                devices = visible_devices(device)
            devices = [resolve_device(d) for d in devices]
            if len({d.type for d in devices}) != 1:
                raise ConfigError("a mesh's devices must all be cards or "
                                  "all the CPU")
            if config.mode == "dist1d":
                self.mesh = make_mesh(config.numworkers or config.gridx, 1,
                                      devices, owners)
            else:
                self.mesh = make_mesh(config.gridx, config.gridy, devices,
                                      owners)
            local = self.mesh.local_devices()
            self.device = local[0] if local else devices[0]
        else:
            self.device = resolve_device(device)
        self._runner = None

    def init_state(self):
        """The initial condition, sharded over the mesh in the
        distributed modes."""
        cfg = self.config
        if self.mesh is not None:
            from heat2d_tpu_torch.parallel.sharded import sharded_inidat
            return sharded_inidat(cfg, self.mesh)
        return inidat(cfg.nxprob, cfg.nyprob, device=self.device)

    def place(self, u):
        """A host grid as this solver's state: a float32 tensor on its
        device, or a ``ShardedGrid`` padded to equal shards."""
        if self.mesh is not None:
            return sharded_from_numpy(u, self.config, self.mesh)
        return state_from_numpy(u, self.device)

    def make_runner(self):
        """``u0 -> (u_final, steps_done)``; serial is the plain PyTorch
        golden model, pallas the kernel route, adi/mg the implicit
        runner, the distributed modes the sharded runner."""
        if self._runner is None:
            cfg = self.config
            if self.mesh is not None:
                from heat2d_tpu_torch.parallel.sharded import (
                    make_sharded_runner)
                self._runner = make_sharded_runner(
                    cfg, self.mesh, kernel=cfg.mode == "hybrid")
            elif cfg.method != "explicit":
                self._runner = _implicit_runner(cfg, self.device)
            elif cfg.mode == "pallas":
                from heat2d_tpu_torch.ops.cuda_stencil import (
                    make_single_chip_runner)
                self._runner = make_single_chip_runner(cfg, self.device)
            else:
                self._runner = _serial_runner(cfg)
            if self.telemetry is not None:
                self._runner.stream = self.telemetry.tap
        return self._runner

    def run(self, u0=None, timed: bool = True, warmup: bool = True,
            gather: bool = True) -> RunResult:
        """Init (unless given), step, copy back to the host. Timing follows
        the reference protocol: warmup excluded, fenced on every device.
        ``gather=False`` leaves a sharded result as its ``ShardedGrid``
        (padded), for ``io.binary.write_binary_sharded``; otherwise the
        result is the host grid, the padding cropped. Its steps are the
        hook's ``solve.prepare``, ``solve.launch``, ``solve.fence`` (the
        untimed run's) and ``solve.gather`` (``utils.profiling.phase``)."""
        with phase("solve.prepare"):
            if u0 is None:
                u0 = self.init_state()
            runner = self.make_runner()
        warmup_s = by_process = exchange = None
        if timed:
            tc = timed_call(runner, u0, warmup=warmup)
            (u, k), elapsed = tc
            warmup_s, by_process = tc.warmup_s, tc.elapsed_by_process
            exchange = tc.exchange
        else:
            with phase("solve.launch"):
                u, k = runner(u0)
            with phase("solve.fence"):
                _fence(u)
            elapsed = float("nan")
        if gather:
            from heat2d_tpu_torch.parallel.multihost import gather_to_host
            with phase("solve.gather"):
                u = gather_to_host(u)[:self.config.nxprob,
                                      :self.config.nyprob]
        return RunResult(u=u, steps_done=int(k), elapsed=elapsed,
                         config=self.config, warmup_s=warmup_s,
                         route=runner.route,
                         residual_reads=runner.residual_reads,
                         device=str(self.device),
                         halo=getattr(runner, "halo", None), mesh=self.mesh,
                         elapsed_by_process=by_process, exchange=exchange)


def two_point_headline(nx: int, ny: int, lo: int, hi: int,
                       mode: str = "pallas", device=None) -> dict:
    """The headline's two-point protocol, ``bench.py``'s: fixed-step runs
    of ``lo`` and ``hi`` steps through ``tune.measure.two_point_estimate``
    (3 timed runs at ``lo``, 2 at ``hi``, the first run of each count
    after a warmup run; the marginal step time believed only past the
    estimator's noise floor and jitter rules). Returns ``step_s`` (None
    when the two points lie within noise), ``t_lo_s`` and ``t_hi_s``
    (the fastest run at each count), every run's seconds as ``times``,
    and the faster ``hi`` run's ``RunResult`` as ``result``.
    ``bench_torch.py`` and ``chip_smoke.py`` both time the headline with
    it."""
    from heat2d_tpu_torch.tune.measure import two_point_estimate

    solvers, times = {}, {}

    def timed_run(n):
        fresh = n not in solvers
        if fresh:
            solvers[n] = Heat2DSolver(
                HeatConfig(nxprob=nx, nyprob=ny, steps=n, mode=mode),
                device=device)
        r = solvers[n].run(warmup=fresh)
        times.setdefault(n, []).append(r.elapsed)
        return r

    step_s, _hi, result = two_point_estimate(timed_run, lo, hi, hi)
    return {"step_s": step_s, "t_lo_s": min(times[lo]),
            "t_hi_s": min(times[hi]), "times": times, "result": result}
