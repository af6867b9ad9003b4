"""Measurement library of the search: the port of
``heat2d_tpu/tune/measure.py``.

- ``two_point_estimate``: the adaptive two-point marginal step time
  ``bench_torch.py`` and the headline of ``chip_smoke.py`` time with,
  with its two constants;
- the link model the mesh scheduler prices cross-process seams with
  (``link_bytes_per_s``, ``route_bytes_per_s``);
- ``min_of_two_point``: the fixed-span, min-of-reps marginal;
- ``measure_candidate``: one search point end to end on the card (or on
  the ``SimulatedBackend``), its failure classified (``oom``,
  ``compile_error``, ``timeout``, ``error``) instead of ending the
  search, with ``tune_*`` metrics through an optional registry.

The marginal step time is (t_hi - t_lo) / (hi - lo), which cancels the
fixed cost of a timed call (the fence and the launches around the step
loop). A marginal is believed only when its window clears the noise:
more than 5x the jitter (the spread of the best two ``lo`` runs) and
more than ``NOISE_FLOOR_S``. ``two_point_estimate`` also asks the
estimate of the next decade to agree within ``AGREE_FACTOR``; at
``max_hi`` an unconfirmed estimate is accepted only if its window also
clears twice the floor, and otherwise there is no marginal and the
caller reports its end-to-end figure and says so.

The JAX package's ``probe_limits`` (which lifts the TPU's VMEM hard
limit for a probe) has no counterpart: the card's planners have no
limit to lift, and ``--probe-past-envelope`` simply measures the points
they refuse.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

from heat2d_tpu_torch.obs.roofline import H100_HBM_BYTES_PER_S
from heat2d_tpu_torch.tune.space import Candidate, Problem

#: Absolute floor of the timed window (seconds): a smaller window can be
#: pure fence noise even when it clears 5x the measured jitter.
NOISE_FLOOR_S = 0.05

#: Two marginal estimates a decade apart must agree within this factor
#: for either to be believed.
AGREE_FACTOR = 1.5

#: The card's memory bandwidth (``obs.roofline``'s calibrated H100 row):
#: what a 'local' seam, on-chip traffic of the kernel's own stream,
#: prices as.
HBM_BYTES_PER_S = H100_HBM_BYTES_PER_S

#: Per-direction link bandwidths by class (``DistWorld.link_kind``'s
#: vocabulary), the NVIDIA H100 80GB HBM3's data-sheet figures at its
#: 700 W power limit: 'ici' is two cards of one host over NVLink 4
#: (900 GB/s both ways, 450 GB/s each); 'dcn' is a strip leaving the
#: card for another host, which crosses the card's PCIe Gen5 x16 link
#: first (128 GB/s both ways, 64 GB/s each), the ceiling of any route
#: off the card. The ~7x asymmetry is what the seam pricing must see.
LINK_BYTES_PER_S = {"ici": 450e9, "dcn": 64e9}


#: The port's only route between processes, whatever their link class:
#: strips staged through pinned host buffers and moved by gloo
#: (``parallel/halo.py``). The rate of leg (a) of ``chip_smoke.py``'s
#: multi_process phase (bytes over seconds of the timed run's exchanges,
#: 64 KiB strips, 2 ranks on one card: 3.38e8 and 3.40e8 B/s), on an
#: NVIDIA H100 80GB HBM3 at its 700 W power limit, the slower rank's.
HOST_STAGED_BYTES_PER_S = 3.38e8


def link_bytes_per_s(kind: str) -> float:
    """Bandwidth of a link CLASS ('local' prices as HBM: on-chip traffic
    is the kernel's own stream, not a seam)."""
    if kind == "local":
        return HBM_BYTES_PER_S
    try:
        return LINK_BYTES_PER_S[kind]
    except KeyError:
        raise ValueError(
            f"unknown link kind {kind!r}; expected 'local' or one of "
            f"{sorted(LINK_BYTES_PER_S)}") from None


def route_bytes_per_s(kind: str, same_process: bool) -> float:
    """What a seam of link class ``kind`` moves per second on the port's
    route: the link's figure between slots of one process (a peer copy),
    at most the host-staged rate between processes (gloo through host
    buffers, the port's only route there)."""
    rate = link_bytes_per_s(kind)
    return rate if same_process else min(rate, HOST_STAGED_BYTES_PER_S)


def two_point_estimate(timed_run, lo, hi0, max_hi,
                       floor=NOISE_FLOOR_S, agree=AGREE_FACTOR):
    """Adaptive two-point marginal step time: ``(step_time | None, hi,
    result)``. ``timed_run(n)`` runs n steps and returns an object with
    ``.elapsed`` (seconds); ``lo`` is timed 3 times, each ``hi`` twice,
    and ``hi`` grows x10 from ``hi0`` up to ``max_hi`` until an estimate
    is confirmed (module docstring). ``result`` is the faster of the
    last two ``hi`` runs."""
    lo_ts = sorted(timed_run(lo).elapsed for _ in range(3))
    t_lo = lo_ts[0]
    # The spread of the best two of three: one outlier can neither fake
    # a tiny jitter nor poison t_lo.
    jitter = lo_ts[1] - lo_ts[0]
    prev = None
    hi = hi0
    while True:
        ra, rb = timed_run(hi), timed_run(hi)
        result = ra if ra.elapsed <= rb.elapsed else rb
        dt = result.elapsed - t_lo
        cand = dt / (hi - lo) if dt > max(5 * jitter, floor) else None
        if cand is not None and prev is not None:
            if max(cand, prev) <= agree * min(cand, prev):
                return cand, hi, result      # confirmed across a decade
        if hi >= max_hi:
            if cand is not None and dt > max(5 * jitter, 2 * floor):
                return cand, hi, result      # fully amortized window
            return None, hi, result
        prev = cand
        hi = min(hi * 10, max_hi)


def min_of_two_point(fn, u, lo: int, hi: int, reps: int = 4) -> float:
    """Fixed-span two-point marginal step time of ``fn(u, n)``, min of
    ``reps`` at each step count (the first call at each count warms up,
    the rest run warm)."""
    from heat2d_tpu_torch.utils.timing import timed_call

    def min_of(n):
        ts = [timed_call(fn, u, n)[1]]
        ts += [timed_call(fn, u, n, warmup=False)[1]
               for _ in range(reps - 1)]
        return min(ts)

    return (min_of(hi) - min_of(lo)) / (hi - lo)


# --------------------------------------------------------------------- #
# Failure classification
# --------------------------------------------------------------------- #

#: Terminal point statuses a resumed search never re-measures. "error"
#: is not terminal: an unclassified transient (a resident wait that gave
#: up, a window under the noise floor) is retried on the next run.
TERMINAL_STATUSES = ("ok", "oom", "compile_error", "timeout", "pruned")


class SimulatedOOM(RuntimeError):
    """The simulated backend's "the plan does not fit the card"."""


class SimulatedCompileError(RuntimeError):
    """The simulated backend's failed kernel build."""


def classify_failure(exc: BaseException) -> str:
    """Map a measurement exception to a failure class: "this config
    cannot work here" (``oom``, ``compile_error``) apart from "this run
    hiccuped" (``error``, retried on resume).

    - ``oom``: the card's allocator ran out (``torch.cuda.
      OutOfMemoryError``), or a planner refused the plan (a
      ``ConfigError``, or a ``ValueError`` about shared memory or a plan,
      as ``plan_tiles`` and the resident route raise);
    - ``compile_error``: ``nvcc`` failed (``ops/_build``), or a launch
      returned a CUDA error (a kernel's launch check);
    - ``error``: anything else.
    """
    import torch

    from heat2d_tpu_torch.config import ConfigError

    text = f"{type(exc).__name__}: {exc}"
    if isinstance(exc, (SimulatedOOM, ConfigError,
                        torch.cuda.OutOfMemoryError)):
        return "oom"
    if isinstance(exc, ValueError) and ("shared memory" in text
                                        or "no plan" in text
                                        or "does not fit" in text):
        return "oom"
    if isinstance(exc, SimulatedCompileError):
        return "compile_error"
    if isinstance(exc, RuntimeError) and ("nvcc" in text
                                          or "CUDA error" in text):
        return "compile_error"
    return "error"


@dataclasses.dataclass
class MeasureOutcome:
    """One measured search point. ``lo``/``hi``: the step counts of its
    two-point marginal (the spans, in the point's provenance)."""
    candidate: Candidate
    status: str                       # ok|oom|compile_error|timeout|error
    step_time_s: Optional[float] = None
    mcells_per_s: Optional[float] = None
    warmup_s: Optional[float] = None
    error: Optional[str] = None
    lo: Optional[int] = None
    hi: Optional[int] = None

    def to_point(self) -> dict:
        """The db row for this outcome (the knobs and the result)."""
        d = {"route": self.candidate.route, "bm": self.candidate.bm,
             "tsteps": self.candidate.tsteps, "status": self.status}
        if self.step_time_s is not None:
            d["step_time_s"] = self.step_time_s
            d["mcells_per_s"] = self.mcells_per_s
        if self.warmup_s is not None:
            d["warmup_s"] = round(self.warmup_s, 3)
        if self.lo is not None:
            d["steps"] = [self.lo, self.hi]
        if self.error:
            d["error"] = self.error[:200]
        return d


# --------------------------------------------------------------------- #
# Measurement on the card
# --------------------------------------------------------------------- #

#: The low step count of a route's two-point marginal: enough steps that
#: the fixed cost of a timed call is small beside them (240 steps of
#: 4096^2 through H2, 1000 of 640x1024 through H4).
ROUTE_LO = {"tile": 240, "resident": 1000, "fused": 240}

#: The window the high step count is picked to give the marginal: twice
#: ``NOISE_FLOOR_S``. On the H100 that is ~4,000 steps of 4096^2 through
#: H2 and ~60,000 of 640x1024 through H4.
WINDOW_S = 2 * NOISE_FLOOR_S

#: Slots of the fused route's mesh: a 2x2 mesh whose shards are the
#: problem's shape, all on one card (``parallel.mesh.host_devices``), so
#: its rate is the decomposition's cost on one card, not a four-card one.
FUSED_MESH = (2, 2)


def candidate_runner(problem: Problem, cand: Candidate, device="cuda"):
    """``(fn, u0)``: ``fn(u, n)`` advances ``n`` steps of the candidate's
    plan through the port's own entry points, from ``u0``, the reference
    initial condition on ``device``:

    - resident and tile: ``make_single_chip_runner``'s chunk with the
      candidate's knobs;
    - fused: hybrid ``--halo fused`` (H14) on a ``FUSED_MESH`` mesh of
      ``host_devices(4)`` slots of ``device``, each shard of the
      problem's shape, at the candidate's overlap depth. A depth H14
      cannot serve raises rather than time the collective route.
    """
    from heat2d_tpu_torch.config import HeatConfig
    from heat2d_tpu_torch.tune.db import TunedConfig

    if cand.route == "fused":
        from heat2d_tpu_torch.parallel import sharded as sh
        from heat2d_tpu_torch.parallel.mesh import host_devices, make_mesh
        gx, gy = FUSED_MESH
        cfg = HeatConfig(nxprob=problem.nx * gx, nyprob=problem.ny * gy,
                         steps=0, mode="hybrid", gridx=gx, gridy=gy,
                         halo="fused", halo_depth=cand.tsteps)
        mesh = make_mesh(gx, gy, host_devices(gx * gy, device))
        if not sh._fused_kernel_viable(cfg, mesh, cand.tsteps):
            raise ValueError(f"H14 cannot serve a {problem.nx}x{problem.ny} "
                             f"shard at T={cand.tsteps}: no plan")
        return (sh.make_local_multi(cfg, mesh, kernel=True),
                sh.sharded_inidat(cfg, mesh))
    from heat2d_tpu_torch.ops.cuda_stencil import make_single_chip_runner
    from heat2d_tpu_torch.ops.init import inidat
    cfg = HeatConfig(nxprob=problem.nx, nyprob=problem.ny, steps=0,
                     mode="pallas")
    tuned = TunedConfig(cand.route, cand.bm, cand.tsteps, "search",
                        problem.key())
    runner = make_single_chip_runner(cfg, device, tuned=tuned)
    return runner.chunk, inidat(problem.nx, problem.ny, device=device)


def _cells(problem: Problem, cand: Candidate) -> int:
    """The cells a step updates: the interior of one grid (the JAX
    package's count), or the fused mesh's whole grid."""
    if cand.route == "fused":
        return problem.cells * FUSED_MESH[0] * FUSED_MESH[1]
    return (problem.nx - 2) * (problem.ny - 2)


def _measure_real(problem: Problem, cand: Candidate, *, lo, reps, window_s,
                  compile_timeout_s, device) -> MeasureOutcome:
    """The two-point marginal of one candidate on the card: the first
    ``lo`` run pays the build and warmup (the compile wall's reading),
    then ``reps`` runs at ``lo`` and ``reps`` at a ``hi`` picked from
    the ``lo`` time to give a ``window_s`` window (raised once more if
    the fixed cost of a call made the first pick short). A window that
    does not clear the noise rules is no marginal: status ``error``."""
    from heat2d_tpu_torch.utils.timing import timed_call

    fn, u = candidate_runner(problem, cand, device)
    first = timed_call(fn, u, lo)
    warmup = first.warmup_s
    if compile_timeout_s is not None and warmup > compile_timeout_s:
        return MeasureOutcome(cand, "timeout", warmup_s=warmup,
                              error=f"build+warmup {warmup:.1f}s over the "
                                    f"{compile_timeout_s:.0f}s wall")
    ts = sorted([first.elapsed] + [timed_call(fn, u, lo, warmup=False)
                                   .elapsed for _ in range(reps - 1)])
    t_lo = ts[0]
    jitter = ts[1] - ts[0] if len(ts) > 1 else 0.0
    hi = lo + math.ceil(window_s * lo / t_lo)
    for _ in range(2):
        t_hi = min(timed_call(fn, u, hi, warmup=False).elapsed
                   for _ in range(reps))
        dt = t_hi - t_lo
        if dt >= 0.8 * window_s:
            break
        hi = lo + math.ceil((hi - lo) * window_s / max(dt, 1e-4))
    if dt <= max(5 * jitter, NOISE_FLOOR_S):
        return MeasureOutcome(
            cand, "error", warmup_s=warmup, lo=lo, hi=hi,
            error=f"window {dt:.4f}s at {lo}->{hi} steps does not clear "
                  f"the noise (jitter {jitter:.4f}s, floor "
                  f"{NOISE_FLOOR_S}s)")
    step = dt / (hi - lo)
    return MeasureOutcome(cand, "ok", step_time_s=step,
                          mcells_per_s=_cells(problem, cand) / step / 1e6,
                          warmup_s=warmup, lo=lo, hi=hi)


def measure_candidate(problem: Problem, cand: Candidate, *, backend=None,
                      lo: Optional[int] = None, reps: int = 4,
                      window_s: float = WINDOW_S,
                      compile_timeout_s: Optional[float] = 300.0,
                      registry=None, device="cuda") -> MeasureOutcome:
    """Measure one search point: on the deterministic simulated backend
    when given, else on the card (``device``, a CUDA device; ``lo``
    defaults to the route's ``ROUTE_LO``). A failure comes back
    classified in the outcome: a search never ends on one bad point. A
    real measurement asked of a CPU device, or of a card that is not
    there, raises before anything is measured."""
    if backend is None:
        from heat2d_tpu_torch.utils.device import resolve_device
        device = resolve_device(device)
        if device.type != "cuda":
            raise ValueError(
                "a real measurement runs on the card; on the CPU the "
                "search takes the simulated backend (--simulate)")
    t0 = time.perf_counter()
    try:
        if backend is not None:
            step = backend.step_time(problem, cand)
            out = MeasureOutcome(
                cand, "ok", step_time_s=step,
                mcells_per_s=(problem.nx - 2) * (problem.ny - 2)
                / step / 1e6)
        else:
            out = _measure_real(
                problem, cand, lo=lo or ROUTE_LO[cand.route], reps=reps,
                window_s=window_s, compile_timeout_s=compile_timeout_s,
                device=device)
    except Exception as e:  # noqa: BLE001 — classify and carry on
        out = MeasureOutcome(cand, classify_failure(e),
                             error=f"{type(e).__name__}: {e}")
    if registry is not None:
        registry.counter("tune_points_measured_total",
                         status=out.status)
        registry.observe("tune_measure_s", time.perf_counter() - t0)
    return out


# --------------------------------------------------------------------- #
# Simulated backend
# --------------------------------------------------------------------- #

class SimulatedBackend:
    """A deterministic analytic step-time model of the card's routes:
    NOT a performance oracle, a stand-in with the right shape (a payoff
    of depth with diminishing returns, a ring recompute that grows with
    it, plans that stop fitting) so that the search, db and resume logic
    and their tests run on the CPU in milliseconds and reproduce the
    same frontier bit for bit. Its plans are the port's planners' for
    the H100, and it raises the card's failure classes: a tile or a K
    the planners cannot fit raises ``SimulatedOOM``, and the one point
    ``build_error`` names raises ``SimulatedCompileError``.

    Model, per step: the tile route streams the grid through device
    memory twice per sweep of T steps and recomputes a ring of T cells
    around each tile, plus one launch per sweep; the resident route
    updates every tile's ext once and pays an exchange every K steps;
    the fused route (per shard) hides its edge traffic under the
    interior sweep, recomputes ~6T(bm + bn) seam cells, and pays a
    launch per T steps."""

    device_kind = "sim-h100"
    HBM_BYTES_PER_S = HBM_BYTES_PER_S
    CELL_UPDATES_PER_S = 1.0e12
    LAUNCH_S = 4e-6
    EXCHANGE_S = 2e-6

    #: The fused route's edge traffic crosses NVLink between the mesh's
    #: cards.
    LINK_BYTES_PER_S = LINK_BYTES_PER_S["ici"]

    def __init__(self, build_error: Optional[Candidate] = None):
        """``build_error``: the candidate whose "build" fails."""
        self.build_error = build_error

    def step_time(self, problem: Problem, cand: Candidate) -> float:
        from heat2d_tpu_torch.ops import cuda_stencil as cs
        from heat2d_tpu_torch.ops import resident as res
        from heat2d_tpu_torch.parallel.halo import fused_halo_viable

        if cand == self.build_error:
            raise SimulatedCompileError(f"nvcc failed for {cand.label()}")
        nx, ny, itemsize = problem.nx, problem.ny, problem.itemsize
        rate = self.CELL_UPDATES_PER_S
        smem = cs.H100_SMEM_OPTIN - cs._STATIC_SMEM
        if cand.route == "resident":
            plan = res.plan_for_limits(1, nx, ny, 1, smem,
                                       res.H100_SM_COUNT, cand.tsteps)
            if plan is None:
                raise SimulatedOOM(f"no resident plan for {nx}x{ny} at "
                                   f"K={cand.tsteps}")
            ey, ex = plan.ext
            exchange = self.EXCHANGE_S / plan.k if plan.tiles > 1 else 0.0
            return plan.tiles * ey * ex / rate + exchange
        t = cand.tsteps
        if cand.route == "fused":
            if not fused_halo_viable(nx, ny, t):
                raise SimulatedOOM(f"fused overlap frames exceed the "
                                   f"{nx}x{ny} shard at T={t}")
            try:
                cs.plan_strip_sweep(nx, ny, t)
            except ValueError as e:
                raise SimulatedOOM(str(e)) from None
            compute = problem.cells / rate
            edge = 2 * (nx + ny) * itemsize / self.LINK_BYTES_PER_S
            seam = 6 * t * (nx + ny) / problem.cells
            return max(compute, edge) + compute * seam + self.LAUNCH_S / t
        try:
            plan = cs.plan_strip_sweep(nx, ny, t, ty=cand.bm)
        except ValueError as e:
            raise SimulatedOOM(str(e)) from None
        if plan.ty != cand.bm:
            raise SimulatedOOM(f"a tile of {cand.bm} rows does not fit at "
                               f"T={t}")
        ring = ((plan.ty + 2 * t) * (plan.tx + 2 * t)
                / (plan.ty * plan.tx))
        stream = 2 * problem.cells * itemsize * ring / t \
            / self.HBM_BYTES_PER_S
        compute = problem.cells * (1 + (ring - 1) / 2) / rate
        return max(compute, stream) + self.LAUNCH_S / t
