"""Ensemble runs: one launch advances a batch of (cx, cy) members of one
grid shape. The port of ``heat2d_tpu/models/ensemble.py`` for one device.

A batch is a (B, nx, ny) float32 tensor; (cxs, cys) are float32 vectors
on its device. Methods (``method``) of the reference problem heat5:

=======  ==================================================================
jnp      the golden step on the batch (``ops.stencil.stencil_step``):
         per member the operations of the solver's serial mode
pallas   H5 ``ens_resident``: all steps of every member in one
         cooperative launch (members that pass ``fits_resident``)
band     H6 ``ens_tile_multi`` sweeps of shared-memory tiles; convergence
         runs H7 ``ens_tile_multi_conv``, the fused-residual schedule
adi      Crank-Nicolson ADI (``ops.tridiag``), its tridiagonal solves
         through H10 ``td_rows`` (x) and H11 ``td_lanes`` (y); (cx, cy)
         are diffusion numbers, free of the explicit stability box
mg       Crank-Nicolson stepped by multigrid V-cycles (``ops.multigrid``,
         plain PyTorch: the JAX package runs no kernel of its own there)
auto     pallas when one member passes ``fits_resident``, band otherwise
         (per member, as the JAX package gates on ``fits_vmem``)
=======  ==================================================================

The other problem families run the routes of ``problems/runners.py``
(jnp, H8 for pallas, H9 for band), their route checked against the
family's capability matrix (``pick_route``).

Convergence freezes each member at its own exit: a member that converges
in a chunk keeps that chunk's plane and stops from the next chunk on,
``done`` only grows, and the ``steps % interval`` remainder runs unchecked
on the members still going. Each chunk reads one bool (all done?) to the
host; ``tap(chunk, steps_done, residuals, done)`` reports every read.
heat5's jnp and band routes have loops of their own; every other route,
and every route of the other families, runs the pair-tracked loop
(``_run_batch_conv_chunked``), as in the JAX package.

Sharded and spatial ensembles wait for slice 6 of ROADMAP.md.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from heat2d_tpu_torch import vocab
from heat2d_tpu_torch.interop import batch_from_numpy
from heat2d_tpu_torch.models import engine
from heat2d_tpu_torch.ops import cuda_ensemble as ce
from heat2d_tpu_torch.ops import multigrid as mgrid
from heat2d_tpu_torch.ops import tridiag as td
from heat2d_tpu_torch.ops.cuda_stencil import DEFAULT_TSTEPS, fits_resident
from heat2d_tpu_torch.ops.init import inidat
from heat2d_tpu_torch.ops.stencil import stencil_step
from heat2d_tpu_torch.problems import runners as prunners
from heat2d_tpu_torch.utils.device import resolve_device
from heat2d_tpu_torch.utils.profiling import phase
from heat2d_tpu_torch.utils.timing import timed_call


def _validated_batch(nx, ny, cxs, cys, u0, device=None):
    """(cxs, cys, u0) as tensors on the device; ``u0`` defaults to B
    copies of the reference initial condition."""
    dev = resolve_device(device)
    if u0 is None:
        n = len(cxs) if not isinstance(cxs, torch.Tensor) else cxs.numel()
        u0 = inidat(nx, ny, device=dev).expand(n, nx, ny)
    u0, cxs, cys = batch_from_numpy(u0, cxs, cys, dev)
    if tuple(u0.shape[1:]) != (nx, ny):
        raise ValueError(f"u0 must be ({cxs.shape[0]}, {nx}, {ny}), got "
                         f"{tuple(u0.shape)}")
    return cxs, cys, u0


# --------------------------------------------------------------------- #
# Fixed-step routes
# --------------------------------------------------------------------- #

def _run_batch_jnp(u0, cxs, cys, *, steps):
    u = u0
    cx, cy = ce.member_coefs(cxs, cys)
    for _ in range(steps):
        u = stencil_step(u, cx, cy)
    return u


def _run_batch_pallas(u0, cxs, cys, *, steps):
    with phase("stencil_chunk"):
        return ce.ens_resident(u0, steps, cxs, cys)


def _run_batch_band(u0, cxs, cys, *, steps):
    with phase("stencil_chunk"):
        return ce.ens_tiled_chunk(u0, steps, cxs, cys)


def _run_batch_adi(u0, cxs, cys, *, steps):
    """Crank-Nicolson ADI (Peaceman-Rachford): each half step's
    tridiagonal systems through H10 (x half) and H11 (y half). The (cx,
    cy) are the step's diffusion numbers and may sit far past the
    explicit box. The JAX package takes its TD kernel only where a member
    fits VMEM; the card has no such envelope, so every batch takes
    H10/H11 (a CPU batch their plain versions)."""
    with phase("stencil_chunk"):
        return td.batched_adi_kernel(u0, cxs, cys, steps=steps)


def _run_batch_mg(u0, cxs, cys, *, steps):
    """Unsplit Crank-Nicolson stepped by geometric multigrid V-cycles, the
    whole batch at once (per member the operations of the single grid)."""
    with phase("stencil_chunk"):
        return mgrid.mg_multi_step(u0, steps, cxs, cys)


_BATCH_RUNNERS = {"jnp": _run_batch_jnp, "pallas": _run_batch_pallas,
                  "band": _run_batch_band, "adi": _run_batch_adi,
                  "mg": _run_batch_mg}


# --------------------------------------------------------------------- #
# Convergence (early-exit) routes
# --------------------------------------------------------------------- #

def _all_done(i, k, res, done, tap) -> bool:
    """The chunk's one host read (all members done?), reported to
    ``tap``."""
    finished = bool(done.all())
    if tap is not None:
        tap(i, k, res, done)
    return finished


def _run_batch_conv_jnp(u0, cxs, cys, *, steps, interval, sensitivity,
                        tap=None):
    """Every member runs ``engine.run_convergence`` on the golden step:
    checks after every INTERVAL steps and after a final partial chunk,
    and a member stops once its residual is no longer >= sensitivity (so
    a NaN residual stops it too), the JAX package's vmapped loop."""
    interval = min(interval, steps) if steps else interval
    b = u0.shape[0]
    cx, cy = ce.member_coefs(cxs, cys)
    u = u0
    k = torch.zeros(b, dtype=torch.int32, device=u0.device)
    done = torch.zeros(b, dtype=torch.bool, device=u0.device)
    ran, i = 0, 0
    while ran < steps:
        n = min(interval, steps - ran)
        prev, new = u, u
        for _ in range(n):
            prev, new = new, stencil_step(new, cx, cy)
        res = ce.member_residuals(new, prev)
        u = torch.where(done.reshape(-1, 1, 1), u, new)
        k = torch.where(done, k, k + n)
        done = done | ~(res >= sensitivity)
        ran, i = ran + n, i + 1
        if _all_done(i, k, res, done, tap):
            break
    return u, k


def _run_batch_conv_chunked(u0, cxs, cys, *, steps, interval, sensitivity,
                            runner, tap=None):
    """The pair-tracked batched loop over a fixed-step runner (the JAX
    package's ``_run_batch_conv_kernel``): each chunk is ``interval - 1``
    steps plus one tracked step; a member converges when its residual
    of that pair is < sensitivity."""
    if steps:
        interval = max(1, min(interval, steps))
    n_chunks = steps // interval if interval else 0
    remainder = steps - n_chunks * interval
    b = u0.shape[0]
    u = u0
    chunks = torch.zeros(b, dtype=torch.int32, device=u0.device)
    done = torch.zeros(b, dtype=torch.bool, device=u0.device)
    for i in range(1, n_chunks + 1):
        u_prev = runner(u, cxs, cys, steps=interval - 1) \
            if interval > 1 else u
        u_new = runner(u_prev, cxs, cys, steps=1)
        with phase("residual_reduction"):
            res = ce.member_residuals(u_new, u_prev)
        u = torch.where(done.reshape(-1, 1, 1), u, u_new)
        chunks = torch.where(done, chunks, chunks + 1)
        done = done | (res < sensitivity)
        if _all_done(i, chunks * interval, res, done, tap):
            break
    k = chunks * interval
    if remainder:
        u_adv = runner(u, cxs, cys, steps=remainder)
        u = torch.where(done.reshape(-1, 1, 1), u, u_adv)
        k = torch.where(done, k, k + remainder)
    return u, k


def _run_batch_conv_window(u0, cxs, cys, *, steps, interval, sensitivity,
                           tap=None):
    """The convergence loop of method 'band', fused (H7): each INTERVAL
    chunk runs ``interval - d`` steps in act-gated sweeps, then one sweep
    of depth ``d = interval % T or T`` that also yields each member's
    residual of the last step pair. Frozen members pass through the
    kernel unchanged and report residual 0, which cannot un-converge
    them. The JAX package takes its fused route only where the TPU's
    gates hold (a lane-aligned width, a probed VMEM envelope) and the
    pair-tracked loop elsewhere; the card has no such gate, so every
    member shape takes this one."""
    t = DEFAULT_TSTEPS
    iv = max(1, min(interval, steps)) if steps else interval
    n_chunks = steps // iv if iv else 0
    remainder = steps - n_chunks * iv
    b = u0.shape[0]

    def multi(v, n, act):
        with phase("stencil_chunk"):
            return ce.ens_tiled_chunk(v, n, cxs, cys, act)

    def act_of(done):
        return (~done).to(torch.int32)

    u = u0
    chunks = torch.zeros(b, dtype=torch.int32, device=u0.device)
    done = torch.zeros(b, dtype=torch.bool, device=u0.device)
    d = iv % t or t
    for i in range(1, n_chunks + 1):
        act = act_of(done)
        u = multi(u, iv - d, act)
        with phase("residual_reduction"):
            u, res = ce.ens_tile_multi_conv(u, d, cxs, cys, act,
                                            resid=True)
        chunks = torch.where(done, chunks, chunks + 1)
        done = done | (res < sensitivity)
        if _all_done(i, chunks * iv, res, done, tap):
            break
    k = chunks * iv
    if remainder:
        u = multi(u, remainder, act_of(done))
        k = torch.where(done, k, k + remainder)
    return u, k


def _conv_runner(method, steps, interval, sensitivity):
    """``(u0, cxs, cys, tap=None) -> (u, steps_done)`` for a heat5
    method."""
    kw = dict(steps=steps, interval=interval, sensitivity=sensitivity)
    if method == "jnp":
        return functools.partial(_run_batch_conv_jnp, **kw)
    if method == "band":
        return functools.partial(_run_batch_conv_window, **kw)
    return functools.partial(_run_batch_conv_chunked, **kw,
                             runner=_BATCH_RUNNERS[method])


def _pick_method(method, nx, ny, device):
    if method != "auto":
        return method
    return "pallas" if fits_resident((nx, ny), device) else "band"


def _route(method, problem, nx, ny, device) -> str:
    """The route a (method, problem) pair runs on ``device``: for heat5
    the method (auto resolved by ``_pick_method``), for the other
    families ``problems.runners.pick_route``, which raises a
    ``ConfigError`` naming an unsupported combination."""
    if problem != vocab.DEFAULT_PROBLEM:
        return prunners.pick_route(problem, method, nx, ny, device)
    if method not in vocab.SERVE_METHODS:
        raise ValueError(f"method {method!r} not in {vocab.SERVE_METHODS}")
    return _pick_method(method, nx, ny, device)


def _fixed_fn(route, problem, steps):
    """``(u0, cxs, cys) -> batch`` for a resolved route."""
    return functools.partial(prunners.fixed_runner(problem, route),
                             steps=steps)


def _conv_fn(route, problem, steps, interval, sensitivity):
    """``(u0, cxs, cys, tap=None) -> (u, steps_done)`` for a resolved
    route: heat5's loops, or the pair-tracked loop over the family's
    fixed-step runner."""
    if problem == vocab.DEFAULT_PROBLEM:
        return _conv_runner(route, steps, interval, sensitivity)
    return functools.partial(
        _run_batch_conv_chunked, steps=steps, interval=interval,
        sensitivity=sensitivity,
        runner=prunners.fixed_runner(problem, route))


@functools.lru_cache(maxsize=128)
def batch_runner(nx: int, ny: int, steps: int, method: str = "auto",
                 convergence: bool = False, interval: int = 20,
                 sensitivity: float = 0.1, problem: str = "heat5",
                 device: str = "cuda"):
    """The per-signature runner, memoized so that a long-lived caller
    (``serve/engine.py``) reuses one callable per signature: ``(u0, cxs,
    cys) -> batch`` (fixed-step) or ``-> (batch, steps_done)``
    (convergence). (cx, cy) are operands, so members with different
    diffusivities share it. ``run.method`` is the route it resolved."""
    dev = resolve_device(device)
    route = _route(method, problem, nx, ny, dev)
    if convergence:
        run = _conv_fn(route, problem, steps, interval, sensitivity)
    else:
        run = _fixed_fn(route, problem, steps)
    run.method = route
    return run


def run_ensemble(nx: int, ny: int, steps: int, cxs, cys, u0=None,
                 method: str = "auto", problem: str = "heat5", device=None):
    """Advance an ensemble of diffusivity pairs ``steps`` steps. ``cxs`` /
    ``cys``: equal-length 1D sequences of B values; ``u0``: an optional
    (B, nx, ny) batch (default: B copies of the reference initial
    condition). Returns the (B, nx, ny) batch on the device."""
    cxs, cys, u0 = _validated_batch(nx, ny, cxs, cys, u0, device)
    fn = batch_runner(nx, ny, steps, method, problem=problem,
                      device=str(u0.device))
    return fn(u0, cxs, cys)


def run_ensemble_convergence(nx: int, ny: int, steps: int, interval: int,
                             sensitivity: float, cxs, cys, u0=None,
                             method: str = "auto", tap=None,
                             problem: str = "heat5", device=None):
    """Ensemble with per-member convergence early exit. Returns (batch,
    steps_done): converged members froze at their exit plane, and
    ``steps_done[i]`` is member i's iteration count (int32 tensor)."""
    cxs, cys, u0 = _validated_batch(nx, ny, cxs, cys, u0, device)
    route = _route(method, problem, nx, ny, u0.device)
    fn = _conv_fn(route, problem, steps, interval, sensitivity)
    return fn(u0, cxs, cys, tap=tap)


class EnsembleResult(NamedTuple):
    batch: torch.Tensor
    steps_done: Optional[torch.Tensor]   # None on fixed-step runs
    elapsed: float                       # seconds, reference protocol
    method: str                          # the route that ran
    residual_reads: int                  # host reads of the timed run
    warmup_s: Optional[float]


def timed_ensemble(nx: int, ny: int, steps: int, cxs, cys, u0=None,
                   method: str = "auto", convergence: bool = False,
                   interval: int = 20, sensitivity: float = 0.1,
                   problem: str = "heat5", device=None) -> EnsembleResult:
    """One ensemble launch under the reference timing protocol (an
    untimed warmup run, then a fenced timed run): the CLI's entry."""
    cxs, cys, u0 = _validated_batch(nx, ny, cxs, cys, u0, device)
    method = _route(method, problem, nx, ny, u0.device)
    if convergence:
        conv = _conv_fn(method, problem, steps, interval, sensitivity)

        def run(u):
            return conv(u, cxs, cys, tap=runner.tap)
    else:
        fixed = _fixed_fn(method, problem, steps)

        def run(u):
            return fixed(u, cxs, cys), None

    runner = engine.Runner(run, method)
    tc = timed_call(runner, u0)
    (u, k), elapsed = tc
    return EnsembleResult(u, k, elapsed, method, runner.residual_reads,
                          tc.warmup_s)


def ensemble_summary(batch, steps_done=None) -> dict:
    """Per-member diagnostics (max temperature, total heat), plus the
    per-member iteration counts of convergence runs."""
    if isinstance(batch, torch.Tensor):
        batch = batch.cpu().numpy()
    batch = np.asarray(batch)
    out = {
        "members": int(batch.shape[0]),
        "max_temperature": [float(m) for m in batch.max(axis=(1, 2))],
        "total_heat": [float(s) for s in batch.sum(axis=(1, 2))],
    }
    if steps_done is not None:
        out["steps_done"] = [int(s) for s in steps_done]
    return out
