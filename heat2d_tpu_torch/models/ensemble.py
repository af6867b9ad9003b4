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

With a tuning db active (``tune/``), pallas takes H5's chunk depth K (on
a one-member launch) and band H6/H7's sweep depth and tile height from
the db's answer for the member shape (``tuned_config``), at every
launch; the results are bitwise the untuned ones.

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

Each convergence loop is a generator that yields once per chunk, after
the chunk's launches and before its host read; ``_drive_all`` runs
loops to their ends. The sharded ensembles drive one loop per slot in
turn, so that every slot's chunk is queued before the first of them is
read.

Over several device slots (``parallel.mesh``: the visible cards, or n
slots sharing fewer cards through ``host_devices(n)``):

- ``run_ensemble_sharded`` / ``run_ensemble_convergence_sharded``: the
  members split over the slots (padded to a slot multiple with inert
  members, cx = cy = 0), each slot running the single-device route on
  its members (H5, H6 or H7 on the card);
- ``run_ensemble_spatial`` / ``spatial_batch_runner``: each member
  decomposed over a (gridx, gridy) submesh of slots by the sharded
  golden loop with per-member coefficients (``parallel.sharded``'s
  ``cxy=``; the JAX package runs jnp there too), the batch over rows of
  such submeshes.

Both run in a world of processes (``timed_ensemble(owners=...)``, the
slots of ``parallel.multihost.world_slots``): each process advances the
members or blocks of its own slots, a spatial submesh may span ranks
(its strips cross them through ``parallel/halo.py``), and the batch
comes back to every process, bit for bit the one-process run's.
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
from heat2d_tpu_torch.ops.stencil import residual_sq, stencil_step
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


def tuned_config(route, nx: int, ny: int, device, members: int = 1):
    """The tuning db's answer (a ``tune.db.TunedConfig``) for heat5's batch
    ``route`` on ``members`` members of nx x ny: H5's chunk depth K on
    pallas (``tune.runtime.resident_config``) for one member only, H6/H7's
    depth and tile height on band (``band_config``); None on the other
    routes and without an answer. The db's K is H4's, measured on one
    member, and a batch plans its own: on the H100, 8 members of 640x1024
    run 6.5% faster at their planner's K = 4 than at one member's K = 7
    (``chip_smoke.py``'s ``k_sweep_ms``, PERF.md)."""
    from heat2d_tpu_torch.tune import runtime as tune_runtime
    if route == "pallas":
        if members != 1:
            return None
        return tune_runtime.resident_config(nx, ny, device=device)
    if route == "band":
        return tune_runtime.band_config(nx, ny, allow_window=False,
                                        device=device)
    return None


def tuned_for_launch(tuned, members: int):
    """A signature's pre-resolved answer (``tuned_config(...).to_dict()``
    or None) as a launch of ``members`` members a device takes it: None
    for H5's K on more than one (``tuned_config``)."""
    if tuned is not None and tuned["route"] == "resident" and members != 1:
        return None
    return tuned


def tuned_tile(u0) -> dict:
    """H6/H7's ``tsteps``/``ty`` for the batch ``u0``: the tuning db's, or
    the planner's (T = 8, its own height) without an answer."""
    cfg = tuned_config("band", *u0.shape[1:], u0.device)
    if cfg is None:
        return dict(tsteps=DEFAULT_TSTEPS, ty=None)
    return dict(tsteps=cfg.tsteps, ty=cfg.bm)


def _run_batch_pallas(u0, cxs, cys, *, steps):
    cfg = tuned_config("pallas", *u0.shape[1:], u0.device, u0.shape[0])
    with phase("stencil_chunk"):
        return ce.ens_resident(u0, steps, cxs, cys,
                               k=cfg.tsteps if cfg is not None else None)


def _run_batch_band(u0, cxs, cys, *, steps):
    tile = tuned_tile(u0)
    with phase("stencil_chunk"):
        return ce.ens_tiled_chunk(u0, steps, cxs, cys, **tile)


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
        yield
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
        yield
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
    member shape takes this one. T and the tile height are the tuning
    db's answer for the member shape where it has one."""
    tile = tuned_tile(u0)
    t = tile["tsteps"]
    iv = max(1, min(interval, steps)) if steps else interval
    n_chunks = steps // iv if iv else 0
    remainder = steps - n_chunks * iv
    b = u0.shape[0]

    def multi(v, n, act):
        with phase("stencil_chunk"):
            return ce.ens_tiled_chunk(v, n, cxs, cys, act, **tile)

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
                                            resid=True, **tile)
        chunks = torch.where(done, chunks, chunks + 1)
        done = done | (res < sensitivity)
        yield
        if _all_done(i, chunks * iv, res, done, tap):
            break
    k = chunks * iv
    if remainder:
        u = multi(u, remainder, act_of(done))
        k = torch.where(done, k, k + remainder)
    return u, k


def _drive_loop(loop, *args, **kw):
    """Run one convergence loop (a generator, module docstring) to its
    end: its (u, steps_done)."""
    return _drive_all([loop(*args, **kw)])[0]


def _drive_all(loops) -> list:
    """Run several convergence loops to their ends, one chunk of each in
    turn: every loop's chunk is launched before any of them is read."""
    out = [None] * len(loops)
    live = list(range(len(loops)))
    while live:
        for i in list(live):
            try:
                next(loops[i])
            except StopIteration as stop:
                out[i] = stop.value
                live.remove(i)
    return out


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


def _conv_loop(route, problem, steps, interval, sensitivity):
    """The convergence loop (a generator function) of a resolved route,
    ``(u0, cxs, cys, tap=None)``: heat5's loops of jnp and band, else the
    pair-tracked loop over the route's fixed-step runner."""
    kw = dict(steps=steps, interval=interval, sensitivity=sensitivity)
    if problem == vocab.DEFAULT_PROBLEM and route == "jnp":
        return functools.partial(_run_batch_conv_jnp, **kw)
    if problem == vocab.DEFAULT_PROBLEM and route == "band":
        return functools.partial(_run_batch_conv_window, **kw)
    return functools.partial(_run_batch_conv_chunked, **kw,
                             runner=prunners.fixed_runner(problem, route))


def _conv_fn(route, problem, steps, interval, sensitivity):
    """``(u0, cxs, cys, tap=None) -> (u, steps_done)`` for a resolved
    route."""
    return functools.partial(
        _drive_loop, _conv_loop(route, problem, steps, interval,
                                sensitivity))


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


# --------------------------------------------------------------------- #
# Members over several device slots
# --------------------------------------------------------------------- #

def _slots(devices, device) -> list:
    """The slot list: ``devices``, or the visible devices of ``device``
    (the cards by default; raises ``DeviceUnavailableError`` without
    one)."""
    from heat2d_tpu_torch.parallel.mesh import visible_devices
    if devices is None:
        devices = visible_devices(device)
    return [torch.device(d) for d in devices]


def _inert_pad(u0, cxs, cys, pad: int):
    """``pad`` inert members appended (cx = cy = 0, a zero grid): the
    JAX package's padding of the sharded and spatial batches, cropped on
    return."""
    if not pad:
        return u0, cxs, cys
    z = cxs.new_zeros(pad)
    return (torch.cat([u0, u0.new_zeros((pad,) + tuple(u0.shape[1:]))]),
            torch.cat([cxs, z]), torch.cat([cys, z]))


def _split(u0, cxs, cys, devices, owners=None) -> list:
    """The batch in contiguous equal parts, part i on ``devices[i]``:
    ``[(u, cxs, cys), ...]`` (the batch axis sharded in mesh order). With
    ``owners`` (a world's slots, ``multihost.world_slots``), the parts of
    other processes' slots are None and never moved."""
    per = u0.shape[0] // len(devices)
    rank = _rank() if owners is not None else None

    def on(x, i, d):
        return x[i * per:(i + 1) * per].to(d).contiguous()
    return [None if owners is not None and owners[i] != rank
            else (on(u0, i, d), on(cxs, i, d), on(cys, i, d))
            for i, d in enumerate(devices)]


def _rank() -> int:
    from heat2d_tpu_torch.parallel.multihost import process_index
    return process_index()


def _shard_members(u0, cxs, cys, devices, owners=None):
    """(parts, b): the B members padded to a multiple of min(slots, B)
    and split over that many slots (None at other processes' slots)."""
    b = u0.shape[0]
    nd = min(len(devices), b)
    u0, cxs, cys = _inert_pad(u0, cxs, cys, (-b) % nd)
    return _split(u0, cxs, cys, devices[:nd],
                  None if owners is None else owners[:nd]), b


def _gather(parts, dev):
    return torch.cat([p.to(dev) for p in parts])


def _gather_world(parts, owners, like, dev):
    """The slots' parts (each shaped and typed as ``like``, None at other
    processes' slots) in slot order on every process, on ``dev``: the
    tiled all-gather of ``multihost.all_gather_rows`` (a collective:
    every process calls it). A world's slots are process-major."""
    from heat2d_tpu_torch.parallel.multihost import (all_gather_rows,
                                                     process_count)
    owners = list(owners[:len(parts)])
    if owners != sorted(owners):
        raise ValueError(f"slot owners must be process-major, got {owners}")
    mine = [p.detach().cpu() for p in parts if p is not None]
    rows = (torch.cat(mine) if mine
            else like.detach().cpu()[:0])
    k = like.shape[0]
    counts = [owners.count(p) * k for p in range(process_count())]
    return torch.cat(all_gather_rows(rows, counts)).to(dev)


def _sharded_parts(route, steps, u0, cxs, cys, devices, owners=None):
    """(outs, b): every local slot's part launched through ``route``
    before any is read back; None at other processes' slots."""
    parts, b = _shard_members(u0, cxs, cys, devices, owners)
    run = _BATCH_RUNNERS[route]
    return [None if p is None else run(*p, steps=steps) for p in parts], b


def _conv_sharded_parts(route, steps, interval, sensitivity, u0, cxs, cys,
                        devices, owners=None, tap=None):
    """(outs, b): each local slot runs the route's convergence loop on its
    members, the loops driven a chunk at a time in turn (``_drive_all``);
    a slot's loop ends when its own members are done, so the slots of
    different processes need no exchange. ``outs[i]`` is slot i's
    (batch, steps_done), None at other processes' slots. Inert pad
    members reach residual 0 after one chunk, so for any sensitivity > 0
    they converge at once and never hold their slot's loop open."""
    parts, b = _shard_members(u0, cxs, cys, devices, owners)
    loop = _conv_loop(route, vocab.DEFAULT_PROBLEM, steps, interval,
                      sensitivity)
    live = [i for i, p in enumerate(parts) if p is not None]
    done = _drive_all([loop(*parts[i], tap=tap) for i in live])
    outs = [None] * len(parts)
    for i, o in zip(live, done):
        outs[i] = o
    return outs, b


def _run_sharded(route, steps, u0, cxs, cys, devices):
    """The cropped (B, nx, ny) batch on ``u0``'s device."""
    outs, b = _sharded_parts(route, steps, u0, cxs, cys, devices)
    return _gather(outs, u0.device)[:b]


def _run_conv_sharded(route, steps, interval, sensitivity, u0, cxs, cys,
                      devices, tap=None):
    outs, b = _conv_sharded_parts(route, steps, interval, sensitivity, u0,
                                  cxs, cys, devices, tap=tap)
    return (_gather([o[0] for o in outs], u0.device)[:b],
            _gather([o[1] for o in outs], u0.device)[:b])


def run_ensemble_sharded(nx: int, ny: int, steps: int, cxs, cys, u0=None,
                         method: str = "auto", devices=None, device=None):
    """The ensemble with its members over the device slots ``devices``
    (default: the visible devices of ``device``), each slot advancing
    its members through the single-device route. Returns (B, nx, ny) on
    the first slot."""
    devs = _slots(devices, device)
    cxs, cys, u0 = _validated_batch(nx, ny, cxs, cys, u0, devs[0])
    route = _pick_method(method, nx, ny, devs[0])
    return _run_sharded(route, steps, u0, cxs, cys, devs)


def run_ensemble_convergence_sharded(nx: int, ny: int, steps: int,
                                     interval: int, sensitivity: float,
                                     cxs, cys, u0=None,
                                     method: str = "auto", devices=None,
                                     device=None):
    """The convergence ensemble over the device slots. Returns (batch,
    steps_done), both cropped to B, on the first slot."""
    devs = _slots(devices, device)
    cxs, cys, u0 = _validated_batch(nx, ny, cxs, cys, u0, devs[0])
    route = _pick_method(method, nx, ny, devs[0])
    return _run_conv_sharded(route, steps, interval, sensitivity, u0, cxs,
                             cys, devs)


# --------------------------------------------------------------------- #
# Batch x spatial: each member decomposed over a submesh
# --------------------------------------------------------------------- #

def spatial_halo_plan(nx, ny, gridx, gridy, halo="collective",
                      halo_depth=None, device=None) -> dict:
    """The halo route (route, tier, depth, shard, mesh) a (gridx, gridy)
    decomposition of an nx x ny member takes, decided from the geometry
    alone (and a tuned fused depth for ``device``'s kind, where a tuning
    db is active), before anything runs (the serving engines'
    per-signature pre-resolve). A shape the decomposition cannot take
    returns a collective plan of tier ``unplannable`` carrying the
    error, and never raises."""
    from heat2d_tpu_torch.config import ConfigError, HeatConfig
    from heat2d_tpu_torch.parallel import sharded as sh
    try:
        cfg = HeatConfig(nxprob=nx, nyprob=ny, mode="dist2d", gridx=gridx,
                         gridy=gridy, halo=halo, halo_depth=halo_depth)
    except ConfigError as e:
        return dict(requested=halo, route="collective",
                    tier="unplannable", depth=0, shard=None,
                    mesh=(gridx, gridy), error=str(e))
    return sh.resolve_halo_route(cfg, (gridx, gridy), device=device)


class _Spatial:
    """A batch x spatial program: rows of (gridx, gridy) submeshes over
    the slots (row r on slots [r g, (r + 1) g), g = gridx * gridy, in
    row-major order), each row advancing its members, decomposed over
    its submesh, by the sharded golden loop with per-member
    coefficients. ``nb`` is the number of rows, the members one wave
    advances.

    ``owners``: the process of each slot, in a multi-process world
    (``multihost.world_slots``). A process then advances the blocks of
    its own slots only; a row whose submesh spans processes exchanges
    its strips across them (``parallel/halo.py``), and its convergence
    residual is every shard's partial gathered and summed in shard order
    (as ``parallel.sharded._total`` sums a world's). Each chunk, every
    row's done flags go to every process by one integer all-reduce, so
    every process takes the same decisions; the result is gathered to
    every process, row by row."""

    def __init__(self, nx, ny, steps, gridx, gridy, devices, convergence,
                 interval, sensitivity, halo_depth, halo, owners=None):
        from heat2d_tpu_torch.config import HeatConfig
        from heat2d_tpu_torch.parallel import sharded as sh
        from heat2d_tpu_torch.parallel.mesh import make_mesh
        spatial = gridx * gridy
        nb = len(devices) // spatial
        if nb < 1:
            raise ValueError(
                f"batch x spatial ensemble needs at least gridx*gridy = "
                f"{spatial} devices; have {len(devices)}")
        self.owners = owners
        self.meshes = [make_mesh(
            gridx, gridy, devices[r * spatial:(r + 1) * spatial],
            None if owners is None
            else owners[r * spatial:(r + 1) * spatial])
            for r in range(nb)]
        self.cfg = HeatConfig(
            nxprob=nx, nyprob=ny, steps=steps, mode="dist2d", gridx=gridx,
            gridy=gridy, convergence=convergence, interval=interval,
            sensitivity=sensitivity, halo_depth=halo_depth, halo=halo)
        self.pnx, self.pny = sh.padded_global_shape(self.cfg,
                                                    self.meshes[0])
        self.nb, self.spatial = nb, spatial
        self.halo = sh.resolve_halo_route(self.cfg, self.meshes[0])

    def _place(self, u, mesh):
        """A (B, pnx, pny) batch as the ``ShardedGrid`` of ``mesh`` (None
        at other processes' slots)."""
        from heat2d_tpu_torch.parallel.sharded import ShardedGrid
        gx, gy = mesh.shape
        bm, bn = self.pnx // gx, self.pny // gy
        blocks = [[u[:, i * bm:(i + 1) * bm, j * bn:(j + 1) * bn]
                   .to(mesh.devices[i][j]).contiguous()
                   if mesh.is_local(i, j) else None
                   for j in range(gy)] for i in range(gx)]
        return ShardedGrid(blocks, self.cfg.nxprob, self.cfg.nyprob, mesh)

    def __call__(self, u0, cxs, cys, nb=None):
        """(batch, steps_done) of a (B, nx, ny) batch on ``nb`` rows
        (default: all of them, at most B)."""
        from heat2d_tpu_torch.parallel import sharded as sh
        cfg = self.cfg
        b, nx, ny = u0.shape
        nb = min(nb or self.nb, b)
        u0, cxs, cys = _inert_pad(u0, cxs, cys, (-b) % nb)
        if (self.pnx, self.pny) != (nx, ny):     # equal-shard padding
            u0 = torch.nn.functional.pad(
                u0, (0, self.pny - ny, 0, self.pnx - nx))
        per = u0.shape[0] // nb
        rows = []
        for r, mesh in enumerate(self.meshes[:nb]):
            local = mesh.local_devices()
            dev = local[0] if local else u0.device
            sl = slice(r * per, (r + 1) * per)
            cxy = (cxs[sl].to(dev).reshape(-1, 1, 1),
                   cys[sl].to(dev).reshape(-1, 1, 1))
            rows.append(dict(
                mesh=mesh, dev=dev, mine=bool(local),
                spans=_spans(mesh), leader=mesh.owner(0, 0) == _rank(),
                grid=self._place(u0[sl], mesh),
                multi=sh.make_local_multi(cfg, mesh, cxy=cxy),
                step=sh.make_local_step(cfg, mesh, cxy=cxy)))
        if cfg.convergence:
            k = self._converge(rows, per)
        else:
            for row in rows:
                if row["mine"]:
                    row["grid"] = row["multi"](row["grid"], cfg.steps)
            k = torch.full((per * nb,), cfg.steps, dtype=torch.int32)
        out = torch.cat([self._assemble(row, per).to(u0.device)
                         for row in rows])
        return out[:b, :nx, :ny], k.to(u0.device)[:b]

    def _assemble(self, row, per):
        """A row's (per, pnx, pny) batch: its blocks concatenated, each
        process's gathered to every process in a world (a collective)."""
        grid = row["grid"]
        if self.owners is None:
            return _assemble(grid)
        from heat2d_tpu_torch.parallel.multihost import gather_slots
        mesh = row["mesh"]
        gx, gy = mesh.shape
        like = torch.zeros((per, self.pnx // gx, self.pny // gy))
        flat = gather_slots(mesh, grid.tensors(), like)
        return _assemble(grid.with_blocks(
            [flat[i * gy:(i + 1) * gy] for i in range(gx)]))

    def _residuals(self, row, new, prev, per, accum):
        """Each member's residual of the step pair (prev, new) on ``row``:
        per shard the members' partials, summed over the shards in shard
        order (the order ``parallel.sharded._total`` sums in)."""
        parts = [torch.stack([residual_sq(a[m], p[m], accum)
                              for m in range(per)])
                 for a, p in zip(new.tensors(), prev.tensors())]
        if row["spans"]:
            from heat2d_tpu_torch.parallel.multihost import gather_slots
            parts = gather_slots(row["mesh"], parts,
                                 torch.zeros(per, dtype=accum))
        if not parts:
            return None
        dev = row["dev"]
        total = parts[0].to(dev)
        for p in parts[1:]:
            total = total + p.to(dev)
        return total

    def _converge(self, rows, per):
        """Masked completion: every chunk runs on all members, a member
        that converged keeps its plane by select, and the loop ends once
        every member of every row is done (the JAX package's uniform trip
        count; one host read per chunk). Returns steps_done."""
        cfg = self.cfg
        steps, interval = cfg.steps, cfg.interval
        iv = max(1, min(interval, steps)) if steps else interval
        n_chunks = steps // iv if iv else 0
        remainder = steps - n_chunks * iv
        accum = getattr(torch, cfg.accum_dtype)
        for row in rows:
            row["chunks"] = torch.zeros(per, dtype=torch.int32,
                                        device=row["dev"])
            row["done"] = torch.zeros(per, dtype=torch.bool,
                                      device=row["dev"])
        for _ in range(n_chunks):
            flags = []
            for row in rows:
                grid, done = row["grid"], row["done"]
                new = prev = None
                if row["mine"]:
                    prev = row["multi"](grid, iv - 1) if iv > 1 else grid
                    new = row["step"](prev)
                res = None
                if row["mine"] or row["spans"]:
                    with phase("residual_reduction"):
                        res = self._residuals(
                            row, grid if new is None else new,
                            grid if prev is None else prev, per, accum)
                if row["mine"]:
                    row["grid"] = _select(done, grid, new)
                row["chunks"] = torch.where(done, row["chunks"],
                                            row["chunks"] + 1)
                flags.append(done | (res < cfg.sensitivity)
                             if res is not None else done)
            self._agree(rows, flags)
            if all(bool(row["done"].all()) for row in rows):
                break
        ks = []
        for row in rows:
            k = row["chunks"] * iv
            if remainder:
                if row["mine"]:
                    adv = row["multi"](row["grid"], remainder)
                    row["grid"] = _select(row["done"], row["grid"], adv)
                k = torch.where(row["done"], k, k + remainder)
            ks.append(k.to(torch.int32))
        return _gather(ks, ks[0].device)

    def _agree(self, rows, flags) -> None:
        """Set every row's done flags to ``flags``; in a world, each row's
        flags as its leader (the owner of its first slot) computed them,
        by one integer all-reduce (a collective)."""
        if self.owners is None:
            for row, f in zip(rows, flags):
                row["done"] = f
            return
        import torch.distributed as dist
        mine = torch.cat([
            (f.cpu() if row["leader"] else torch.zeros_like(f.cpu()))
            .to(torch.int32) for row, f in zip(rows, flags)])
        dist.all_reduce(mine)
        for r, row in enumerate(rows):
            seg = mine[r * len(flags[r]):(r + 1) * len(flags[r])]
            row["done"] = (seg != 0).to(row["dev"])


def _spans(mesh) -> bool:
    """The mesh's slots belong to more than one process (the same answer
    on every process, unlike ``Mesh.spans_processes``)."""
    return mesh.owners is not None and len(
        {o for row in mesh.owners for o in row}) > 1


def _select(done, old, new):
    """Per member: ``old`` where ``done``, else ``new`` (grids of
    (B, bm, bn) blocks; None at other processes' slots)."""
    masks = {}

    def pick(a, b):
        if a is None:
            return None
        if a.device not in masks:
            masks[a.device] = done.to(a.device).reshape(-1, 1, 1)
        return torch.where(masks[a.device], a, b)
    return old.with_blocks([[pick(a, b) for a, b in zip(ra, rb)]
                            for ra, rb in zip(old.blocks, new.blocks)])


def _assemble(grid):
    """A grid of (B, bm, bn) blocks as one (B, pnx, pny) tensor on its
    first shard's device."""
    dev = grid.blocks[0][0].device
    return torch.cat([torch.cat([b.to(dev) for b in row], dim=-1)
                      for row in grid.blocks], dim=-2)


@functools.lru_cache(maxsize=64)
def spatial_batch_runner(nx: int, ny: int, steps: int, gridx: int,
                         gridy: int, convergence: bool = False,
                         interval: int = 20, sensitivity: float = 0.1,
                         halo: str = "fused", halo_depth=None,
                         n_devices=None, devices=None):
    """The per-signature batch x spatial runner, memoized (the serving
    twin of ``batch_runner`` for members decomposed over a (gridx, gridy)
    submesh): ``run(u0, cxs, cys) -> (u, steps_done)`` pads the batch to
    a multiple of ``run.nb`` (rows of submeshes over the first
    ``n_devices`` of ``devices``, a tuple, default the visible cards)
    with inert members and crops on return. ``run.meta`` is the program
    (its ``halo`` plan, ``nb``, the padded shape)."""
    devs = _slots(devices, None)
    if n_devices:
        devs = devs[:n_devices]
    prog = _Spatial(nx, ny, steps, gridx, gridy, devs, convergence,
                    interval, sensitivity, halo_depth, halo)

    def run(u0, cxs, cys):
        return prog(u0, cxs, cys)

    run.nb = prog.nb
    run.meta = prog
    return run


def run_ensemble_spatial(nx: int, ny: int, steps: int, cxs, cys,
                         gridx: int, gridy: int, u0=None, devices=None,
                         convergence: bool = False, interval: int = 20,
                         sensitivity: float = 0.1, halo_depth=None,
                         halo: str = "collective", device=None):
    """Batch x spatial ensemble: (batch, steps_done), each member advanced
    on its own (gridx, gridy) submesh of the slots ``devices`` (default:
    the visible devices of ``device``); per member bit for bit a dist2d
    run of the same (cx, cy), ``halo="fused"`` included."""
    devs = _slots(devices, device)
    cxs, cys, u0 = _validated_batch(nx, ny, cxs, cys, u0, devs[0])
    prog = _Spatial(nx, ny, steps, gridx, gridy, devs, convergence,
                    interval, sensitivity, halo_depth, halo)
    return prog(u0, cxs, cys)


class EnsembleResult(NamedTuple):
    batch: torch.Tensor
    steps_done: Optional[torch.Tensor]   # None on fixed-step runs
    elapsed: float                       # seconds, reference protocol
    method: str                          # the route that ran
    residual_reads: int                  # host reads of the timed run
    warmup_s: Optional[float]
    #: every process's elapsed seconds in a multi-process world
    elapsed_by_process: Optional[list] = None


def timed_ensemble(nx: int, ny: int, steps: int, cxs, cys, u0=None,
                   method: str = "auto", convergence: bool = False,
                   interval: int = 20, sensitivity: float = 0.1,
                   problem: str = "heat5", device=None,
                   sharded: bool = False, devices=None,
                   spatial_grid=None, halo_depth=None,
                   halo: str = "collective", tap=None,
                   owners=None) -> EnsembleResult:
    """One ensemble launch under the reference timing protocol (an
    untimed warmup run, then a fenced timed run): the CLI's entry.
    ``sharded=True`` spreads the members over the slots ``devices``
    (default: the visible devices of ``device``); ``spatial_grid=(gridx,
    gridy)`` decomposes each member over a submesh of them (route
    ``spatial``), whatever ``sharded`` says. ``tap``: receives every
    chunk's read of a convergence run, ``tap(chunk, steps_done,
    residuals, done)`` (``obs.stream.TelemetryStream.tap_members``): on
    one device the whole batch's; the sharded loops report each slot's
    members, and the spatial route none.

    ``owners``: the process of each of ``devices`` in a multi-process
    world (``multihost.world_slots``; every process calls this alike).
    Each process then runs the members of its own slots; the sharded
    route's slots are gathered to every process after the timed run,
    the spatial route's rows inside it (their strips and residuals cross
    processes). The batch and steps_done come back on every process on
    the CPU, and ``elapsed`` is the slowest process's."""
    from heat2d_tpu_torch.config import ConfigError
    if problem != vocab.DEFAULT_PROBLEM and (sharded
                                             or spatial_grid is not None):
        raise ConfigError(
            f"problem {problem!r} runs the single-chip batch path "
            f"only (the sharded/spatial meshes are built for the "
            f"heat5 operator); drop sharded/spatial_grid")
    multi = sharded or spatial_grid is not None
    devs = _slots(devices, device) if multi else None
    world = multi and owners is not None and len(set(owners)) > 1
    if not world:
        owners = None
    home = (devs[list(owners).index(_rank())] if world
            else devs[0] if multi else device)
    cxs, cys, u0 = _validated_batch(nx, ny, cxs, cys, u0, home)
    gather = None
    if spatial_grid is not None:
        prog = _Spatial(nx, ny, steps, *spatial_grid, devs, convergence,
                        interval, sensitivity, halo_depth, halo, owners)
        method = "spatial"

        def run(u):
            out, k = prog(u, cxs, cys)
            return out, (k if convergence else None)
    elif sharded:
        method = _pick_method(method, nx, ny, devs[0])

        def run(u):
            if world:
                if convergence:
                    return _conv_sharded_parts(
                        method, steps, interval, sensitivity, u, cxs, cys,
                        devs, owners, tap=runner.tap)
                return _sharded_parts(method, steps, u, cxs, cys, devs,
                                      owners)
            if convergence:
                return _run_conv_sharded(method, steps, interval,
                                         sensitivity, u, cxs, cys, devs,
                                         tap=runner.tap)
            return _run_sharded(method, steps, u, cxs, cys, devs), None

        if world:
            def gather(out):
                outs, b = out
                per = -(-b // len(outs))
                z = torch.zeros((per, nx, ny))
                if convergence:
                    u = _gather_world([o and o[0] for o in outs], owners,
                                      z, "cpu")[:b]
                    k = _gather_world(
                        [o and o[1] for o in outs], owners,
                        torch.zeros(per, dtype=torch.int32), "cpu")[:b]
                    return u, k
                return _gather_world(outs, owners, z, "cpu")[:b], None
    else:
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
    runner.stream = tap
    tc = timed_call(runner, u0)
    out, elapsed = tc
    u, k = gather(out) if gather is not None else out
    if world:
        u, k = u.cpu(), (None if k is None else k.cpu())
    return EnsembleResult(u, k, elapsed, method, runner.residual_reads,
                          tc.warmup_s, tc.elapsed_by_process)


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
