"""The hand-written CUDA stencil kernels, their plain PyTorch versions,
the tile planner, and the single-device kernel route
(``make_single_chip_runner``): the port of ``heat2d_tpu/ops/
pallas_stencil.py`` for mode ``pallas``.

Four kernels (sources in ``csrc/stencil.cu``):

====  ==================  ==================================================
H1    ``step``            one clamped step, src -> dst; replaces kernel B
                          (``pallas_stencil.py:_band_kernel`` via
                          ``band_step``)
H2    ``tile_multi``      ``nsub <= T`` steps per round trip to device
                          memory on shared-memory tiles with a T-deep halo
                          ring, by the strip sweep of ``csrc/tile.cuh``
                          (``tile_plan``); replaces kernels C, C2 and C3
                          (``_band_multi_kernel``, ``_band_window_kernel``)
H3    ``tile_multi_resid``  H2 plus one partial sum of squared deltas of
                          the last step pair per tile; replaces C2R/C3R
                          (``_band_window_resid_kernel``)
H4    ``resident``        every step in one cooperative launch, the grid
                          held in shared memory throughout: the on-chip
                          resident sweep of ``csrc/resident.cuh`` on one
                          member (``resident_plan``); replaces kernel A
                          (``_vmem_kernel`` via ``multi_step_vmem``)
====  ==================  ==================================================

H2, H3 and H4 give every cell the same rounded sequence of updates, so
they agree bit for bit with each other whatever their tiles, and in the
literal form with the plain step.

Every wrapper takes a float32 grid. On a CPU tensor it runs the kernel's
plain PyTorch version (same step form, same mask); on a CUDA tensor it
launches the kernel, or raises. It never falls back. Each launch counts
under the wrapper's name in ``_build.launch_counts``; the plain versions
count nothing.

The TPU kernels' row-band and VMEM geometry (``plan_bands``, the probed
window tables, the column panels) has no counterpart here: those were
ways around the TPU's VMEM, and the tiles are planned from the card's
shared-memory limit instead (``_build.device_caps``; ``plan_tiles``,
``tile_plan``, ``resident_plan``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from heat2d_tpu_torch.models import engine
from heat2d_tpu_torch.ops._build import (BLOCK_RESERVED_SMEM, SM_SMEM_BYTES,
                                         call, device_caps, round_up)
from heat2d_tpu_torch.ops.resident import (launch_scratch, plan_resident,
                                            raise_if_gave_up)
from heat2d_tpu_torch.ops.stencil import residual_sq
from heat2d_tpu_torch.utils.device import resolve_device
from heat2d_tpu_torch.utils.profiling import phase

FORM_FMA = 0
FORM_LITERAL = 1

#: Default temporal depth of the tile sweeps (the JAX package's
#: ``DEFAULT_TSTEPS``): device-memory bytes per step fall ~T-fold. H2's
#: results do not depend on it (every cell takes the same sequence at any
#: depth); on the H100 T = 8 timed fastest per 8 steps (PERF.md).
DEFAULT_TSTEPS = 8
#: Cells a strip of H2/H3's strip sweep (``TILE_STRIP`` of
#: csrc/stencil.cu): 8, a heat5 build that reloads fewer column values
#: per update (on the H100 16% faster than the 4 of the other strip
#: sweeps, PERF.md).
TILE_STRIP = 8

#: Thread block of the tile and step kernels (csrc/stencil.cu).
BLOCK = (32, 8)

#: Warps of a strip-sweep block (``STRIP_BY`` of csrc/tile.cuh; H2/H3,
#: H6/H7, H9 and H12-H14): 32 x STRIP_WARPS threads, each updating strips
#: of 4 or 8 cells of one column.
STRIP_WARPS = 16


def _k0(cx, cy):
    """The FMA form's centre weight: for Python floats computed in double
    as the JAX kernel computes it, then used in f32."""
    return 1.0 - 2.0 * cx - 2.0 * cy


def _validate(u, what: str) -> None:
    if u.dim() != 2 or u.dtype != torch.float32:
        raise ValueError(f"{what}: expected a 2D float32 grid, got "
                         f"{tuple(u.shape)} {u.dtype}")
    if min(u.shape) < 1:
        raise ValueError(f"{what}: empty grid {tuple(u.shape)}")
    if u.device.type == "cuda":
        if not u.is_contiguous():
            raise ValueError(f"{what}: the CUDA kernels take a contiguous "
                             f"grid")
        if u.numel() >= 2 ** 31:
            raise ValueError(f"{what}: grid of {u.numel()} cells exceeds "
                             f"the kernels' 32-bit row index range")
    elif u.device.type != "cpu":
        raise ValueError(f"{what}: unsupported device {u.device}")


# --------------------------------------------------------------------- #
# The resident route's gate
# --------------------------------------------------------------------- #

def resident_plan(nx: int, ny: int, device, k=None):
    """H4's plan (``ops/resident.plan_resident`` for one member of radius
    1; its chunk depth K is ``k`` when given, a tuned depth, else the
    planner's, which timed fastest on the H100), or None when the grid
    is too large to stay in the card's shared memory at that K."""
    return plan_resident(1, nx, ny, 1, device, k=k)


def fits_resident(shape, device) -> bool:
    """Gate of the resident route (H4): the card launches cooperative
    grids and ``resident_plan`` has a plan for the grid (on the H100 up
    to about 3.7 M cells; up to its edge H4 timed faster than the H2
    route, ``chip_smoke.py``'s ``gate_sweep``). Grids on the CPU are gated
    against the H100's 132 SMs and 232,448 bytes a block, so that they
    take the route the card would. A grid that fails it takes the
    streamed route. The ensembles' and families' ``auto`` routes share
    it."""
    if not device_caps(device).cooperative:
        return False
    return resident_plan(shape[0], shape[1], device) is not None


# --------------------------------------------------------------------- #
# Tile planner
# --------------------------------------------------------------------- #

class TilePlan(NamedTuple):
    ty: int        # centre rows per tile
    tx: int        # centre columns per tile
    tsteps: int    # halo depth T (steps a sweep may advance)
    grid: tuple    # (tile rows, tile columns)

    @property
    def ntiles(self) -> int:
        return self.grid[0] * self.grid[1]

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of one block: two ext tiles."""
        t = self.tsteps
        return 2 * (self.ty + 2 * t) * (self.tx + 2 * t) * 4


def plan_tiles(nx: int, ny: int, tsteps: int, smem: int,
               ty: int | None = None) -> TilePlan:
    """Tile geometry of the H2/H3 sweeps: a centre of at most 64 x 128
    cells (rows of 512 bytes, coalesced; two blocks share an SM at
    T = 8), or at most ``ty`` rows (a tuned height, a multiple of
    ``BLOCK[1]``), shrunk to the grid, then halved until the two ext
    tiles fit in ``smem`` bytes of shared memory."""
    if tsteps < 1:
        raise ValueError(f"tsteps must be >= 1, got {tsteps}")
    if ty is not None and (ty < BLOCK[1] or ty % BLOCK[1]):
        raise ValueError(f"ty must be a positive multiple of {BLOCK[1]}, "
                         f"got {ty}")
    ty = min(64 if ty is None else ty, round_up(nx, BLOCK[1]))
    tx = min(128, round_up(ny, BLOCK[0]))

    def need(a, b):
        return 2 * (a + 2 * tsteps) * (b + 2 * tsteps) * 4

    while need(ty, tx) > smem and (ty > BLOCK[1] or tx > BLOCK[0]):
        if ty >= tx // 2 and ty > BLOCK[1]:
            ty //= 2
        else:
            tx //= 2
    if need(ty, tx) > smem:
        raise ValueError(
            f"halo depth T={tsteps} leaves no tile that fits {smem} bytes "
            f"of shared memory")
    return TilePlan(ty, tx, tsteps, (-(-nx // ty), -(-ny // tx)))


def tile_plan(nx: int, ny: int, tsteps: int, device,
              ty: int | None = None) -> TilePlan:
    """The strip sweep's tiles on an (nx, ny) block with a ``tsteps``-deep
    ring on ``device`` (H2/H3 on a grid, H6/H7 on an ensemble's member,
    H12-H14 on a shard; a block on the CPU plans what the H100 would):
    ``plan_tiles`` (centres of at most 64 x 128, or of at most ``ty``
    rows when given, a tuned height) within the card's opt-in shared
    memory a block and within half an SM's, so that two blocks of
    ``STRIP_WARPS`` warps share an SM, as H9's plans do. Each block also
    takes 1 KB for the system and 4 bytes a warp for the residual's
    partial sums."""
    sums = 4 * STRIP_WARPS
    half = SM_SMEM_BYTES // 2 - BLOCK_RESERVED_SMEM - sums
    return plan_tiles(nx, ny, tsteps,
                      min(device_caps(device).smem_optin - sums, half), ty)


#: H2/H3's paths, in the order of the words of a ``paths`` count
#: (csrc/stencil.cu): ``fast``, tiles whose ext (centre and ring) lies
#: inside the grid, copied by cp.async with no cell held; ``edge``, the
#: rest.
TILE_PATHS = ("fast", "edge")


def tile_paths(plan: TilePlan, nx: int, ny: int) -> dict:
    """The planner's count of the tiles of ``plan`` on an nx x ny grid by
    path (``TILE_PATHS``), by the kernel's uniform test (``ext_inside``
    of csrc/tile.cuh). What the kernel took, it counts itself into
    ``paths``."""
    h = plan.tsteps
    ey, ex = plan.ty + 2 * h, plan.tx + 2 * h
    rows = sum(0 <= a * plan.ty - h and a * plan.ty - h + ey <= nx
               for a in range(plan.grid[0]))
    cols = sum(0 <= b * plan.tx - h and b * plan.tx - h + ex <= ny
               for b in range(plan.grid[1]))
    return {"fast": rows * cols, "edge": plan.ntiles - rows * cols}


def path_counter(device):
    """A zeroed ``paths`` count for ``device``: one int32 word per entry
    of ``TILE_PATHS``, to which each H2/H3 launch given it adds its
    tiles; ``dict(zip(TILE_PATHS, buf.tolist()))`` reads it."""
    return torch.zeros(len(TILE_PATHS), dtype=torch.int32, device=device)


# --------------------------------------------------------------------- #
# Plain PyTorch versions (whole-grid steps, same form and mask)
# --------------------------------------------------------------------- #

def step_plain(u, cx, cy, form: int = FORM_FMA):
    """One clamped step of the whole grid in f32, FMA or literal form:
    the JAX package's ``_step_value`` / ``_step_value_literal``. On a
    (B, nx, ny) batch the coefficients may be (B, 1, 1) float32 tensors,
    one per member; ``_k0`` of those is then f32 arithmetic, as the
    batched TPU kernels compute it from their f32 scalars."""
    c = u[..., 1:-1, 1:-1]
    sx = u[..., 2:, 1:-1] + u[..., :-2, 1:-1]
    sy = u[..., 1:-1, 2:] + u[..., 1:-1, :-2]
    if not isinstance(cx, torch.Tensor):
        cx, cy = float(cx), float(cy)
    if form == FORM_LITERAL:
        new = c + cx * (sx - 2.0 * c) + cy * (sy - 2.0 * c)
    else:
        new = _k0(cx, cy) * c + cx * sx + cy * sy
    out = u.clone()
    out[..., 1:-1, 1:-1] = new
    return out


def multi_step_plain(u, n: int, cx, cy, form: int = FORM_FMA):
    for _ in range(n):
        u = step_plain(u, cx, cy, form)
    return u


def tile_multi_resid_plain(u, nsub: int, cx: float, cy: float,
                           form: int = FORM_FMA):
    """``nsub`` steps, and the residual of the last step pair."""
    prev = multi_step_plain(u, nsub - 1, cx, cy, form)
    last = step_plain(prev, cx, cy, form)
    return last, residual_sq(last, prev)


# --------------------------------------------------------------------- #
# Kernel wrappers
# --------------------------------------------------------------------- #

def step(u, cx: float, cy: float, form: int = FORM_FMA):
    """H1: one clamped step. Device memory bound (a read and a write of
    the grid per step)."""
    _validate(u, "step")
    if u.device.type == "cpu":
        return step_plain(u, cx, cy, form)
    nx, ny = u.shape
    if -(-nx // BLOCK[1]) > 65535:
        raise ValueError(f"step: {nx} rows exceed the launch grid's y limit")
    out = torch.empty_like(u)
    call("stencil", "heat_step", "step", "H1 step", u, out, nx, ny, cx, cy,
         _k0(cx, cy), form)
    return out


def _check_depth(nsub: int, tsteps: int) -> None:
    if not 1 <= nsub <= tsteps:
        raise ValueError(f"nsub must be in [1, T={tsteps}], got {nsub}")


def _check_paths(paths, words: int, device) -> None:
    """A ``paths`` count is None or ``words`` int32 words on ``device``."""
    if paths is not None and (paths.dtype != torch.int32
                              or paths.shape != (words,)
                              or paths.device != device):
        raise ValueError(f"paths: an int32 tensor of {words} words on "
                         f"{device} (path_counter)")


def _tile_launch(u, nsub, cx, cy, form, tsteps, resid, paths=None,
                 ty=None):
    """One H2 (H3 with ``resid``) launch of ``tile_plan``'s tiles."""
    name = "tile_multi_resid" if resid else "tile_multi"
    nx, ny = u.shape
    plan = tile_plan(nx, ny, tsteps, u.device, ty)
    if plan.grid[0] > 65535:
        raise ValueError(f"{nx} rows exceed the launch grid's y limit")
    _check_paths(paths, len(TILE_PATHS), u.device)
    out = torch.empty_like(u)
    parts = (torch.empty(plan.ntiles, dtype=torch.float32, device=u.device)
             if resid else None)
    call("stencil", "heat_tile_multi", name,
         "H3 tile_multi_resid" if resid else "H2 tile_multi", u, out, parts,
         paths, nx, ny, cx, cy, _k0(cx, cy), form, plan.tsteps, nsub,
         plan.ty, plan.tx)
    return out, parts


def tile_multi(u, nsub: int, cx: float, cy: float, form: int = FORM_FMA,
               tsteps: int = DEFAULT_TSTEPS, paths=None, ty=None):
    """H2: ``nsub <= tsteps`` steps in one strip sweep of shared-memory
    tiles (of at most ``ty`` centre rows when given). Device memory
    traffic is one read and one write of the grid per sweep (plus the
    halo rings); the step loop's instructions bound it. ``paths``
    (``path_counter``): the kernel adds its tiles by path to it; the
    plain version, on the CPU, counts none."""
    _validate(u, "tile_multi")
    _check_depth(nsub, tsteps)
    if u.device.type == "cpu":
        return multi_step_plain(u, nsub, cx, cy, form)
    out, _ = _tile_launch(u, nsub, cx, cy, form, tsteps, False, paths, ty)
    return out


def tile_multi_resid(u, nsub: int, cx: float, cy: float,
                     form: int = FORM_FMA, tsteps: int = DEFAULT_TSTEPS,
                     paths=None, ty=None):
    """H3: H2 plus the residual of the sweep's last step pair, summed on
    the device from one partial per tile. Returns (u, residual).
    ``paths`` and ``ty`` as H2's."""
    _validate(u, "tile_multi_resid")
    _check_depth(nsub, tsteps)
    if u.device.type == "cpu":
        return tile_multi_resid_plain(u, nsub, cx, cy, form)
    out, parts = _tile_launch(u, nsub, cx, cy, form, tsteps, True, paths,
                              ty)
    return out, torch.sum(parts)


#: The builds ``func_attrs`` reads, in ``heat_func_attrs``' order.
FUNC_BUILDS = ("step", "tile_multi", "tile_multi_resid", "resident")


def func_attrs(name: str) -> dict:
    """Registers and local (spill) bytes a thread of wrapper ``name``'s
    FMA-form build on the card (``cudaFuncGetAttributes``)."""
    buf = (ctypes.c_int * 2)()
    call("stencil", "heat_func_attrs", None, f"func_attrs {name}",
         FUNC_BUILDS.index(name), buf)
    return {"registers": buf[0], "local_bytes": buf[1]}


def tile_info(plan: TilePlan) -> dict:
    """H2's FMA build on the card at ``plan``: registers and local (spill)
    bytes a thread, and the blocks an SM holds
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    buf = (ctypes.c_int * 3)()
    call("stencil", "heat_tile_info", None, "H2 tile_info", plan.smem_bytes,
         buf)
    return {"strip": TILE_STRIP, "registers": buf[0], "local_bytes": buf[1],
            "blocks_per_sm": buf[2], "smem_bytes": plan.smem_bytes}


def _resident_launch(u, steps: int, cx, cy, form, plan):
    """One H4 launch of ``plan`` (a one-member ``ops.resident`` plan).
    Raises when the launch is refused (the plan's blocks must all be
    co-resident) or a block gave up waiting for a neighbour's ring."""
    what = (f"H4 resident ({plan.blocks} blocks of {plan.smem_bytes} bytes "
            f"of shared memory)")
    out = torch.empty_like(u)
    scratch = launch_scratch(plan, steps, u.device)
    call("stencil", "heat_resident", "resident", what, u, out, scratch,
         plan.as_ctypes(), cx, cy, _k0(cx, cy), form, steps)
    raise_if_gave_up(scratch, what, plan)
    return out


def resident(u, steps: int, cx: float, cy: float, form: int = FORM_FMA,
             k=None):
    """H4: ``steps`` steps in one cooperative launch, the grid resident in
    shared memory for all of them (``resident_plan``, at chunk depth
    ``k`` when given): a block per SM steps its tile, trading rings with
    its neighbours every K steps. The step loop's instructions and the
    exchanges bound it. A grid without a plan raises: the route gate
    ``fits_resident`` sends it to the streamed route before any
    launch."""
    _validate(u, "resident")
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")
    if u.device.type == "cpu":
        return multi_step_plain(u, steps, cx, cy, form)
    if steps == 0:
        return u
    plan = resident_plan(*u.shape, u.device, k)
    if plan is None:
        raise ValueError(f"resident: a {u.shape[0]}x{u.shape[1]} grid does "
                         f"not fit the card's shared memory (fits_resident "
                         f"routes it to the tile sweeps)")
    return _resident_launch(u, steps, cx, cy, form, plan)


# --------------------------------------------------------------------- #
# The single-device kernel route (mode "pallas")
# --------------------------------------------------------------------- #

def tiled_chunk(u, n: int, cx: float, cy: float, form: int = FORM_FMA,
                tsteps: int = DEFAULT_TSTEPS, ty=None):
    """``n`` steps as full T-deep H2 sweeps plus one partial sweep at
    depth ``n % T`` (the JAX package's ``_window_multi_padded``), on
    tiles of at most ``ty`` centre rows when given."""
    nsweeps, rem = divmod(n, tsteps)
    for _ in range(nsweeps):
        u = tile_multi(u, tsteps, cx, cy, form, tsteps, ty=ty)
    if rem:
        u = tile_multi(u, rem, cx, cy, form, tsteps, ty=ty)
    return u


def make_single_chip_runner(config, device=None,
                            tuned=None) -> engine.Runner:
    """The kernel route of mode ``pallas`` (``pallas_stencil.py:1402``),
    re-derived for the card:

    - resident (``fits_resident``): H4 runs ``chunk(u, n)`` and the
      single ``step``;
    - streamed: ``chunk`` is T-deep H2 sweeps plus a partial sweep, and
      ``step`` is H1;
    - fused convergence on the streamed route with the FMA form: each
      INTERVAL chunk runs ``n - d`` steps through H2, then one H3 sweep
      of depth ``d = n % T or T`` that also yields the residual;
    - the literal form (``bitwise_parity``) and resident grids run
      convergence through ``run_convergence_chunked``.

    The plan's knobs, H4's chunk depth K or H2/H3's depth T and tile
    height, are the planner's, or the tuning db's answer for the grid
    (``tune.runtime.resident_config``/``band_config``: None, so the
    planner's, without a db), or those of ``tuned``, a
    ``tune.db.TunedConfig`` whose route ("resident" or "tile") the
    runner then takes whatever the gate says (how the search measures a
    candidate). ``runner.plan`` is the plan its chunks launch,
    ``runner.chunk(u, n)`` advances n steps, and
    ``runner.chunk_resid(u, n)`` is the streamed route's fused
    convergence chunk (H2 sweeps, then one H3 sweep), which also returns
    the residual of its last step pair (None on the resident route). A
    plan change moves no bit: every cell takes the same
    sequence of updates under any plan.

    ``device`` defaults to ``cuda`` and raises without a card; pass
    ``"cpu"`` to run the plain versions."""
    dev = resolve_device(device)
    cx, cy = config.cx, config.cy
    nx, ny = config.nxprob, config.nyprob
    form = FORM_LITERAL if config.bitwise_parity else FORM_FMA
    if tuned is None:
        from heat2d_tpu_torch.tune import runtime as tune_runtime
        is_resident = fits_resident((nx, ny), dev)
        tuned = (tune_runtime.resident_config(nx, ny, device=dev)
                 if is_resident
                 else tune_runtime.band_config(nx, ny, device=dev))
    else:
        is_resident = tuned.route == "resident"
    if is_resident:
        k = tuned.tsteps if tuned is not None else None
        plan = resident_plan(nx, ny, dev, k)
        if plan is None:
            raise ValueError(f"resident: no plan keeps a {nx}x{ny} grid in "
                             f"the card's shared memory at K={k}")
    else:
        tw = tuned.tsteps if tuned is not None else DEFAULT_TSTEPS
        ty = tuned.bm if tuned is not None else None
        plan = tile_plan(nx, ny, tw, dev, ty)

    if is_resident:
        def step_fn(u):
            return resident(u, 1, cx, cy, form, k)

        def chunk(u, n):
            with phase("stencil_chunk"):
                return resident(u, n, cx, cy, form, k)
    else:
        def step_fn(u):
            return step(u, cx, cy, form)

        def chunk(u, n):
            with phase("stencil_chunk"):
                return tiled_chunk(u, n, cx, cy, form, tw, ty)

    fused = (config.convergence and not is_resident
             and form == FORM_FMA)

    def chunk_resid(u, n):
        d = n % tw or tw
        u = tiled_chunk(u, n - d, cx, cy, form, tw, ty)
        with phase("residual_reduction"):
            return tile_multi_resid(u, d, cx, cy, form, tw, ty=ty)

    def residual(a, b):
        with phase("residual_reduction"):
            return residual_sq(a, b)

    def run(u):
        if config.convergence:
            if fused:
                return engine.run_convergence_fused(
                    chunk_resid, chunk, u, config.steps, config.interval,
                    config.sensitivity, tap=runner.tap)
            return engine.run_convergence_chunked(
                chunk, step_fn, residual, u, config.steps, config.interval,
                config.sensitivity, tap=runner.tap)
        return chunk(u, config.steps), config.steps

    route = ("resident" if is_resident
             else "streamed-fused" if fused else "streamed")
    runner = engine.Runner(run, route)
    runner.plan = plan
    runner.chunk = chunk
    runner.chunk_resid = None if is_resident else chunk_resid
    return runner
