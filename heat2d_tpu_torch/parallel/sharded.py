"""The sharded solver path: the port of ``heat2d_tpu/parallel/sharded.py``.

- dist1d: the row strips of ``mpi_heat2Dn.c`` as a (numworkers, 1) mesh,
  padded to equal shards;
- dist2d: the 2D blocks of ``grad1612_mpi_heat.c`` as a (gridx, gridy)
  mesh with the two-phase wide-halo exchange;
- hybrid: the mesh times a per-shard kernel (``grad1612_hybrid_heat.c``):
  H12 after each exchange, H13 for the convergence residual, H14 when
  the exchange moves into the kernel (``--halo fused``).

The JAX package runs all of it in one ``shard_map`` program. Here every
shard is a tensor on its mesh device, held by a ``ShardedGrid``, and the
time loop is the engine's Python loop: each chunk of T steps exchanges
T-deep strips once (``parallel/halo.py``) and advances every shard T
steps. dist1d/dist2d advance with the golden loop (plain PyTorch, the
literal step in ``accum_dtype``, as the JAX package's jnp path); hybrid
with the kernels. The convergence residual is the sum of the shards'
partials, read to the host once per INTERVAL chunk.

A mesh may span processes (``parallel/multihost.py``): each process then
holds and advances its own shards only, the exchange carries strips
between ranks, and the residual is every shard's partial gathered to
every rank and summed there in shard order, so each rank takes the
one-process run's decision on the one-process run's bits.
"""

from __future__ import annotations

import dataclasses

import torch

from heat2d_tpu_torch.models import engine
from heat2d_tpu_torch.ops import cuda_shard as csh
from heat2d_tpu_torch.ops.init import inidat_block
from heat2d_tpu_torch.ops.stencil import residual_sq
from heat2d_tpu_torch.parallel.halo import (exchange_halo_2d_wide,
                                            exchange_halo_strips,
                                            fused_halo_viable)
from heat2d_tpu_torch.parallel.mesh import Mesh
from heat2d_tpu_torch.utils.profiling import phase

#: Default wide-halo depth (config.halo_depth=None): 8 steps per exchange,
#: clamped to the shard size.
DEFAULT_HALO_DEPTH = 8

#: The declared communication contract of every sharded halo route, the
#: port's copy of the JAX package's (``parallel/sharded.py:53-66``), which
#: the IR verifier's collective pass (``analysis/ir.py``) holds each
#: recorded program to (``analysis/dtype_flow.record_collectives``). An
#: exchange (``halo.exchange_halo_strips``) is 4 strip shifts, two phases
#: (N/S, then E/W from the vertically-extended edge columns), each moving
#: a strip between nearest neighbours, never wrapping; the residual sum
#: (``_total``, the MPI_Allreduce) appears only in convergence programs;
#: the gather family is forbidden: it turns O(halo) bytes into O(grid)
#: bytes a step. The calls a shimmed scope may make inside it are listed
#: under ``nested``: the exchange's sends and receives between ranks, the
#: residual's shard-order gather of per-shard partials between ranks, and
#: H14's plain version, whose exchange on the CPU stands for the kernel's
#: reads of its neighbours' blocks. Tier ``ici`` (H14) exchanges no strip
#: outside the kernel.
COLLECTIVE_CONTRACT = {
    "allowed": ("exchange", "strip_shift", "allreduce", "shard_fused",
                "barrier"),
    "forbidden": ("all_gather", "all_gather_object",
                  "all_gather_into_tensor", "gather", "gather_object",
                  "scatter", "all_to_all", "all_to_all_single",
                  "reduce_scatter", "reduce_scatter_tensor"),
    #: strip shifts per exchange
    "shifts_per_exchange": 4,
    #: |di| + |dj| between the source and destination shard of a shift
    "neighbor_distance": 1,
    "nested": {
        "exchange": ("strip_shift", "batch_isend_irecv"),
        "allreduce": ("all_gather",),
        "shard_fused": ("exchange",),
    },
    "no_exchange_tiers": ("ici",),
}


@dataclasses.dataclass
class ShardedGrid:
    """A (gx, gy) grid of (bm, bn) float32 blocks, ``blocks[i][j]`` on mesh
    device (i, j) and at global (i bm, j bn), of a true nx x ny domain
    (cells past it are the equal-shard padding, held at 0). On a ``mesh``
    that spans processes, the other processes' blocks are None."""
    blocks: list
    nx: int
    ny: int
    mesh: object = None

    @property
    def block_shape(self) -> tuple[int, int]:
        for b in self.tensors():
            return tuple(b.shape)
        gx, gy = len(self.blocks), len(self.blocks[0])
        return -(-self.nx // gx), -(-self.ny // gy)

    @property
    def spans_processes(self) -> bool:
        return self.mesh is not None and self.mesh.spans_processes

    def tensors(self) -> list:
        """This process's blocks, in shard order."""
        return [b for row in self.blocks for b in row if b is not None]

    def with_blocks(self, blocks) -> "ShardedGrid":
        return ShardedGrid(blocks, self.nx, self.ny, self.mesh)


def _grid_of(mesh) -> tuple[int, int]:
    """(gx, gy) of a ``Mesh``, or of a bare (gx, gy) pair (the host-side
    plans, ``models.ensemble.spatial_halo_plan``, name no devices)."""
    return tuple(mesh) if isinstance(mesh, tuple) else mesh.shape


def padded_global_shape(config, mesh: Mesh) -> tuple[int, int]:
    """The global shape padded up so every shard is equal-sized (the
    answer to the reference's averow/extra strips, mpi_heat2Dn.c:89-94):
    the pad cells sit outside the keep mask's interior, stay 0 and add 0
    to the residual."""
    gx, gy = _grid_of(mesh)
    return -(-config.nxprob // gx) * gx, -(-config.nyprob // gy) * gy


def shard_shape(config, mesh: Mesh) -> tuple[int, int]:
    pnx, pny = padded_global_shape(config, mesh)
    gx, gy = _grid_of(mesh)
    return pnx // gx, pny // gy


def effective_halo_depth(config, mesh: Mesh, device=None) -> int:
    """The exchange depth T: ``halo_depth``, else, on the fused route, the
    tuning db's depth for the shard shape (``tune.runtime.fused_config``,
    re-validated against the overlap geometry and H14's tile plan; None
    without a db), else 8; clamped to the shard. The db is read for the
    kind of the mesh's first device, or of ``device`` for a bare (gx, gy)
    pair."""
    bm, bn = shard_shape(config, mesh)
    want = config.halo_depth or DEFAULT_HALO_DEPTH
    if config.halo_depth is None and config.halo == "fused":
        from heat2d_tpu_torch.tune import runtime as tune_runtime
        if tune_runtime.active_db() is not None:
            dev = mesh.flat()[0] if isinstance(mesh, Mesh) else device
            tuned = tune_runtime.fused_config(bm, bn, device=dev)
            if tuned is not None:
                want = tuned.tsteps
    return max(1, min(want, bm, bn))


def _form(config) -> int:
    return csh.FORM_LITERAL if config.bitwise_parity else csh.FORM_FMA


def _fused_kernel_viable(config, mesh: Mesh, t: int) -> bool:
    """H14 serves a chunk of depth t: a mesh of more than one shard, the
    overlap geometry (its plain version's frames), at most the kernel's
    table of shards, every card able to read the others, and every shard
    in this process (H14 reads its neighbours' blocks by pointer, which
    another process's memory does not offer)."""
    bm, bn = shard_shape(config, mesh)
    gx, gy = mesh.shape
    devs = mesh.flat()
    return (gx * gy > 1 and gx * gy <= csh.MAX_SHARDS
            and not mesh.spans_processes
            and fused_halo_viable(bm, bn, t)
            and (devs[0].type == "cpu" or csh.fused_peer_ok(devs)))


def resolve_halo_route(config, mesh: Mesh, kernel: bool = False,
                       device=None) -> dict:
    """The halo route a runner takes at the full chunk depth, under the
    JAX package's tier names (``parallel/sharded.py:274``):

    - ``collective``: exchange, then compute (also what a fused request
      degrades to where its route is not viable);
    - ``overlap``: fused through the inner/boundary split on the golden
      path (dist1d/dist2d);
    - ``ici``: fused with the exchange inside the kernel: on the card,
      H14 reading the neighbours' blocks (hybrid);
    - ``window``: the JAX package's D2 route on TPU shards; H12 covers
      its work here, so the port never takes it.

    ``mesh`` may be a bare (gx, gy) pair when ``kernel`` is False, on
    ``device`` (whose kind a tuned depth is read for).
    """
    gx, gy = _grid_of(mesh)
    bm, bn = shard_shape(config, mesh)
    t = effective_halo_depth(config, mesh, device)
    out = dict(requested=config.halo, depth=t, shard=(bm, bn),
               mesh=(gx, gy))
    if config.halo != "fused":
        out.update(route="collective", tier="collective")
    elif kernel:
        if _fused_kernel_viable(config, mesh, t):
            out.update(route="fused", tier="ici")
        else:
            out.update(route="collective", tier="collective")
    elif gx * gy > 1 and fused_halo_viable(bm, bn, t):
        out.update(route="fused", tier="overlap")
    else:
        out.update(route="collective", tier="collective")
    return out


def make_local_chunk(config, mesh: Mesh, kernel: bool = False, cxy=None):
    """``chunk(grid, t)``: one t-deep exchange, then t steps of every
    shard, t in [1, min(bm, bn)]. Without ``kernel`` (dist1d/dist2d) the
    golden loop, or with ``halo='fused'`` its overlap schedule; with
    ``kernel`` (hybrid) H12 after the exchange, or H14 with the exchange
    inside it.

    ``cxy``: optional (cx, cy) overriding the config's diffusivities:
    (B, 1, 1) float32 tensors giving each member of (B, bm, bn) blocks
    its own (the spatial ensembles, ``models.ensemble``). The kernels
    take scalar coefficients, so ``cxy`` with ``kernel`` raises, as in
    the JAX package."""
    nx, ny = config.nxprob, config.nyprob
    gx, gy = mesh.shape
    bm, bn = shard_shape(config, mesh)
    if cxy is not None and kernel:
        raise ValueError("per-member cxy requires the jnp chunk path "
                         "(chunk kernels bake their diffusivities)")
    cx, cy = (config.cx, config.cy) if cxy is None else cxy
    coefs = {}
    accum = getattr(torch, config.accum_dtype)
    fused_req = config.halo == "fused"
    form = _form(config)

    def coef(dev):
        """(cx, cy) on ``dev``: the per-member tensors copied to each
        shard's device once."""
        if cxy is None:
            return cx, cy
        if dev not in coefs:
            coefs[dev] = (cx.to(dev), cy.to(dev))
        return coefs[dev]

    def each(fn, *grids):
        """``fn(x0, y0, *items)`` at every shard of this process, as a new
        grid (None at other processes' shards)."""
        return [[fn(i * bm, j * bn, *(g[i][j] for g in grids))
                 if mesh.is_local(i, j) else None
                 for j in range(gy)] for i in range(gx)]

    def chunk(grid: ShardedGrid, t: int) -> ShardedGrid:
        blocks = grid.blocks
        if kernel:
            if fused_req and _fused_kernel_viable(config, mesh, t):
                with phase("stencil_chunk"):
                    return grid.with_blocks(
                        csh.shard_fused(blocks, t, nx, ny, cx, cy, form))
            with phase("halo_exchange"):
                strips = exchange_halo_strips(blocks, t, mesh)
            with phase("stencil_chunk"):
                return grid.with_blocks(each(
                    lambda x0, y0, u, s: csh.shard_tile_multi(
                        u, s, t, x0, y0, nx, ny, cx, cy, form),
                    blocks, strips))
        if fused_req and gx * gy > 1 and fused_halo_viable(bm, bn, t):
            with phase("halo_overlap"):
                strips = exchange_halo_strips(blocks, t, mesh)
                return grid.with_blocks(each(
                    lambda x0, y0, u, s: csh.chunk_fused_plain(
                        u, s, t, x0, y0, nx, ny, *coef(u.device),
                        accum=accum),
                    blocks, strips))
        with phase("halo_exchange"):
            ext = exchange_halo_2d_wide(blocks, t, mesh)
        with phase("interior_stencil"):
            return grid.with_blocks(each(
                lambda x0, y0, e: csh.advance(
                    e, x0 - t, y0 - t, t, nx, ny, *coef(e.device),
                    accum=accum)[..., t:-t, t:-t],
                ext))

    return chunk


def make_local_step(config, mesh: Mesh, kernel: bool = False, cxy=None):
    """``step(grid)``: one step, the chunk at depth 1 (bitwise the same
    as a step of a deeper chunk)."""
    chunk = make_local_chunk(config, mesh, kernel, cxy)
    return lambda grid: chunk(grid, 1)


def make_local_multi(config, mesh: Mesh, kernel: bool = False, cxy=None):
    """``multi(grid, n)``: n steps as chunks of depth T plus a remainder
    chunk."""
    chunk = make_local_chunk(config, mesh, kernel, cxy)
    t = effective_halo_depth(config, mesh)

    def multi(grid, n):
        full, rem = divmod(n, t)
        for _ in range(full):
            grid = chunk(grid, t)
        if rem:
            grid = chunk(grid, rem)
        return grid

    return multi


def _total(parts, mesh=None, dtype=torch.float32):
    """The sum of the shards' residual partials, on the first shard's
    device (the MPI_Allreduce). On a ``mesh`` spanning processes,
    ``parts`` are this process's partials in shard order: every shard's
    partial is gathered to every rank and summed there in shard order
    (not an ``all_reduce``, whose order is the backend's), so the total
    is the one-process run's, bit for bit, on every rank. ``dtype``: the
    partials' (what a process without shards contributes)."""
    if mesh is not None and mesh.spans_processes:
        from heat2d_tpu_torch.parallel.multihost import gather_slots
        dev = parts[0].device if parts else torch.device("cpu")
        parts = [p.to(dev) for p in gather_slots(
            mesh, parts, torch.zeros((), dtype=dtype))]
    dev = parts[0].device
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(dev)
    return total


def make_sharded_runner(config, mesh: Mesh, kernel: bool = False):
    """``runner(grid) -> (grid, steps_done)`` over the mesh, as an
    ``engine.Runner`` whose ``halo`` is ``resolve_halo_route``'s dict.

    Routes: ``sharded`` (the golden loop, dist1d/dist2d),
    ``sharded-kernel`` (hybrid), ``sharded-kernel-resid`` (hybrid
    convergence in float32 with the FMA form: each INTERVAL chunk ends in
    an H13 sweep of depth ``n % T or T`` whose partials give the
    residual, as the JAX package's D2R path does). Other convergence
    runs track a step pair (``run_convergence_chunked``)."""
    nx, ny = config.nxprob, config.nyprob
    bm, bn = shard_shape(config, mesh)
    gx, gy = mesh.shape
    accum = getattr(torch, config.accum_dtype)
    t = effective_halo_depth(config, mesh)
    chunk = make_local_chunk(config, mesh, kernel)
    multi = make_local_multi(config, mesh, kernel)
    form = _form(config)
    fused = (kernel and config.convergence and config.accum_dtype == "float32"
             and form == csh.FORM_FMA)

    def step(grid):
        return chunk(grid, 1)

    def residual(new, old):
        with phase("residual_reduction"):
            return _total([residual_sq(a, b, accum) for a, b in
                           zip(new.tensors(), old.tensors())], mesh, accum)

    def chunk_resid(grid, n):
        d = n % t or t
        grid = multi(grid, n - d)
        with phase("halo_exchange"):
            strips = exchange_halo_strips(grid.blocks, d, mesh)
        outs, parts = [], []
        for i in range(gx):
            row = []
            for j in range(gy):
                if not mesh.is_local(i, j):
                    row.append(None)
                    continue
                u, p = csh.shard_tile_multi_resid(
                    grid.blocks[i][j], strips[i][j], d, i * bm, j * bn, nx,
                    ny, config.cx, config.cy, form)
                row.append(u)
                parts.append(p)
            outs.append(row)
        with phase("residual_reduction"):
            return grid.with_blocks(outs), _total(parts, mesh)

    def run(grid):
        if config.convergence:
            if fused:
                return engine.run_convergence_fused(
                    chunk_resid, multi, grid, config.steps, config.interval,
                    config.sensitivity, tap=runner.tap)
            return engine.run_convergence_chunked(
                multi, step, residual, grid, config.steps, config.interval,
                config.sensitivity, tap=runner.tap)
        return multi(grid, config.steps), config.steps

    route = ("sharded-kernel-resid" if fused
             else "sharded-kernel" if kernel else "sharded")
    runner = engine.Runner(run, route)
    runner.halo = resolve_halo_route(config, mesh, kernel)
    return runner


def sharded_inidat(config, mesh: Mesh) -> ShardedGrid:
    """The initial condition, each shard computed on its device from its
    global origin; pad cells of an uneven decomposition hold 0. Only this
    process's shards are built."""
    nx, ny = config.nxprob, config.nyprob
    bm, bn = shard_shape(config, mesh)
    blocks = []
    for i, row in enumerate(mesh.devices):
        out = []
        for j, dev in enumerate(row):
            if not mesh.is_local(i, j):
                out.append(None)
                continue
            x0, y0 = i * bm, j * bn
            val = inidat_block((bm, bn), nx, ny, x0, y0, device=dev)
            gi = x0 + torch.arange(bm, device=dev)[:, None]
            gj = y0 + torch.arange(bn, device=dev)[None, :]
            out.append(torch.where((gi < nx) & (gj < ny), val,
                                   torch.zeros_like(val)))
        blocks.append(out)
    return ShardedGrid(blocks, nx, ny, mesh)
