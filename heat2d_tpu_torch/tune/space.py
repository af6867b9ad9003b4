"""Candidate generation for the kernel search: the port of
``heat2d_tpu/tune/space.py`` over the card's routes.

A (shape, dtype) problem maps to ``Candidate`` configs over three routes:

- ``resident`` (H4, the counterpart of the JAX package's "vmem"): the
  knob is the chunk depth K, steps between two ring exchanges, carried
  in ``tsteps`` with ``bm = 0``; the ladder is 1..``resident.MAX_CHUNK``.
  Viable only where the grid stays on the chip (``fits_resident``), and
  each K only where ``resident.plan_resident(..., k=K)`` has a plan.
- ``tile`` (H2/H3, the counterpart of "C"/"C2"): the knobs are the sweep
  depth T, carried in ``tsteps`` (the JAX package's ladder 4, 8, 12, 16),
  and the tile's centre rows ``ty``, carried in ``bm`` (16, 32, 64:
  multiples of the thread block's 8 rows); the centre columns are what
  ``plan_tiles`` then picks. A point the planner cannot fit, or whose
  tile it shrinks to another point's, is pruned.
- ``fused`` (H14): the problem shape is the per-shard block, the knob the
  overlap depth T (ladder 2, 4, 8, 16), and the points live under their
  own ``fused:BMxBN:dtype`` key. Pruned by the overlap geometry (frames
  must tile the block: bm >= 2T, bn >= 2T) and by ``cs.tile_plan``
  fitting a tile at T.

Every route's candidates include the planner's own pick, so the search
can only match or beat the static plan. Pruning calls the port's own
planners, never a model of them.

Not ported: ``band_est_bytes`` and ``window_alignment_ok`` (the TPU's
VMEM working-set estimate and Mosaic's alignment gates: the card's
planners answer those questions themselves), and the "adi"/"adi_s"
routes, whose knob is ``plan_adi_panel``'s lane panel, TPU geometry the
port has no counterpart of: its ADI has no transpose strategy to choose
(the x half runs through H10, the y half through H11).
"""

from __future__ import annotations

import dataclasses

import torch

#: The search's routes (module docstring).
ROUTES = ("resident", "tile", "fused")

#: Sweep depths of the tile route (the JAX package's ladder).
DEFAULT_T_LADDER = (4, 8, 12, 16)
#: Centre rows of the tile route: multiples of the thread block's rows
#: (``cuda_stencil.BLOCK[1]``).
DEFAULT_TY_GRID = (16, 32, 64)
#: Overlap depths of the fused route (the JAX package's ladder).
DEFAULT_FUSED_T_LADDER = (2, 4, 8, 16)


@dataclasses.dataclass(frozen=True)
class Problem:
    """A tuning problem: one single-device heat5 stencil workload shape.
    (The JAX package also keys other families' frontiers under a
    ``<family>:`` prefix; the port tunes no family kernel, H8/H9, so it
    has none.)"""
    nx: int
    ny: int
    dtype: str = "float32"

    def key(self) -> str:
        """The db problem key, ``NXxNY:dtype``; the route rides in the
        entry."""
        return f"{self.nx}x{self.ny}:{self.dtype}"

    def fused_key(self) -> str:
        """The db key of this shard shape's fused-route frontier. Fused
        points time a mesh program, so they live in their own namespace,
        whose prefix keeps them out of the single-grid lookup ladder;
        ``runtime.fused_config`` queries this key exactly."""
        return f"fused:{self.nx}x{self.ny}:{self.dtype}"

    @property
    def itemsize(self) -> int:
        return torch.empty((), dtype=getattr(torch, self.dtype)).element_size()

    @property
    def cells(self) -> int:
        return self.nx * self.ny


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of the search space: (route, bm, tsteps), the knobs as
    ``TunedConfig`` carries them (integers, so the triple keys the db's
    rows)."""
    route: str
    bm: int = 0
    tsteps: int = 0

    def label(self) -> str:
        if self.route == "resident":
            return f"resident K={self.tsteps}"
        if self.route == "fused":
            return f"fused T={self.tsteps}"
        return f"tile ty={self.bm} T={self.tsteps}"


def planner_pick(problem: Problem, route: str, device) -> Candidate:
    """The static planner's own point of ``route`` on ``problem`` (the
    one every search includes): H4's K from ``resident_plan``, H2's
    (ty, T = 8) from ``tile_plan``, H14's depth ``DEFAULT_HALO_DEPTH``
    clamped to the shard."""
    from heat2d_tpu_torch.ops import cuda_stencil as cs
    if route == "resident":
        plan = cs.resident_plan(problem.nx, problem.ny, device)
        return Candidate("resident", 0, plan.k if plan else 0)
    if route == "tile":
        plan = cs.tile_plan(problem.nx, problem.ny, cs.DEFAULT_TSTEPS,
                            device)
        return Candidate("tile", plan.ty, cs.DEFAULT_TSTEPS)
    if route == "fused":
        from heat2d_tpu_torch.parallel.sharded import DEFAULT_HALO_DEPTH
        return Candidate("fused", 0, max(1, min(
            DEFAULT_HALO_DEPTH, problem.nx, problem.ny)))
    raise ValueError(f"route must be one of {ROUTES}, got {route!r}")


def tile_fits(nx: int, ny: int, ty: int, t: int, device) -> str | None:
    """None when H2's planner takes a tile of ``ty`` centre rows at depth
    ``t`` on an nx x ny grid as asked, else why not: no tile fits the
    shared memory at ``t``, or the planner shrinks the tile (to another
    candidate's plan)."""
    from heat2d_tpu_torch.ops import cuda_stencil as cs
    try:
        plan = cs.tile_plan(nx, ny, t, device, ty)
    except ValueError as e:
        return str(e)
    if plan.ty != ty:
        return (f"the planner shrinks the tile to {plan.ty} rows at T={t} "
                f"(the plan of ty={plan.ty})")
    return None


def candidate_space(problem: Problem, routes=None, ty_grid=None,
                    t_ladder=None, probe_past_envelope: bool = False,
                    device="cpu"):
    """(candidates, pruned) for ``problem`` on ``device`` (a CPU device
    plans what the H100 would).

    ``pruned`` is a list of (candidate, reason) the planners refused,
    surfaced so that a frontier table shows what was never attempted.
    ``probe_past_envelope`` keeps them measurable instead (the failure
    class is then the datum)."""
    from heat2d_tpu_torch.ops import cuda_stencil as cs
    from heat2d_tpu_torch.ops import resident as res
    from heat2d_tpu_torch.parallel.halo import fused_halo_viable

    routes = ROUTES if routes is None else tuple(routes)
    t_ladder = DEFAULT_T_LADDER if t_ladder is None else tuple(t_ladder)
    ty_grid = DEFAULT_TY_GRID if ty_grid is None else tuple(ty_grid)
    nx, ny = problem.nx, problem.ny
    dev = torch.device(device)
    cands: list[Candidate] = []
    pruned: list[tuple[Candidate, str]] = []

    def keep(c, reason):
        if reason is None or probe_past_envelope:
            cands.append(c)
        else:
            pruned.append((c, reason))

    if "resident" in routes:
        gate = cs.fits_resident((nx, ny), dev)
        for k in range(1, res.MAX_CHUNK + 1):
            reason = None
            if not gate:
                reason = ("the grid does not stay on the chip "
                          "(fits_resident)")
            elif res.plan_resident(1, nx, ny, 1, dev, k) is None:
                reason = f"no resident plan at K={k}"
            keep(Candidate("resident", 0, k), reason)

    if "tile" in routes:
        pick = planner_pick(problem, "tile", dev)
        for t in sorted(set(t_ladder) | {pick.tsteps}):
            for ty in sorted(set(ty_grid) | {pick.bm}):
                keep(Candidate("tile", ty, t), tile_fits(nx, ny, ty, t, dev))

    if "fused" in routes:
        pick = planner_pick(problem, "fused", dev)
        for t in sorted(set(DEFAULT_FUSED_T_LADDER) | {pick.tsteps}):
            reason = None
            if not fused_halo_viable(nx, ny, t):
                reason = ("overlap frames exceed the shard (needs "
                          "bm >= 2T and bn >= 2T)")
            else:
                try:
                    cs.tile_plan(nx, ny, t, dev)
                except ValueError as e:
                    reason = str(e)
            keep(Candidate("fused", 0, t), reason)
    return cands, pruned
