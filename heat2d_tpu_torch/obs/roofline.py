"""Roofline ledger: the card's peaks, the byte model of every route, and
the bound, as a package API (the port's counterpart of
``heat2d_tpu/obs/roofline.py``).

- **Peaks.** The single home of the card's published peaks, keyed by
  (device kind, dtype): ``"NVIDIA H100 80GB HBM3"`` at float32 is the one
  calibrated row (3.35e12 B/s of device memory, 67e12 FLOP/s outside the
  tensor cores, at the card's 700 W limit). Any other kind, and the CPU,
  has no row: its bound is ``None``, never a borrowed number.
  ``chip_smoke.py``, ``bench_torch.py`` and ``tune/measure.py`` read
  their peaks here.
- **Routes.** ``resolve_route`` goes through the port's own dispatch
  (``cuda_stencil.fits_resident`` as ``make_single_chip_runner`` and
  ``ensemble._route`` take it, ``problems.runners.pick_route`` for the
  families), so the models below describe the kernel that launches.
- **Bytes a cell-step** (``analytic_bytes_per_cell_step``), per route:
  ``jnp`` (the golden loop; also the solver's mode serial) reads and
  writes the grid each step, ``2b``; ``tile`` (H2/H3 on a grid, H6/H7
  per member, H9 for the families) reads every tile's ext (centre and
  its T-deep ring, ``W * T`` for a family of radius W), clipped to the
  grid, and writes the centre once a sweep, from the planners' own
  ``tile_plan``; ``resident`` (H4, H5, H8) reads and writes the grid once
  a launch and trades each tile's border bands and ring through the
  exchange planes (8-byte words) once per chunk of K steps, from
  ``ops/resident.py``'s plan; ``adi`` and ``mg`` take the JAX package's
  coarse 8b and 16b, marked ``coarse``.
- **Bound** (``roofline_bound``): the larger of the bytes over the
  peak bandwidth and the FLOPs over the peak FLOP rate (heat5 7 an
  update, heat9 22, advdiff 14, reactdiff 12); the coarse routes and
  varcoef are bound by their bytes alone.
- **Launch stamping** (``stamp_launch_row``): achieved against bound on
  every serve and mesh launch row, and the ``perf_*`` gauges.

Pure host arithmetic: nothing here launches a kernel. The planners are
the wrappers' own, so a model follows the tiles a launch takes (the
planner's defaults; a tuning db's plan is not modeled).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

#: dtype name -> element bytes (the request schema's names).
ITEMSIZE = {"float32": 4, "f32": 4, "bfloat16": 2, "bf16": 2,
            "float16": 2, "float64": 8}

#: ``torch.cuda.get_device_name`` of the one calibrated card.
H100_KIND = "NVIDIA H100 80GB HBM3"
#: Its published device-memory bandwidth and float32 rate outside the
#: tensor cores (NVIDIA's data sheet, SXM part, at its 700 W limit).
H100_HBM_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12


class Peaks(NamedTuple):
    bytes_per_s: float
    flops_per_s: float


#: (device kind, dtype) -> peaks. A card joins this table with its own
#: data-sheet row; it never inherits another card's.
PEAKS = {(H100_KIND, "float32"): Peaks(H100_HBM_BYTES_PER_S,
                                       H100_F32_FLOPS)}

#: FLOPs of one cell update per family, each rounded operation counted
#: once (heat5's FMA form: a multiply, two adds, two FMAs). A family
#: without a count (varcoef, which runs the golden loop only), like the
#: coarse routes, is bound by its bytes alone.
FLOPS_PER_CELL_STEP = {"heat5": 7, "heat9": 22, "advdiff": 14,
                       "reactdiff": 12}
#: FLOPs per unknown of a tridiagonal solve: 3 forward, 2 back.
TD_FLOPS_PER_UNKNOWN = 5

#: Bytes of one exchange-plane word of the resident sweep (a value and
#: the number of the exchange that published it).
EXCHANGE_WORD_BYTES = 8


def _itemsize(dtype: str) -> int:
    try:
        return ITEMSIZE[str(dtype)]
    except KeyError:
        raise ValueError(f"no itemsize for dtype {dtype!r}") from None


def peaks(device_kind: Optional[str],
          dtype: str = "float32") -> Optional[Peaks]:
    """The calibrated peaks of (device kind, dtype), or None."""
    return PEAKS.get((device_kind, str(dtype)))


def device_kind(device=None) -> str:
    """The kind ``PEAKS`` is keyed by: the card's name for a CUDA device
    (``torch.cuda.get_device_name``), ``"cpu"`` otherwise."""
    import torch
    dev = torch.device("cpu" if device is None else device)
    if dev.type != "cuda":
        return "cpu"
    return torch.cuda.get_device_name(dev)


def _torch_device(device):
    import torch
    return torch.device("cpu" if device is None else device)


def resolve_route(nx: int, ny: int, method: str = "auto",
                  problem: str = "heat5", *, device=None) -> str:
    """The memory-structure route a (shape, method, problem) runs on
    ``device`` (default the CPU, which plans what the H100 would):
    ``jnp`` | ``resident`` | ``tile`` | ``adi`` | ``mg``. ``method``
    takes the serve vocabulary (auto, jnp, pallas, band, adi, mg) and
    ``serial`` (the solver's golden mode, as jnp). It resolves through
    the port's own gates: ``fits_resident`` for heat5 (the solver's
    ``make_single_chip_runner`` and the ensembles' ``_route``; a pallas
    member without a resident plan advances by tile sweeps, as
    ``ens_resident`` does), ``problems.runners.pick_route`` for the
    other families, which raises a ``ConfigError`` naming an unsupported
    combination."""
    if method in ("adi", "mg", "jnp"):
        return method
    if method == "serial":
        return "jnp"
    dev = _torch_device(device)
    if problem != "heat5":
        from heat2d_tpu_torch.problems.runners import pick_route
        route = pick_route(problem, method, nx, ny, dev)
    else:
        from heat2d_tpu_torch.models import ensemble
        route = ensemble._route(method, problem, nx, ny, dev)
    if route == "pallas":
        from heat2d_tpu_torch.ops.cuda_stencil import fits_resident
        from heat2d_tpu_torch.ops.resident import plan_resident
        if problem == "heat5":
            fits = fits_resident((nx, ny), dev)
        else:
            from heat2d_tpu_torch.problems.base import spec_for
            fits = plan_resident(1, nx, ny, spec_for(problem).halo_width,
                                 dev) is not None
        return "resident" if fits else "tile"
    return {"band": "tile"}.get(route, route)


def _cover(n: int, t: int, g: int, h: int) -> int:
    """Cells of one axis that the g tiles of t centre cells, each with an
    h-deep ring on either side, read inside [0, n)."""
    return sum(min((a + 1) * t + h, n) - max(a * t - h, 0)
               for a in range(g))


def ext_cells(plan, nx: int, ny: int) -> int:
    """Cells of every tile's ext (centre and its ``plan.tsteps``-deep
    ring) that lie in an nx x ny grid: what a strip sweep reads."""
    h = plan.tsteps
    return (_cover(nx, plan.ty, plan.grid[0], h)
            * _cover(ny, plan.tx, plan.grid[1], h))


def _tile_model(nx, ny, b, steps, problem, batch, dev) -> tuple:
    """(bytes a cell-step, model, kernel) of the strip-sweep route."""
    if problem != "heat5":
        from heat2d_tpu_torch.ops import cuda_family as cf
        t = cf.SWEEP_TSTEPS[problem]
        depths = cf.sweep_schedule(steps or t, problem)
        moved = sum(b * (ext_cells(cf.tile_plan(nx, ny, problem, dev, d),
                                   nx, ny) + nx * ny) for d in depths)
        plan = cf.tile_plan(nx, ny, problem, dev, t)
        return (moved / (nx * ny * sum(depths)),
                f"tile ty={plan.ty} tx={plan.tx}, T={t}, "
                f"ring {plan.tsteps}", "H9")
    from heat2d_tpu_torch.ops import cuda_stencil as cs
    t = cs.DEFAULT_TSTEPS
    plan = cs.tile_plan(nx, ny, t, dev)
    n = steps or t
    sweeps = -(-n // t)
    moved = sweeps * b * (ext_cells(plan, nx, ny) + nx * ny)
    return (moved / (nx * ny * n),
            f"tile ty={plan.ty} tx={plan.tx}, T={t}",
            "H2/H3" if batch == 1 else "H6/H7")


def exchange_cells(plan) -> int:
    """Cells one member moves through the exchange planes per exchange:
    every tile's published border bands (``ops.resident._bands``) and
    the in-domain part of its ring, read back."""
    from heat2d_tpu_torch.ops.resident import _bands, _ring
    h = plan.halo
    total = 0
    for ti in range(plan.gx):
        for tj in range(plan.gy):
            total += sum((r1 - r0) * (c1 - c0)
                         for r0, r1, c0, c1 in _bands(plan, ti, tj))
            i0, j0 = ti * plan.ty - h, tj * plan.tx - h
            for r0, r1, c0, c1 in _ring(plan):
                rows = min(i0 + r1, plan.nx) - max(i0 + r0, 0)
                cols = min(j0 + c1, plan.ny) - max(j0 + c0, 0)
                if rows > 0 and cols > 0:
                    total += rows * cols
    return total


def _resident_model(nx, ny, b, steps, problem, batch, dev) -> tuple:
    """(bytes a cell-step, model, kernel) of the resident route."""
    from heat2d_tpu_torch.ops.resident import plan_resident
    w = 1
    if problem != "heat5":
        from heat2d_tpu_torch.problems.base import spec_for
        w = spec_for(problem).halo_width
    plan = plan_resident(batch, nx, ny, w, dev)
    kernel = ("H8" if problem != "heat5"
              else "H4" if batch == 1 else "H5")
    if plan is None:
        raise ValueError(f"no resident plan for {batch} x {nx}x{ny}")
    n = steps or plan.k
    exchanges = (math.ceil(n / plan.k) - 1) if plan.tiles > 1 else 0
    moved = (2 * b * nx * ny
             + exchanges * EXCHANGE_WORD_BYTES * exchange_cells(plan))
    return (moved / (nx * ny * n),
            f"resident {plan.gx}x{plan.gy} tiles, K={plan.k}", kernel)


def analytic_bytes_per_cell_step(nx: int, ny: int, *,
                                 method: str = "auto",
                                 dtype: str = "float32",
                                 problem: str = "heat5",
                                 steps: Optional[int] = None,
                                 batch: int = 1, device=None) -> dict:
    """Device-memory bytes one cell update moves on the route
    (``{"bytes_per_cell_step", "route", "model", "coarse", "kernel"}``,
    ``kernel`` the hand kernel's label or None). ``steps``: the launch's
    step count, which amortizes the resident route's one read and write
    and the tile route's partial sweep; None takes one sweep of T (one
    chunk of K on the resident route), as the JAX package's models
    amortize over its block depth. ``batch``: members of the launch
    (its plan; the bytes per cell do not scale with it)."""
    b = _itemsize(dtype)
    dev = _torch_device(device)
    route = resolve_route(nx, ny, method, problem, device=dev)
    if route == "jnp":
        reads = 1
        if problem != "heat5":
            from heat2d_tpu_torch.problems.base import spec_for
            reads = spec_for(problem).reads_per_step
        n_arrays = reads + 1.0
        return {"bytes_per_cell_step": n_arrays * b, "route": route,
                "model": ("2b stream" if reads == 1
                          else f"{n_arrays:g}b stream (reads={reads})"),
                "coarse": False, "kernel": None}
    if route == "adi":
        return {"bytes_per_cell_step": 8.0 * b, "route": route,
                "model": "~8b (2 sweeps x rhs+thomas)", "coarse": True,
                "kernel": None}
    if route == "mg":
        return {"bytes_per_cell_step": 16.0 * b, "route": route,
                "model": "~16b (V-cycle passes x 4/3)", "coarse": True,
                "kernel": None}
    fn = _resident_model if route == "resident" else _tile_model
    bpcs, model, kernel = fn(nx, ny, b, steps, problem, max(1, batch), dev)
    return {"bytes_per_cell_step": bpcs, "route": route, "model": model,
            "coarse": False, "kernel": kernel}


def mcells_per_hbm_byte(nx: int, ny: int, *, method: str = "auto",
                        dtype: str = "float32", **kw) -> float:
    """Cell updates (in Mcells) bought per device-memory byte: the
    reciprocal of the analytic bytes a cell-step, structural (no clock
    in it)."""
    m = analytic_bytes_per_cell_step(nx, ny, method=method, dtype=dtype,
                                     **kw)
    return 1.0 / (1e6 * m["bytes_per_cell_step"])


def boundary_bytes(nx: int, ny: int, *, batch: int = 1,
                   dtype: str = "float32",
                   convergence: bool = False) -> dict:
    """Bytes a runner's operands and results occupy: u0 and per-member
    (cx, cy) in; u out, and the steps counters of a convergence run
    (the JAX package's model, with its semantics)."""
    b = _itemsize(dtype)
    arg = batch * nx * ny * b + 2 * batch * b        # u0, cxs, cys
    out = batch * nx * ny * b + (4 * batch if convergence else 0)
    return {"argument_bytes": arg, "output_bytes": out,
            "total_bytes": arg + out}


def roofline_bound(nx: int, ny: int, *, method: str = "auto",
                   dtype: str = "float32",
                   device_kind: Optional[str] = None,
                   problem: str = "heat5", steps: Optional[int] = None,
                   batch: int = 1, device=None) -> Optional[dict]:
    """The least time the card could take per cell update, as a rate:
    ``{"bound_mcells_per_s", "bound_by", "route", "source",
    "bytes_per_cell_step", "flops_per_cell_step", "coarse", "kernel"}``,
    or None where (device kind, dtype) has no calibrated peaks (any card
    but the H100, and the CPU). ``device`` plans the route (default the
    CPU, which plans what the H100 would); ``device_kind`` picks the
    peaks."""
    pk = peaks(device_kind, dtype)
    if pk is None:
        return None
    m = analytic_bytes_per_cell_step(nx, ny, method=method, dtype=dtype,
                                     problem=problem, steps=steps,
                                     batch=batch, device=device)
    flops = None if m["coarse"] else FLOPS_PER_CELL_STEP.get(problem)
    t_bytes = m["bytes_per_cell_step"] / pk.bytes_per_s
    t_ops = 0.0 if flops is None else flops / pk.flops_per_s
    by = "bytes" if t_bytes >= t_ops else "operations"
    return {"bound_mcells_per_s": 1.0 / max(t_bytes, t_ops) / 1e6,
            "bound_by": by, "route": m["route"],
            "source": f"{pk.bytes_per_s:g} B/s, {pk.flops_per_s:g} "
                      f"FLOP/s {dtype} ({device_kind})",
            "bytes_per_cell_step": m["bytes_per_cell_step"],
            "flops_per_cell_step": flops, "coarse": m["coarse"],
            "kernel": m["kernel"]}


def stamp_launch_row(row: dict, registry=None, *, nx: int, ny: int,
                     steps: float, members: int, elapsed_s: float,
                     method: str = "auto", dtype: str = "float32",
                     signature: Optional[str] = None,
                     card: Optional[dict] = None,
                     problem: str = "heat5", device=None,
                     route: Optional[str] = None, cards: int = 1) -> dict:
    """Stamp one launch's roofline accounting into its launch-log row
    (``row["perf"]``) and the ``perf_*`` gauge families, with the JAX
    package's keys (and ``bound_by``, ``kernel``).

    ``steps`` may be fractional (a convergence launch passes the mean
    steps done); ``elapsed_s`` is the host's time of the launch until the
    device finished, so the achieved rate is a floor. ``device`` is the
    launch's: its kind picks the peaks (no bound off the H100).
    ``route`` names a route the dispatch does not resolve from
    (``method``, shape): the mesh's spatial route runs the golden loop
    (``"jnp"``). ``cards``: the distinct cards the launch's slots span,
    each of which adds its own bound."""
    cells = float(members) * nx * ny
    achieved = (cells * steps / elapsed_s / 1e6
                if elapsed_s > 0 else 0.0)
    kw = dict(method=route or method, dtype=dtype, problem=problem,
              steps=max(1, int(round(steps))), batch=members,
              device=device)
    m = analytic_bytes_per_cell_step(nx, ny, **kw)
    bound = roofline_bound(nx, ny, device_kind=device_kind(device), **kw)
    ceiling = bound["bound_mcells_per_s"] * cards if bound else None
    perf = {
        "achieved_mcells_per_s": round(achieved, 3),
        "bound_mcells_per_s": (round(ceiling, 1) if bound else None),
        "pct_of_bound": (round(100.0 * achieved / ceiling, 2)
                         if bound else None),
        "bytes_per_cell_step": round(m["bytes_per_cell_step"], 4),
        "mcells_per_hbm_byte": round(
            1.0 / (1e6 * m["bytes_per_cell_step"]), 9),
        "route": m["route"],
        "elapsed_s": round(float(elapsed_s), 6),
        "bound_by": bound["bound_by"] if bound else None,
        "kernel": m["kernel"],
    }
    if card is not None and card.get("arithmetic_intensity") is not None:
        perf["arithmetic_intensity"] = card["arithmetic_intensity"]
    row["perf"] = perf
    if registry is not None:
        sig = signature if signature is not None else str(
            row.get("signature"))
        registry.counter("perf_launches_stamped_total")
        registry.gauge("perf_achieved_mcells_per_s", achieved,
                       signature=sig)
        registry.gauge("perf_bytes_per_cell_step",
                       m["bytes_per_cell_step"], signature=sig)
        if bound is not None:
            registry.gauge("perf_pct_of_bound", perf["pct_of_bound"],
                           signature=sig)
        if perf.get("arithmetic_intensity") is not None:
            registry.gauge("perf_arithmetic_intensity",
                           perf["arithmetic_intensity"], signature=sig)
    return perf
