"""Wall-clock to solution at matched accuracy: the port of
``heat2d_tpu/models/solution.py``.

Mcells/s says how fast a kernel burns steps; this says how fast a method
reaches an answer. Every method runs to the same physical time at the
same (or better) L2 accuracy against the analytic separable mode
(``ops/analytic.py``), so the comparison isolates the time stepping. The
explicit leg is pinned to its stability box (checked here), and each
implicit leg runs ``step_ratio`` times fewer steps at ``step_ratio`` times
the diffusion number. The modeled speedup uses a step cost in
explicit-sweep units; the measured wall clock rides beside it.

``use_kernels=True`` runs the explicit leg through H6 (``ensemble.
_run_batch_band``, one member) and the ADI leg through H10/H11
(``tridiag.batched_adi_kernel``); otherwise both run the plain steps. The
JAX package gates its ADI kernel on VMEM (``adi_kernel_viable``); the
card has no such envelope. MG is plain PyTorch either way.
"""

from __future__ import annotations

import numpy as np
import torch

from heat2d_tpu_torch.ops import analytic
from heat2d_tpu_torch.ops.stability import check_explicit_stability

#: Step cost in explicit-sweep units, the JAX package's (so the modeled
#: speedups agree): an ADI step runs two tridiagonal sweeps, two
#: half-RHS stencils and, there, transposes; an MG step MG_CYCLES V(2,2)
#: cycles of smoothing sweeps plus the transfers.
STEP_UNITS = {"explicit": 1.0, "adi": 10.0, "mg": 16.0}

#: The implicit leg's L2 error may exceed the explicit leg's by at most
#: this factor, or sit below the dtype's roundoff floor: an ADI step at
#: diffusion number c has roundoff ~c eps against the explicit ~eps.
ACCURACY_MARGIN = 1.5


def accuracy_floor(dtype) -> float:
    """Roundoff floor of the matched-accuracy verdict: 400 eps relative
    L2 (f32: ~5e-5)."""
    return 400.0 * float(np.finfo(np.dtype(dtype)).eps)


def modeled_wall_s(method: str, nx: int, ny: int, steps: int,
                   unit_mcells_per_s: float = 1000.0) -> float:
    """Modeled time to solution: steps x sweep units x per-sweep cell
    cost (the rate cancels out of every speedup)."""
    return steps * STEP_UNITS[method] * nx * ny / (unit_mcells_per_s * 1e6)


def _run_leg(method: str, u0, steps: int, cx: float, cy: float,
             use_kernels: bool):
    """One timed leg on u0's device: (final grid on the host, elapsed s),
    under the reference timing protocol (a warmup run, then a fenced
    timed run)."""
    from heat2d_tpu_torch.ops import multigrid as mgrid
    from heat2d_tpu_torch.ops import tridiag as td
    from heat2d_tpu_torch.ops.stencil import stencil_step
    from heat2d_tpu_torch.utils.timing import timed_call

    c = torch.full((1,), cx, dtype=u0.dtype, device=u0.device)
    d = torch.full((1,), cy, dtype=u0.dtype, device=u0.device)
    if method == "explicit":
        if use_kernels:
            from heat2d_tpu_torch.models.ensemble import _run_batch_band

            def run(u):
                return _run_batch_band(u[None], c, d, steps=steps)[0]
        else:
            def run(u):
                for _ in range(steps):
                    u = stencil_step(u, cx, cy, accum_dtype=None)
                return u
    elif method == "adi":
        if use_kernels:
            def run(u):
                return td.batched_adi_kernel(u[None], c, d, steps=steps)[0]
        else:
            def run(u):
                return td.adi_multi_step(u, steps, cx, cy)
    elif method == "mg":
        def run(u):
            return mgrid.mg_multi_step(u, steps, cx, cy)
    else:
        raise ValueError(f"unknown method {method!r}")
    out, elapsed = timed_call(run, u0)
    return out.cpu().numpy(), float(elapsed)


def time_to_solution(nx: int, ny: int, *, steps_explicit: int,
                     step_ratio: int, cx: float = 0.2, cy: float = 0.2,
                     methods=("explicit", "adi"), use_kernels: bool = False,
                     device=None, dtype=np.float32) -> dict:
    """Run every method to the same ``t_final`` and compare (``dtype``,
    float32 by default; float64 runs the plain steps only, the kernels
    being float32). The explicit leg runs ``steps_explicit`` steps at
    (cx, cy), checked against the stability box; each implicit leg
    ``steps_explicit // step_ratio`` steps at the diffusion numbers that
    reach the same dimensionless time. Returns ``{"rows": [...],
    "summary": {...}}``."""
    from heat2d_tpu_torch.utils.device import resolve_device
    if step_ratio < 1:
        raise ValueError(f"step_ratio must be >= 1, got {step_ratio}")
    dtype = np.dtype(dtype)
    if use_kernels and dtype != np.float32:
        raise ValueError(f"the kernels run float32, not {dtype}")
    dev = resolve_device(device)
    that_x = cx * steps_explicit
    that_y = cy * steps_explicit
    u0 = torch.from_numpy(analytic.separable_mode(nx, ny, dtype)).to(dev)
    ref = analytic.mode_solution(nx, ny, that_x, that_y, np.float64)

    rows = []
    for method in methods:
        if method == "explicit":
            steps, lcx, lcy = steps_explicit, cx, cy
            check_explicit_stability(
                lcx, lcy, where="time-to-solution explicit leg")
        else:
            steps = max(1, steps_explicit // step_ratio)
            lcx, lcy = that_x / steps, that_y / steps
        u, elapsed = _run_leg(method, u0, steps, lcx, lcy, use_kernels)
        rows.append({
            "method": method,
            "steps": steps,
            "cx": lcx, "cy": lcy,
            "time_to_solution_s": elapsed,
            "modeled_s": modeled_wall_s(method, nx, ny, steps),
            "accuracy": analytic.l2_error(u, ref),
        })

    by = {r["method"]: r for r in rows}
    summary = {"nx": nx, "ny": ny, "that_x": that_x, "that_y": that_y,
               "dtype": dtype.name, "device": str(dev)}
    if "explicit" in by:
        exp = by["explicit"]
        for method, r in by.items():
            if method == "explicit":
                continue
            summary[f"{method}_steps_ratio"] = exp["steps"] / r["steps"]
            summary[f"{method}_wall_speedup"] = (
                exp["time_to_solution_s"] / r["time_to_solution_s"]
                if r["time_to_solution_s"] > 0 else float("nan"))
            summary[f"{method}_modeled_speedup"] = (
                exp["modeled_s"] / r["modeled_s"])
            summary[f"{method}_matched_accuracy"] = bool(
                r["accuracy"] <= max(ACCURACY_MARGIN * exp["accuracy"],
                                     accuracy_floor(dtype)))
    return {"rows": rows, "summary": summary}


def bench_tts(quick: bool = False, use_kernels: bool = True,
              device=None) -> dict:
    """The bench shape of the comparison: explicit at the stability edge
    against ADI at 256x the step size, on 513^2 (257^2 when quick)."""
    nx = ny = 257 if quick else 513
    steps = 640 if quick else 2560
    return time_to_solution(
        nx, ny, steps_explicit=steps, step_ratio=256, cx=0.2, cy=0.2,
        use_kernels=use_kernels, device=device)
