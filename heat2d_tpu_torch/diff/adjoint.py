"""The differentiable solve: a checkpointed-segment adjoint over the fused
multi-step primal (the port of ``heat2d_tpu/diff/adjoint.py``).

Autograd through a plain loop of T steps keeps every step's graph and
state alive for the backward pass: O(T) device memory. ``_DiffSolve``, a
``torch.autograd.Function`` that stands where the JAX package's
``jax.custom_vjp`` stands, makes the storage a choice:

- ``adjoint="checkpoint"`` (default): the forward keeps only each
  segment's first state (K defaults to ~sqrt(T), ``segment_schedule``);
  the backward walks the segments in reverse, recomputes each segment's
  states from its stored start, then pulls the cotangent back step by
  step. Memory O(T/K + K), compute ~2x the forward.
- ``adjoint="full"``: the reference. The forward stores every state
  (``models.engine.run_fixed_stacked``) and the backward recomputes
  nothing; it walks the same schedule over the stored trajectory, so on
  the per-step routes the two adjoints give the same gradient bit for
  bit.

Both differentiate in the initial state and the coefficients, scalar
(cx, cy) (``coeff="const"``) or per-cell (kx, ky) fields
(``coeff="var"``, ``ops.stencil.stencil_step_var``).

The primal. ``method="jnp"`` is a loop of the plain step
(``stencil_step(..., accum_dtype=None)`` or ``stencil_step_var``),
``method="adi"`` a loop of ``ops.tridiag.adi_step``, and
``method="band"`` (constant coefficients) the fused tile sweeps of H6
``ens_tile_multi`` on a (1, nx, ny) batch (``ops.cuda_ensemble.
ens_tiled_chunk``), the kernel that replaces the JAX package's B6/B7 at
B = 1. On a CUDA tensor the band primal launches H6 or raises; on a CPU
tensor it runs H6's plain version. H6 takes float32 only, and its FMA
step form differs from the plain step by an ulp here and there, so band
refuses ``adjoint="full"`` (as the JAX package does) and the bitwise
checkpoint-against-full guarantee holds on the per-step routes.
``method="auto"`` takes band where the JAX package does (a real
accelerator, and a grid too large for the single-grid resident route:
here a card and ``cuda_stencil.fits_resident`` false), else jnp.

The pullback. The JAX package has no backward kernel: its pullback is
``jax.vjp`` of the jnp step, which XLA computes, and it recomputes each
segment with that per-step step even where the primal ran the band
kernel. The port does the same: the backward's recompute is the plain
step, and each step's vjp is ``torch.autograd.grad`` of that same step
at its stored or recomputed state, on the tensors' device. That is the
counterpart of the JAX package's jnp code, not a plain version standing
in for a hand kernel; a hand adjoint-step kernel would be a feature the
JAX package lacks.

The band route consults the tuning db (``tune.runtime.adjoint_config``)
for H6's sweep depth and tile height on the grid's shape, where a db is
active: ``make_diff_solve`` pre-resolves it, as the JAX package does, so
that the inverse records carry ``tuned_config``, and each fused segment
takes it. The plan moves no bit of the primal.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from heat2d_tpu_torch.diff.vocab import ADJOINTS, COEFFS, METHODS
from heat2d_tpu_torch.models.engine import run_fixed_stacked
from heat2d_tpu_torch.ops.stencil import stencil_step, stencil_step_var
from heat2d_tpu_torch.utils.device import resolve_device


def segment_schedule(steps: int, segment=None) -> tuple:
    """``steps`` split into segment lengths: full segments of ``segment``
    steps and one remainder. ``segment=None`` takes ~sqrt(steps), which
    minimizes stored plus recomputed states. Empty for steps = 0."""
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")
    if steps == 0:
        return ()
    if segment is None:
        segment = max(1, int(round(math.sqrt(steps))))
    segment = int(segment)
    if segment < 1:
        raise ValueError(f"segment must be >= 1, got {segment}")
    n_full, rem = divmod(steps, segment)
    return (segment,) * n_full + ((rem,) if rem else ())


@dataclasses.dataclass(frozen=True)
class DiffSpec:
    """The static spec of one differentiable solve; hashable."""
    nx: int
    ny: int
    steps: int
    coeff: str = "const"          # "const" (scalar cx, cy) | "var" (fields)
    adjoint: str = "checkpoint"   # "checkpoint" | "full"
    schedule: tuple = ()          # segment lengths (sum == steps)
    method: str = "jnp"           # primal route (resolved)


# --------------------------------------------------------------------- #
# step / multi-step primitives
# --------------------------------------------------------------------- #

def _step(spec: DiffSpec, u, a, b):
    """One step in u's dtype: the plain step of the coefficient form, or
    the ADI step (whose tridiagonal solves differentiate implicitly,
    ``ops.tridiag._ThomasSolve``)."""
    if spec.method == "adi":
        from heat2d_tpu_torch.ops.tridiag import adi_step
        return adi_step(u, a, b)
    if spec.coeff == "const":
        return stencil_step(u, a, b, accum_dtype=None)
    return stencil_step_var(u, a, b)


def _multi(spec: DiffSpec, u, a, b, n: int):
    """``n`` steps without keeping the states: the fused primal."""
    if n == 0:
        return u
    if spec.method == "band":
        from heat2d_tpu_torch.models.ensemble import tuned_tile
        from heat2d_tpu_torch.ops.cuda_ensemble import ens_tiled_chunk
        if u.dtype != torch.float32:
            raise ValueError(
                f"method='band' runs H6 ens_tile_multi, which takes "
                f"float32 grids, got {u.dtype}: use method='jnp'")
        batch = u.contiguous()[None]
        return ens_tiled_chunk(batch, n, a.reshape(1), b.reshape(1),
                               **tuned_tile(batch))[0]
    for _ in range(n):
        u = _step(spec, u, a, b)
    return u


def _segment_states(spec: DiffSpec, u, a, b, n: int):
    """(u after n steps, states): ``states[t]`` is the input of step t.
    The per-step step, whatever the primal's route, so that a recomputed
    segment is bit for bit the stored trajectory."""
    return run_fixed_stacked(lambda v: _step(spec, v, a, b), u, n)


def _step_vjp(spec: DiffSpec, u_t, a, b, w):
    """(du, da, db): the cotangent ``w`` of one step's output pulled back
    to its inputs, the step linearized at ``u_t``."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (u_t, a, b)]
        out = _step(spec, *ins)
        return torch.autograd.grad(out, ins, w, allow_unused=True,
                                   materialize_grads=True)


# --------------------------------------------------------------------- #
# the autograd operator
# --------------------------------------------------------------------- #

class _DiffSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec: DiffSpec, u0, a, b):
        ctx.spec = spec
        if not any(ctx.needs_input_grad):
            # The primal alone: the fused forward, no stored state.
            return _multi(spec, u0, a, b, spec.steps)
        if spec.adjoint == "full":
            u_final, stored = _segment_states(spec, u0, a, b, spec.steps)
        else:
            # Each segment's first state, filled in place.
            stored = u0.new_empty((len(spec.schedule),) + tuple(u0.shape))
            u_final = u0
            for i, k in enumerate(spec.schedule):
                stored[i] = u_final
                u_final = _multi(spec, u_final, a, b, k)
        ctx.save_for_backward(stored, a, b)
        return u_final

    @staticmethod
    def backward(ctx, wbar):
        spec = ctx.spec
        stored, a, b = ctx.saved_tensors
        w, ga, gb = wbar, torch.zeros_like(a), torch.zeros_like(b)
        starts = [sum(spec.schedule[:i]) for i in range(len(spec.schedule))]
        for i in reversed(range(len(spec.schedule))):
            n = spec.schedule[i]
            if spec.adjoint == "full":
                seg = stored[starts[i]:starts[i] + n]
            else:
                # The stored start's segment, recomputed by the same
                # per-step step the full route stored its states with.
                _, seg = _segment_states(spec, stored[i], a, b, n)
            for t in reversed(range(n)):
                w, da, db = _step_vjp(spec, seg[t], a, b, w)
                ga = ga + da
                gb = gb + db
            # free this segment's states before the next one is
            # recomputed: one segment's states live at a time
            del seg
        return None, w, ga, gb


# --------------------------------------------------------------------- #
# public entry
# --------------------------------------------------------------------- #

def _resolve_method(method: str, nx: int, ny: int, coeff: str,
                    adjoint: str, device: torch.device) -> str:
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}, got {method!r}")
    if coeff == "var":
        if method in ("band", "adi"):
            raise ValueError(
                f"method={method!r} supports coeff='const' only (the "
                "band/tridiagonal kernels take scalar diffusivities; "
                "the variable-coefficient route runs the jnp step)")
        return "jnp"
    if method == "adi":
        # per-step on both adjoints: full storage and checkpoints compose
        return "adi"
    if adjoint == "full":
        # Full storage records every state through the per-step loop;
        # the fused band primal (FMA form) cannot reproduce it bit for
        # bit, so the two do not compose.
        if method == "band":
            raise ValueError(
                "adjoint='full' records every step state (per-step "
                "scan); it cannot run the fused band primal — use "
                "adjoint='checkpoint' with method='band', or "
                "method='jnp'")
        return "jnp"
    if method != "auto":
        return method
    from heat2d_tpu_torch.ops.cuda_stencil import fits_resident
    if device.type == "cuda" and not fits_resident((nx, ny), device):
        return "band"
    return "jnp"


def make_diff_solve(nx: int, ny: int, steps: int, *, coeff: str = "const",
                    adjoint: str = "checkpoint", segment=None,
                    method: str = "auto", device=None):
    """Build the differentiable solve ``f(u0, a, b) -> u_final`` on
    ``device`` (the card unless ``device="cpu"``).

    ``u0`` is the (nx, ny) initial grid; ``(a, b)`` are scalar ``(cx,
    cy)`` for ``coeff="const"`` or per-cell ``(kx, ky)`` fields for
    ``coeff="var"``, converted to u0's dtype. ``f`` is differentiable in
    all three through ``torch.autograd``, and its reverse-mode memory
    follows ``adjoint``/``segment`` (module docstring). ``f.spec`` is the
    resolved ``DiffSpec``."""
    if nx < 3 or ny < 3:
        raise ValueError(f"grid must be at least 3x3, got {nx}x{ny}")
    if coeff not in COEFFS:
        raise ValueError(f"coeff must be one of {COEFFS}, got {coeff!r}")
    if adjoint not in ADJOINTS:
        raise ValueError(
            f"adjoint must be one of {ADJOINTS}, got {adjoint!r}")
    dev = resolve_device(device)
    spec = DiffSpec(nx=int(nx), ny=int(ny), steps=int(steps), coeff=coeff,
                    adjoint=adjoint,
                    schedule=segment_schedule(steps, segment),
                    method=_resolve_method(method, nx, ny, coeff, adjoint,
                                           dev))
    if spec.method == "band":
        # The db's answer for the fused segments, resolved before the
        # first solve so that the applied-config provenance reaches the
        # records (each segment consults it again).
        from heat2d_tpu_torch.tune import runtime as tune_runtime
        tune_runtime.adjoint_config(nx, ny, device=dev)

    def solve(u0, a, b):
        u0 = torch.as_tensor(u0, device=dev)
        if tuple(u0.shape) != (spec.nx, spec.ny):
            raise ValueError(
                f"u0 must be ({spec.nx}, {spec.ny}), got "
                f"{tuple(u0.shape)}")
        a = torch.as_tensor(a, dtype=u0.dtype, device=dev)
        b = torch.as_tensor(b, dtype=u0.dtype, device=dev)
        want = () if spec.coeff == "const" else (spec.nx, spec.ny)
        if tuple(a.shape) != want or tuple(b.shape) != want:
            raise ValueError(
                f"coeff={spec.coeff!r} takes coefficient shape {want}, "
                f"got {tuple(a.shape)}/{tuple(b.shape)}")
        return _DiffSolve.apply(spec, u0, a, b)

    solve.spec = spec
    return solve
