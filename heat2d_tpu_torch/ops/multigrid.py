"""Geometric multigrid V-cycles for Crank-Nicolson steps: the implicit
method ``mg`` in plain PyTorch, the port of ``heat2d_tpu/ops/multigrid.py``
(which runs no Pallas kernel of its own).

Each step solves the unsplit CN system

    A u1 = (I - cx/2 dxx - cy/2 dyy) u1 = (I + cx/2 dxx + cy/2 dyy) u

with a fixed number of V-cycles. The smoother is one damped-Jacobi sweep,
algebraically the explicit stencil at rescaled coefficients plus an
elementwise correction,

    u <- stencil_step(u, w cx/(2D), w cy/(2D)) + (w/D) (rhs - u),

with ``D = 1 + cx + cy``. Restriction is full weighting, prolongation
bilinear, and the coarse operator the rediscretized system (diffusion
numbers quarter per level). Vertex-centred coarsening applies while both
sizes are odd (2^k + 1 grids coarsen to 5x5); the coarsest level is
relaxed with extra sweeps. Edges are held at every level.

Every function takes an (nx, ny) grid or a (B, nx, ny) batch; the
coefficients are float32 tensors that broadcast against it (0-dim, or
(B, 1, 1) per member), so that every operation is the float32 one of the
JAX package.
"""

from __future__ import annotations

import torch

from heat2d_tpu_torch.ops.stencil import stencil_step

#: Cycle shape: nu1/nu2 pre/post smoothing sweeps, coarsest-level sweeps,
#: V-cycles per CN step, damped-Jacobi weight, smallest coarse size.
MG_NU1 = 2
MG_NU2 = 2
MG_COARSE_SWEEPS = 24
MG_CYCLES = 2
MG_OMEGA = 0.8
MG_MIN_SIZE = 5


def _interior(x):
    return x[..., 1:-1, 1:-1]


def _with_interior(u, new):
    out = u.clone()
    out[..., 1:-1, 1:-1] = new
    return out


def cn_apply(u, cx, cy):
    """``A u`` on the interior, edges passed through (identity rows)."""
    c = _interior(u)
    sx = u[..., 2:, 1:-1] + u[..., :-2, 1:-1]
    sy = u[..., 1:-1, 2:] + u[..., 1:-1, :-2]
    return _with_interior(
        u, c - 0.5 * cx * (sx - 2.0 * c) - 0.5 * cy * (sy - 2.0 * c))


def cn_rhs(u, cx, cy):
    """The CN right-hand side ``(I + cx/2 dxx + cy/2 dyy) u`` on the
    interior, edges passed through."""
    c = _interior(u)
    sx = u[..., 2:, 1:-1] + u[..., :-2, 1:-1]
    sy = u[..., 1:-1, 2:] + u[..., 1:-1, :-2]
    return _with_interior(
        u, c + 0.5 * cx * (sx - 2.0 * c) + 0.5 * cy * (sy - 2.0 * c))


def residual(u, rhs, cx, cy):
    """``rhs - A u`` on the interior, zero on the edges."""
    r = rhs - cn_apply(u, cx, cy)
    return _with_interior(torch.zeros_like(r), _interior(r))


def smooth(u, rhs, cx, cy, omega: float = MG_OMEGA):
    """One damped-Jacobi sweep on ``A u = rhs`` (module docstring)."""
    # a tensor numerator: ``float / tensor`` would be reciprocal * float
    dinv = torch.full_like(cx, omega) / (1.0 + cx + cy)
    s = stencil_step(u, 0.5 * cx * dinv, 0.5 * cy * dinv, accum_dtype=None)
    corr = dinv * (_interior(rhs) - _interior(u))
    return _with_interior(s, _interior(s) + corr)


def can_coarsen(nx: int, ny: int) -> bool:
    """Vertex-centred coarsening keeps the boundary in place only on odd
    sizes; both sizes must stay >= MG_MIN_SIZE after halving."""
    return (nx % 2 == 1 and ny % 2 == 1
            and (nx - 1) // 2 + 1 >= MG_MIN_SIZE
            and (ny - 1) // 2 + 1 >= MG_MIN_SIZE)


def restrict(r):
    """Full-weighting restriction of a zero-edge residual onto the
    ((n+1)/2, (m+1)/2) coarse grid; coarse edges stay zero."""
    c = r[..., 2:-2:2, 2:-2:2]
    n4 = (r[..., 1:-3:2, 2:-2:2] + r[..., 3:-1:2, 2:-2:2]
          + r[..., 2:-2:2, 1:-3:2] + r[..., 2:-2:2, 3:-1:2])
    d4 = (r[..., 1:-3:2, 1:-3:2] + r[..., 1:-3:2, 3:-1:2]
          + r[..., 3:-1:2, 1:-3:2] + r[..., 3:-1:2, 3:-1:2])
    nc = (r.shape[-2] - 1) // 2 + 1
    mc = (r.shape[-1] - 1) // 2 + 1
    out = r.new_zeros(r.shape[:-2] + (nc, mc))
    out[..., 1:-1, 1:-1] = (4.0 * c + 2.0 * n4 + d4) / 16.0
    return out


def prolong(e, shape):
    """Bilinear prolongation of a zero-edge coarse correction onto the
    fine grid ``shape``."""
    out = e.new_zeros(e.shape[:-2] + tuple(shape))
    out[..., ::2, ::2] = e
    out[..., 1::2, ::2] = 0.5 * (e[..., :-1, :] + e[..., 1:, :])
    out[..., ::2, 1::2] = 0.5 * (e[..., :, :-1] + e[..., :, 1:])
    out[..., 1::2, 1::2] = 0.25 * (e[..., :-1, :-1] + e[..., :-1, 1:]
                                   + e[..., 1:, :-1] + e[..., 1:, 1:])
    return out


def v_cycle(u, rhs, cx, cy, nu1: int = MG_NU1, nu2: int = MG_NU2):
    """One V(nu1, nu2) cycle on ``A u = rhs``."""
    for _ in range(nu1):
        u = smooth(u, rhs, cx, cy)
    nx, ny = u.shape[-2:]
    if can_coarsen(nx, ny):
        rc = restrict(residual(u, rhs, cx, cy))
        # the coarse spacing doubles: the diffusion numbers quarter
        ec = v_cycle(torch.zeros_like(rc), rc, cx / 4.0, cy / 4.0, nu1, nu2)
        u = u + prolong(ec, (nx, ny))
    else:
        for _ in range(MG_COARSE_SWEEPS):
            u = smooth(u, rhs, cx, cy)
    for _ in range(nu2):
        u = smooth(u, rhs, cx, cy)
    return u


def mg_solve(u0, rhs, cx, cy, cycles: int = MG_CYCLES):
    """``cycles`` V-cycles on ``A u = rhs`` from ``u0``."""
    u = u0
    for _ in range(cycles):
        u = v_cycle(u, rhs, cx, cy)
    return u


def _coef(u, c):
    """``c`` as a float32 tensor on u's device that broadcasts against
    u: 0-dim for a scalar, (B, 1, 1) for a vector of B members."""
    c = torch.as_tensor(c, dtype=u.dtype, device=u.device)
    return c.reshape(-1, 1, 1) if c.dim() == 1 else c


def mg_step(u, cx, cy, cycles: int = MG_CYCLES):
    """One CN step at diffusion numbers (cx, cy), solved by ``cycles``
    V-cycles from the previous state. Unconditionally stable; edges
    held. ``cx``/``cy``: scalars, or (B,) vectors for a batch."""
    cx, cy = _coef(u, cx), _coef(u, cy)
    return mg_solve(u, cn_rhs(u, cx, cy), cx, cy, cycles=cycles)


def mg_multi_step(u, steps: int, cx, cy, cycles: int = MG_CYCLES):
    """``steps`` CN/multigrid steps."""
    for _ in range(steps):
        u = mg_step(u, cx, cy, cycles=cycles)
    return u
