"""Problem-family updates in plain PyTorch: the port of
``heat2d_tpu/problems/kernels.py``.

Per family:

- ``<fam>_step(u, cx, cy, *constants)``: the plain step. The interior is
  updated and a ``halo_width``-deep boundary ring is held (the clamped
  boundary every mode shares). On a (B, nx, ny) batch the coefficients
  may be (B, 1, 1) float32 tensors, one per member. The family's
  constants default to ``vocab``'s; passed as operands, in the order of
  ``<fam>_scalars``, the step is what the batched kernels H8/H9 compute
  from their (B, S) scalar rows, and so their plain version.
- ``<fam>_np_step(u, cx, cy)``: the numpy oracle, in float64, cast back.
- ``<fam>_scalars(cxs, cys)``: the request's two knobs mapped to the
  family's scalar operands.

Every update is written in the JAX package's operation order, which the
CUDA kernels repeat with one rounding per operation. heat5 re-exports
``ops.stencil.stencil_step``. The JAX package's value form
(``*_step_value``, a concatenation that Mosaic can lower) has no
counterpart: here the ring is held by writing only the interior.
"""

from __future__ import annotations

import numpy as np
import torch

from heat2d_tpu_torch.ops.stencil import stencil_step, stencil_step_var
from heat2d_tpu_torch.vocab import ADVECTION_VELOCITY, REACTION_RATE


def _with_interior(u, new, w):
    """``u`` with its interior inside a ``w``-deep ring set to ``new``."""
    out = u.clone()
    out[..., w:-w, w:-w] = new.to(u.dtype)
    return out


# --------------------------------------------------------------------- #
# heat5: the reference family
# --------------------------------------------------------------------- #

def heat5_step(u, cx, cy):
    """The reference update, ``ops.stencil.stencil_step``."""
    return stencil_step(u, cx, cy)


def heat5_np_step(u, cx, cy):
    v = np.asarray(u, np.float64)
    c = v[1:-1, 1:-1]
    sx = v[2:, 1:-1] + v[:-2, 1:-1]
    sy = v[1:-1, 2:] + v[1:-1, :-2]
    out = np.array(u, copy=True)
    out[1:-1, 1:-1] = (c + cx * (sx - 2.0 * c)
                       + cy * (sy - 2.0 * c)).astype(u.dtype)
    return out


# --------------------------------------------------------------------- #
# varcoef: per-cell diffusivity fields
# --------------------------------------------------------------------- #

def varcoef_profiles(nx, ny, dtype=torch.float32, device=None):
    """The family's coefficient profiles: separable bumps in [0.5, 1]
    (``0.5 + 2 s (1 - s)`` on ``s = linspace(0, 1, n)``), so that
    ``cx * px + cy * py <= cx + cy`` pointwise. Evaluated in float64 and
    rounded once to ``dtype`` (the JAX package evaluates them in float32;
    the two differ by at most an ulp of a profile)."""
    si = np.linspace(0.0, 1.0, nx)[:, None]
    sj = np.linspace(0.0, 1.0, ny)[None, :]
    px = np.broadcast_to(0.5 + 2.0 * si * (1.0 - si), (nx, ny))
    py = np.broadcast_to(0.5 + 2.0 * sj * (1.0 - sj), (nx, ny))
    return (torch.as_tensor(px.copy(), dtype=dtype, device=device),
            torch.as_tensor(py.copy(), dtype=dtype, device=device))


def varcoef_step(u, cx, cy):
    px, py = varcoef_profiles(u.shape[-2], u.shape[-1], u.dtype, u.device)
    return stencil_step_var(u, cx * px, cy * py)


def varcoef_np_step(u, cx, cy):
    nx, ny = u.shape
    si = np.linspace(0.0, 1.0, nx)[:, None]
    sj = np.linspace(0.0, 1.0, ny)[None, :]
    px = 0.5 + 2.0 * si * (1.0 - si)
    py = 0.5 + 2.0 * sj * (1.0 - sj)
    kx = np.broadcast_to(cx * px, (nx, ny))
    ky = np.broadcast_to(cy * py, (nx, ny))
    v = np.asarray(u, np.float64)
    c = v[1:-1, 1:-1]
    sx = v[2:, 1:-1] + v[:-2, 1:-1]
    sy = v[1:-1, 2:] + v[1:-1, :-2]
    out = np.array(u, copy=True)
    out[1:-1, 1:-1] = (c + kx[1:-1, 1:-1] * (sx - 2.0 * c)
                       + ky[1:-1, 1:-1] * (sy - 2.0 * c)).astype(u.dtype)
    return out


# --------------------------------------------------------------------- #
# heat9: 4th-order 9-point (wide) stencil, halo width 2
# --------------------------------------------------------------------- #

def _heat9_interior(u, cx, cy):
    """4th-order central second differences on the w = 2 interior:
    ``(-u[i-2] + 16 u[i-1] - 30 u[i] + 16 u[i+1] - u[i+2]) / 12`` per
    axis, in the JAX package's order (from the i+2 side)."""
    c = u[..., 2:-2, 2:-2]
    dxx = (-u[..., 4:, 2:-2] + 16.0 * u[..., 3:-1, 2:-2] - 30.0 * c
           + 16.0 * u[..., 1:-3, 2:-2] - u[..., :-4, 2:-2]) * (1.0 / 12.0)
    dyy = (-u[..., 2:-2, 4:] + 16.0 * u[..., 2:-2, 3:-1] - 30.0 * c
           + 16.0 * u[..., 2:-2, 1:-3] - u[..., 2:-2, :-4]) * (1.0 / 12.0)
    return c + cx * dxx + cy * dyy


def heat9_step(u, cx, cy):
    return _with_interior(u, _heat9_interior(u, cx, cy), 2)


def heat9_np_step(u, cx, cy):
    v = np.asarray(u, np.float64)
    c = v[2:-2, 2:-2]
    dxx = (-v[4:, 2:-2] + 16.0 * v[3:-1, 2:-2] - 30.0 * c
           + 16.0 * v[1:-3, 2:-2] - v[:-4, 2:-2]) / 12.0
    dyy = (-v[2:-2, 4:] + 16.0 * v[2:-2, 3:-1] - 30.0 * c
           + 16.0 * v[2:-2, 1:-3] - v[2:-2, :-4]) / 12.0
    out = np.array(u, copy=True)
    out[2:-2, 2:-2] = (c + cx * dxx + cy * dyy).astype(u.dtype)
    return out


def heat9_mode_factor(nx, ny, cx, cy):
    """Exact per-step amplification of the lowest separable sine mode
    under the 4th-order operator: eigenvalue ``lam4(k) = (30 - 32 cos k
    + 2 cos 2k) / 12`` at ``k = pi / (n - 1)``."""
    kx = np.pi / (nx - 1)
    ky = np.pi / (ny - 1)

    def lam4(k):
        return (30.0 - 32.0 * np.cos(k) + 2.0 * np.cos(2 * k)) / 12.0

    return 1.0 - cx * lam4(kx) - cy * lam4(ky)


# --------------------------------------------------------------------- #
# advdiff: central advection + diffusion (fixed family velocities)
# --------------------------------------------------------------------- #

def _advdiff_interior(u, cx, cy, vx, vy):
    c = u[..., 1:-1, 1:-1]
    sx = u[..., 2:, 1:-1] + u[..., :-2, 1:-1]
    sy = u[..., 1:-1, 2:] + u[..., 1:-1, :-2]
    dx = u[..., 2:, 1:-1] - u[..., :-2, 1:-1]
    dy = u[..., 1:-1, 2:] - u[..., 1:-1, :-2]
    return (c + cx * (sx - 2.0 * c) + cy * (sy - 2.0 * c)
            - 0.5 * vx * dx - 0.5 * vy * dy)


def advdiff_step(u, cx, cy, vx=ADVECTION_VELOCITY[0],
                 vy=ADVECTION_VELOCITY[1]):
    return _with_interior(u, _advdiff_interior(u, cx, cy, vx, vy), 1)


def advdiff_np_step(u, cx, cy):
    vx, vy = ADVECTION_VELOCITY
    v = np.asarray(u, np.float64)
    c = v[1:-1, 1:-1]
    sx = v[2:, 1:-1] + v[:-2, 1:-1]
    sy = v[1:-1, 2:] + v[1:-1, :-2]
    dx = v[2:, 1:-1] - v[:-2, 1:-1]
    dy = v[1:-1, 2:] - v[1:-1, :-2]
    out = np.array(u, copy=True)
    out[1:-1, 1:-1] = (c + cx * (sx - 2.0 * c) + cy * (sy - 2.0 * c)
                       - 0.5 * vx * dx
                       - 0.5 * vy * dy).astype(u.dtype)
    return out


# --------------------------------------------------------------------- #
# reactdiff: reaction-diffusion with a saturating nonlinear source
# --------------------------------------------------------------------- #
#
# The source r*u/(1+u) (Michaelis-Menten) is nonlinear, which the
# capability matrix gates the implicit methods on, yet bounded by r for
# u >= 0, so the family stays stable on the reference initial condition.

def _reactdiff_interior(u, cx, cy, r):
    c = u[..., 1:-1, 1:-1]
    sx = u[..., 2:, 1:-1] + u[..., :-2, 1:-1]
    sy = u[..., 1:-1, 2:] + u[..., 1:-1, :-2]
    return (c + cx * (sx - 2.0 * c) + cy * (sy - 2.0 * c)
            + r * c / (1.0 + c))


def reactdiff_step(u, cx, cy, r=REACTION_RATE):
    return _with_interior(u, _reactdiff_interior(u, cx, cy, r), 1)


def reactdiff_np_step(u, cx, cy):
    r = REACTION_RATE
    v = np.asarray(u, np.float64)
    c = v[1:-1, 1:-1]
    sx = v[2:, 1:-1] + v[:-2, 1:-1]
    sy = v[1:-1, 2:] + v[1:-1, :-2]
    out = np.array(u, copy=True)
    out[1:-1, 1:-1] = (c + cx * (sx - 2.0 * c) + cy * (sy - 2.0 * c)
                       + r * c / (1.0 + c)).astype(u.dtype)
    return out


# --------------------------------------------------------------------- #
# scalar-operand mappings (the rows of the batched kernels' (B, S) block)
# --------------------------------------------------------------------- #

def heat5_scalars(cx, cy):
    return (cx, cy)


def varcoef_scalars(cx, cy):
    return (cx, cy)


def heat9_scalars(cx, cy):
    return (cx, cy)


def advdiff_scalars(cx, cy):
    vx, vy = ADVECTION_VELOCITY
    return (cx, cy, torch.full_like(cx, vx), torch.full_like(cy, vy))


def reactdiff_scalars(cx, cy):
    return (cx, cy, torch.full_like(cx, REACTION_RATE))
