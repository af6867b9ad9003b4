"""5-point Jacobi stencil: the golden model of the port, in plain
PyTorch (the counterpart of ``heat2d_tpu/ops/stencil.py``).

Precision follows the C reference: storage is float32; the neighbour sums
``uE + uW`` and ``uN + uS`` are taken in the storage dtype, and every
operation with the coefficients in ``accum_dtype``. ``accum_dtype=
torch.float64`` reproduces the C promotion bitwise (tests/c_oracle.c), on
the CPU and on CUDA alike.
"""

from __future__ import annotations

import torch


def _laplacian_update(v, cx, cy, accum_dtype=None):
    """Updated values of ``v[..., 1:-1, 1:-1]`` in ``accum_dtype``
    (default: v's dtype), from the halo-inclusive array ``v``. The
    coefficients are scalars, or (B, 1, 1) float32 tensors that give each
    member of a (B, nx, ny) batch its own."""
    accum = v.dtype if accum_dtype is None else accum_dtype
    c = v[..., 1:-1, 1:-1].to(accum)
    # sx pairs with cx (the ix neighbours), sy with cy, as in the
    # reference (grad1612_cuda_heat.cu:59-61).
    sx = (v[..., 2:, 1:-1] + v[..., :-2, 1:-1]).to(accum)
    sy = (v[..., 1:-1, 2:] + v[..., 1:-1, :-2]).to(accum)
    # A Python float meets a tensor in the tensor's dtype: f32(cx) for
    # the f32 path, the double literal itself for the f64 path.
    if not isinstance(cx, torch.Tensor):
        cx, cy = float(cx), float(cy)
    return c + cx * (sx - 2.0 * c) + cy * (sy - 2.0 * c)


def stencil_step(u, cx, cy, accum_dtype=torch.float32):
    """One global time step. Interior updated, edges held (clamped BC).
    On a (B, nx, ny) batch with (B, 1, 1) float32 coefficients, per member
    the operations of the single-grid step (the JAX package's ``vmap``
    of it)."""
    out = u.clone()
    out[..., 1:-1, 1:-1] = _laplacian_update(u, cx, cy,
                                             accum_dtype).to(u.dtype)
    return out


def stencil_step_padded(padded, cx: float, cy: float,
                        accum_dtype=torch.float32):
    """The updated (bm, bn) interior of a (bm+2, bn+2) halo-padded block;
    global-boundary masking is the caller's job."""
    return _laplacian_update(padded, cx, cy, accum_dtype).to(padded.dtype)


def stencil_step_var(u, kx, ky, accum_dtype=None):
    """One global step with per-cell diffusivities: ``kx``/``ky`` are
    fields of u's shape, and cell (i, j) uses ``kx[i, j]``/``ky[i, j]``
    where the constant step uses cx/cy, so ``stencil_step_var(u,
    full(cx), full(cy))`` equals ``stencil_step(u, cx, cy, None)`` bit
    for bit. Edges held; the fields' edge values are inert.
    ``accum_dtype=None`` accumulates in u's dtype."""
    accum = u.dtype if accum_dtype is None else accum_dtype
    c = u[..., 1:-1, 1:-1].to(accum)
    sx = (u[..., 2:, 1:-1] + u[..., :-2, 1:-1]).to(accum)
    sy = (u[..., 1:-1, 2:] + u[..., 1:-1, :-2]).to(accum)
    kxi = kx[..., 1:-1, 1:-1].to(accum)
    kyi = ky[..., 1:-1, 1:-1].to(accum)
    out = u.clone()
    out[..., 1:-1, 1:-1] = (c + kxi * (sx - 2.0 * c)
                            + kyi * (sy - 2.0 * c)).to(u.dtype)
    return out


def residual_sq(u_new, u_old, accum_dtype=torch.float32):
    """Convergence residual: the sum over cells of (u_new - u_old)^2, the
    reference's locdiff (grad1612_mpi_heat.c:264-267)."""
    d = u_new.to(accum_dtype) - u_old.to(accum_dtype)
    return torch.sum(d * d)
