"""Algorithm-based fault tolerance (ABFT) checksums: the port of
``heat2d_tpu/ops/abft.py`` (Huang & Abraham, IEEE ToC 1984).

Both time-steppers the engines serve are linear in the grid state, so a
weighted checksum ``s_t = <w, u_t>`` evolves by a closed-form recurrence
when ``w`` is the discrete separable sine mode
(``ops.analytic.separable_mode``: zero on every edge, an exact
eigenvector of the interior second differences):

- **explicit** (jnp / pallas / band): ``s_{t+1} = alpha s_t + beta`` with
  ``alpha = 1 - cx lam_x - cy lam_y`` and the constant boundary flux
  ``beta = cx Bx + cy By`` of the held edge ring;
- **adi**: with zero edges (the serving initial condition) ``beta = 0``
  and ``alpha`` is the rational ADI amplification factor;
- **mg** is iterative, not an exact linear recurrence: unsupported.

After ``k`` steps ``s_k = alpha^k s_0 + beta (alpha^k - 1) / (alpha - 1)``
(``s_0 + k beta`` at alpha == 1). The verify tier predicts it from a
launch's own inputs on the device (``predict_batch``), observes ``<w,
u_k>`` on the device (``observe_batch``) and on the host buffer that is
about to be served (``host_checksum``), and flags a residual beyond the
roundoff tolerance ``factor * steps * eps * scale`` as silent data
corruption. Exponent and sign flips are caught at any grid size; low
mantissa flips lie below the roundoff floor and pass.

The host algebra is numpy; ``predict_batch`` and ``observe_batch`` are
float32 weighted reductions in torch on the batch's device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from heat2d_tpu_torch.ops.analytic import (adi_mode_factor,
                                           explicit_mode_factor,
                                           separable_mode)

#: methods whose per-step update is the explicit 5-point program
EXPLICIT_METHODS = frozenset({"jnp", "pallas", "band"})

#: ABFT family per resolved method; absent = unsupported
FAMILIES = {m: "explicit" for m in EXPLICIT_METHODS} | {"adi": "adi"}


def supported_family(method: str):
    """``"explicit"`` / ``"adi"`` for a resolved method (never
    ``"auto"``), else None."""
    return FAMILIES.get(method)


@functools.lru_cache(maxsize=32)
def mode_weights(nx: int, ny: int) -> np.ndarray:
    """The float64 checksum weight field (read-only; host side)."""
    w = separable_mode(nx, ny, np.float64)
    w.setflags(write=False)
    return w


def host_checksum(u, w=None) -> np.ndarray:
    """``<w, u>`` in float64 over the trailing two axes: the host-side
    observation of the buffer about to be served (one grid or a
    batch)."""
    with np.errstate(invalid="ignore"):   # a flipped bit may be a NaN
        u = np.asarray(u, np.float64)
        if w is None:
            w = mode_weights(u.shape[-2], u.shape[-1])
        return np.einsum("...ij,ij->...", u, np.asarray(w, np.float64))


def step_factor(family: str, nx: int, ny: int, cx, cy):
    """The per-step checksum amplification ``alpha`` (the analytic mode
    factors; ``cx``/``cy`` may be per-member tensors or arrays)."""
    if family == "explicit":
        return explicit_mode_factor(nx, ny, cx, cy)
    if family == "adi":
        return adi_mode_factor(nx, ny, cx, cy)
    raise ValueError(f"no ABFT family {family!r}")


def boundary_flux(u0, w, cx, cy):
    """The constant flux term ``beta`` of the explicit recurrence, exactly
    0 for zero-edge states. ``u0``: (..., nx, ny); ``w``: (nx, ny)."""
    bx = ((w[1, 1:-1] * u0[..., 0, 1:-1]).sum(axis=-1)
          + (w[-2, 1:-1] * u0[..., -1, 1:-1]).sum(axis=-1))
    by = ((w[1:-1, 1] * u0[..., 1:-1, 0]).sum(axis=-1)
          + (w[1:-1, -2] * u0[..., 1:-1, -1]).sum(axis=-1))
    return cx * bx + cy * by


def _power(alpha, k):
    """``alpha ** k`` elementwise for float ``alpha`` (possibly negative:
    the explicit factor crosses zero inside the stability box) and
    integer ``k >= 0``, by exp/log with the parity sign restored, as the
    JAX package computes it."""
    a = alpha.abs()
    kf = k.to(a.dtype)
    mag = torch.exp(kf * torch.log(torch.where(a > 0.0, a,
                                               torch.ones_like(a))))
    mag = torch.where(a > 0.0, mag, (k == 0).to(a.dtype))
    sign = torch.where((alpha < 0.0) & (k % 2 == 1), -1.0, 1.0)
    return torch.where(k == 0, torch.ones_like(alpha), mag * sign)


def predict(s0, alpha, beta, k):
    """``s_k`` by the closed-form recurrence (per-member tensors)."""
    ak = _power(alpha, k)
    near = (alpha - 1.0).abs() > 1e-6
    geom = torch.where(near, (ak - 1.0) / torch.where(
        near, alpha - 1.0, torch.ones_like(alpha)), k.to(ak.dtype))
    return ak * s0 + beta * geom


def predict_batch(u0, cxs, cys, k, w, *, family: str):
    """The per-member prediction from a launch's own inputs, on their
    device: ``(s_pred, scale)`` for a (B, nx, ny) float32 batch. ``w`` is
    the mode-weight field as a float32 tensor on the batch's device;
    ``k`` the per-member step count (int32). ``scale``, the magnitude
    the tolerance is relative to, is ``<|w|, |u0|> + |s0| + k |beta|``."""
    s0 = torch.einsum("bij,ij->b", u0, w)
    beta = (boundary_flux(u0, w, cxs, cys) if family == "explicit"
            else torch.zeros_like(s0))
    alpha = step_factor(family, u0.shape[-2], u0.shape[-1], cxs, cys)
    s_pred = predict(s0, alpha, beta, k)
    scale = (torch.einsum("bij,ij->b", u0.abs(), w.abs())
             + s0.abs() + k.to(s0.dtype) * beta.abs())
    return s_pred, scale


def observe_batch(u, w):
    """The on-device observation ``<w, u_k>`` per member."""
    return torch.einsum("bij,ij->b", u, w)


def tolerance(scale, steps, dtype=np.float32,
              factor: float = 64.0) -> np.ndarray:
    """The roundoff envelope of ``|s_obs - s_pred|``: linear in the step
    count, ``factor`` absorbing the reduction-order and exp/log
    constants."""
    eps = float(np.finfo(dtype).eps)
    steps = np.asarray(steps, np.float64)
    return factor * np.maximum(steps, 1.0) * eps * np.asarray(
        scale, np.float64)


def classify(s_obs, s_pred, scale, steps, dtype=np.float32,
             factor: float = 64.0) -> np.ndarray:
    """Boolean per-member corruption verdict: True where the residual
    escapes the tolerance or an observation is non-finite."""
    s_obs = np.asarray(s_obs, np.float64)
    s_pred = np.asarray(s_pred, np.float64)
    tol = tolerance(scale, steps, dtype, factor)
    resid = np.abs(s_obs - s_pred)
    return (~np.isfinite(s_obs)) | (~np.isfinite(s_pred)) | (resid > tol)


def host_predict(u0, cx, cy, steps, *, method: str):
    """Host-side float64 mirror of ``predict_batch`` for one member (the
    test oracle)."""
    family = supported_family(method)
    if family is None:
        raise ValueError(f"method {method!r} has no ABFT recurrence")
    u0 = np.asarray(u0, np.float64)
    w = mode_weights(u0.shape[-2], u0.shape[-1])
    s0 = float(np.einsum("ij,ij->", u0, w))
    beta = (float(boundary_flux(u0, w, cx, cy))
            if family == "explicit" else 0.0)
    alpha = float(step_factor(family, u0.shape[-2], u0.shape[-1],
                              cx, cy))
    if steps == 0:
        return s0
    if abs(alpha - 1.0) > 1e-12:
        ak = alpha ** steps
        return ak * s0 + beta * (ak - 1.0) / (alpha - 1.0)
    return s0 + steps * beta
