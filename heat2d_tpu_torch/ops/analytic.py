"""Analytic separable-mode solutions, the accuracy oracle of the implicit
methods. The port's numpy copy of ``heat2d_tpu/ops/analytic.py``.

On the unit-spacing grid with clamped edges, ``v[i, j] = sin(pi i /
(nx-1)) sin(pi j / (ny-1))`` is an exact eigenmode of the discrete
Laplacian: ``dxx v = -lam_x v`` with ``lam_x = 4 sin(pi / (2 (nx-1)))^2``.
It decays as ``exp(-(lam_x + lam_y) alpha t)`` under the semi-discrete
flow, so a scheme's error against it is its time error alone:

- explicit forward Euler: per-step factor ``1 - cx lam_x - cy lam_y``;
- Peaceman-Rachford ADI: ``((1-a)(1-b)) / ((1+a)(1+b))`` with
  ``a = cx lam_x / 2``, ``b = cy lam_y / 2``.

Time is dimensionless: ``that_x = cx * steps``, so two runs reach the
same physical time iff their ``c * steps`` products match.
"""

from __future__ import annotations

import math

import numpy as np


def separable_mode(nx: int, ny: int, dtype=np.float32) -> np.ndarray:
    """The fundamental discrete eigenmode (unit amplitude, zero on every
    edge)."""
    ix = np.sin(np.pi * np.arange(nx, dtype=np.float64) / (nx - 1))
    iy = np.sin(np.pi * np.arange(ny, dtype=np.float64) / (ny - 1))
    return np.outer(ix, iy).astype(dtype)


def mode_eigenvalues(nx: int, ny: int) -> tuple:
    """(lam_x, lam_y) of the fundamental mode: ``dxx v = -lam_x v``."""
    return (4.0 * math.sin(math.pi / (2.0 * (nx - 1))) ** 2,
            4.0 * math.sin(math.pi / (2.0 * (ny - 1))) ** 2)


def mode_solution(nx: int, ny: int, that_x: float, that_y: float,
                  dtype=np.float32) -> np.ndarray:
    """The mode at dimensionless times ``that_x = cx * steps`` and
    ``that_y = cy * steps``, scaled by its exact exponential decay."""
    lx, ly = mode_eigenvalues(nx, ny)
    amp = math.exp(-(lx * that_x + ly * that_y))
    return (separable_mode(nx, ny, np.float64) * amp).astype(dtype)


def explicit_mode_factor(nx: int, ny: int, cx: float, cy: float) -> float:
    """Forward Euler's exact per-step amplification of the mode."""
    lx, ly = mode_eigenvalues(nx, ny)
    return 1.0 - cx * lx - cy * ly


def adi_mode_factor(nx: int, ny: int, cx: float, cy: float) -> float:
    """Peaceman-Rachford ADI's exact per-step amplification of the mode
    (|factor| < 1 for every cx, cy > 0)."""
    lx, ly = mode_eigenvalues(nx, ny)
    a, b = cx * lx / 2.0, cy * ly / 2.0
    return ((1.0 - a) * (1.0 - b)) / ((1.0 + a) * (1.0 + b))


def l2_error(u, ref) -> float:
    """Relative L2 error over the grid: ||u - ref|| / ||ref||."""
    u = np.asarray(u, np.float64)
    ref = np.asarray(ref, np.float64)
    denom = float(np.sqrt(np.sum(ref * ref)))
    if denom == 0.0:
        return float(np.sqrt(np.sum(u * u)))
    return float(np.sqrt(np.sum((u - ref) ** 2)) / denom)
