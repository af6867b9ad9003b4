"""The plain reference of the ADI configurations: Crank-Nicolson time
stepping by Peaceman-Rachford ADI, in plain PyTorch (any device), for a
batch of members that each carry their own ``(cx, cy)``.

It imports nothing of the program under test and takes nothing the
program made: the benchmark hands both sides the same sizes, steps and
coefficients, and the reference works the grid out again from them.

- ``inidat``: the upstream's initial field, ``reference/heat5.py``'s.
- ``step``: one Peaceman-Rachford step at diffusion numbers (cx, cy),
  each half the explicit half right-hand side, then the CN matrix's
  systems solved along the other axis:

      (I - cx/2 dxx) u* = u  + cy/2 dyy u      (systems along x)
      (I - cy/2 dyy) u1 = u* + cx/2 dxx u*     (systems along y)

  The right-hand side updates the interior and passes the edges through;
  the matrix ``I - (c/2) d2`` has identity rows 0 and n-1, and the edges
  of the result are restored from the step's input, so they are held as
  in the explicit scheme.
- ``thomas``: the textbook Thomas algorithm, its elimination done in full
  from the matrix's three bands (``cn_bands``): ``c'_i = c_i / m_i`` and
  ``d'_i = (d_i - a_i d'_{i-1}) / m_i`` with ``m_i = b_i - a_i c'_{i-1}``,
  then ``x_i = d'_i - c'_i x_{i+1}``. No pivoting: the CN matrices are
  strictly diagonally dominant.
- ``solve``: ``steps`` such steps in the storage type given, every
  operation rounded to it: the check takes float64, the control bfloat16.

The one departure from the Report: the Report reaches its physical time
``t = cx * steps`` by the explicit update at cx = cy = 0.1; the ADI
configurations reach the same ``t`` in steps 250 times larger. ADI is an
O(dt^2) approximation of that time, not the explicit run's answer, so the
check compares the program with this scheme's exact answer (float64),
never with an explicit run.

TF32 plays no part (there is no matrix product); its switches are set
off all the same.
"""

from __future__ import annotations

import torch

from portbench.reference.heat5 import _no_tf32, grid_gaps, inidat


def cn_bands(n: int, c, dtype=torch.float64):
    """The bands ``(a, b, cc)`` of ``I - (c/2) d2`` with identity rows 0
    and n-1, one row of bands per member: each a (B, n) tensor of
    ``dtype`` on the CPU (``c``: a (B,) tensor). Interior rows are
    ``(-c/2, 1 + c, -c/2)``, rows 0 and n-1 ``(0, 1, 0)``."""
    c = c.to("cpu", dtype).reshape(-1, 1)
    interior = torch.zeros(1, n, dtype=torch.bool)
    interior[0, 1:n - 1] = True
    zero = torch.zeros((), dtype=dtype)
    a = torch.where(interior, -0.5 * c, zero)
    b = torch.where(interior, 1.0 + c, torch.ones((), dtype=dtype))
    return a, b, a.clone()


def eliminate(a, b, cc):
    """The forward sweep's scalars of the bands (B, n): ``cp`` (``c'``)
    and ``m``, the pivots, both (B, n) in the bands' dtype."""
    n = b.shape[1]
    cp = torch.empty_like(b)
    m = torch.empty_like(b)
    m[:, 0] = b[:, 0]
    cp[:, 0] = cc[:, 0] / m[:, 0]
    for i in range(1, n):
        m[:, i] = b[:, i] - a[:, i] * cp[:, i - 1]
        cp[:, i] = cc[:, i] / m[:, i]
    return cp, m


def thomas(bands, d):
    """Solve each member's tridiagonal systems along axis 1 of ``d`` (B,
    n, k): ``bands`` is ``system``'s ``(a, cp, m)``, the sub-diagonal and
    the ``eliminate`` scalars, each (B, n). Returns a new (B, n, k)
    tensor."""
    # rows and band columns as views made once: a row costs its
    # arithmetic's launches alone
    a, cp, m = (t.to(d.device).unsqueeze(-1).unbind(1) for t in bands)
    x = d.clone()
    rows = x.unbind(1)
    rows[0].div_(m[0])
    for i in range(1, len(rows)):
        rows[i].addcmul_(rows[i - 1], a[i], value=-1).div_(m[i])
    for i in range(len(rows) - 2, -1, -1):
        rows[i].addcmul_(rows[i + 1], cp[i], value=-1)
    return x


def system(n: int, c, dtype=torch.float64):
    """``(a, cp, m)`` of ``thomas`` for the CN matrices of n rows at the
    (B,) diffusion numbers ``c``."""
    a, b, cc = cn_bands(n, c, dtype)
    cp, m = eliminate(a, b, cc)
    return a, cp, m


def _rhs_half(u, c, axis: int):
    """``u + (c/2) d2 u`` along ``axis`` (1 = x, 2 = y of (B, nx, ny)) on
    the interior; the edges passed through. ``c``: (B, 1, 1)."""
    ctr = u[:, 1:-1, 1:-1]
    if axis == 1:
        s = u[:, 2:, 1:-1] + u[:, :-2, 1:-1]
    else:
        s = u[:, 1:-1, 2:] + u[:, 1:-1, :-2]
    out = u.clone()
    out[:, 1:-1, 1:-1] = ctr + (0.5 * c) * (s - 2.0 * ctr)
    return out


def _hold_edges(v, u):
    """``v``'s interior with ``u``'s four edges."""
    out = u.clone()
    out[:, 1:-1, 1:-1] = v[:, 1:-1, 1:-1]
    return out


def step(u, cx, cy, sx, sy):
    """One Peaceman-Rachford step of every member of ``u`` (B, nx, ny);
    ``cx``, ``cy``: (B, 1, 1) tensors of ``u``'s dtype; ``sx``, ``sy``:
    the ``system`` of the x and y solves."""
    ustar = _hold_edges(thomas(sx, _rhs_half(u, cy, 2)), u)
    rhs = _rhs_half(ustar, cx, 1).transpose(1, 2).contiguous()
    return _hold_edges(thomas(sy, rhs).transpose(1, 2), u)


def solve(nx: int, ny: int, steps: int, cxs, cys, *, dtype=torch.float64,
          device="cpu"):
    """Solve one member per ``(cx, cy)`` pair from ``inidat``. Returns
    ``(grids, steps_done)``: the final grids as a (B, nx, ny) tensor of
    ``dtype`` on ``device``, and each member's steps as a list."""
    _no_tf32()
    b = len(cxs)
    u = inidat(nx, ny, dtype, device).expand(b, nx, ny).contiguous()
    # the coefficients as the configuration holds them, in float32
    cx = torch.tensor(cxs, dtype=torch.float32).to(dtype)
    cy = torch.tensor(cys, dtype=torch.float32).to(dtype)
    sx, sy = system(nx, cx, dtype), system(ny, cy, dtype)
    cx, cy = cx.to(device).view(b, 1, 1), cy.to(device).view(b, 1, 1)
    for _ in range(steps):
        u = step(u, cx, cy, sx, sy)
    return u, [steps] * b


def check_answers(answers, nx: int, ny: int, steps: int, *, block: int,
                  device="cpu") -> dict:
    """The widest of each gap (``heat5.grid_gaps``) over ``answers``, a
    list of ``(cx, cy, grid, steps_done)`` the program returned, each
    against the reference's solve of its own ``(cx, cy)`` in float64; the
    reference steps ``block`` members together."""
    init = inidat(nx, ny, torch.float64, device)
    out = {"grid_gap": 0.0, "grid_rms_gap": 0.0}
    for lo in range(0, len(answers), block):
        part = answers[lo:lo + block]
        grids, _ = solve(nx, ny, steps, [a[0] for a in part],
                         [a[1] for a in part], device=device)
        for got, ref in zip(part, grids):
            for k, v in grid_gaps(got[2], ref, init).items():
                out[k] = max(out[k], v)
        del grids
    return out
