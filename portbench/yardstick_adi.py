"""The frozen arithmetic of the ADI cells: the work of a solve by
Crank-Nicolson ADI, counted from its sizes alone, as ``yardstick.py``
counts an explicit one.

An update is one cell advanced one whole ADI step (two halves). Per
half, with the elimination scalars (cp, mi) computed once per solve:

- the factored right-hand side ``(1 - c)*u + (c/2)*(n + s)``: an add,
  two multiplies, an add (4 FLOPs);
- the forward sweep ``d_i = (r_i - a*d_{i-1}) * mi_i``: a multiply, a
  subtract, a multiply (3);
- the back substitution ``x_i = d_i - cp_i*x_{i+1}``: a multiply and a
  subtract (2).

So 18 FLOPs an update, the least any evaluation of the scheme needs; the
bytes are the solve's input and output grid once each, ``yardstick``'s
rule. The two solves alone take 10 FLOPs an update and 16 bytes: each
half's solve reads its right-hand side once and writes its result once.
"""

from __future__ import annotations

from portbench.yardstick import CELL_BYTES

#: FLOPs of one ADI update (both halves; see the module docstring).
FLOPS_PER_UPDATE = 18
#: The two tridiagonal solves of one update: FLOPs and bytes.
TRIDIAG_FLOPS_PER_UPDATE = 10
TRIDIAG_BYTES_PER_UPDATE = 4 * CELL_BYTES


def solve_work(nx: int, ny: int, steps: int):
    """(cell updates, FLOPs, bytes) one ADI solve needs: ``nx*ny*steps``
    updates, ``FLOPS_PER_UPDATE`` each, and its input and output grid
    once each."""
    updates = nx * ny * steps
    return (updates, updates * FLOPS_PER_UPDATE, 2 * nx * ny * CELL_BYTES)


def tridiag_work(updates: float):
    """(FLOPs, bytes) the tridiagonal solves of ``updates`` cell updates
    need."""
    return (updates * TRIDIAG_FLOPS_PER_UPDATE,
            updates * TRIDIAG_BYTES_PER_UPDATE)
