"""Initial condition (the reference's ``inidat``).

``u0[ix][iy] = ix*(nx-ix-1)*iy*(ny-iy-1)``, zero on every edge, evaluated
in float32 with the JAX package's expression and operation order
(``heat2d_tpu/ops/init.py``), so the two are bitwise equal.
"""

from __future__ import annotations

import torch


def inidat(nx: int, ny: int, dtype=torch.float32, device="cpu"):
    """Full-grid initial condition, identical to mpi_heat2Dn.c:242-248."""
    return inidat_block((nx, ny), nx, ny, 0, 0, dtype, device)


def inidat_block(block_shape, nx: int, ny: int, x_offset, y_offset,
                 dtype=torch.float32, device="cpu"):
    """Initial condition for a local block whose top-left cell sits at
    global (x_offset, y_offset)."""
    bm, bn = block_shape
    ix = (torch.arange(bm, dtype=dtype, device=device)[:, None]
          + torch.tensor(x_offset, dtype=dtype, device=device))
    iy = (torch.arange(bn, dtype=dtype, device=device)[None, :]
          + torch.tensor(y_offset, dtype=dtype, device=device))
    nxf = torch.tensor(nx, dtype=dtype, device=device)
    nyf = torch.tensor(ny, dtype=dtype, device=device)
    return ix * (nxf - ix - 1) * iy * (nyf - iy - 1)
