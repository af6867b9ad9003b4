"""Text grid writers, byte-compatible with the reference's ``.dat`` files
and with ``heat2d_tpu/io/writers.py``.

- **baseline** (mpi_heat2Dn.c:253-268, ``prtdat``): lines run over the y
  index descending, each line over x ascending; ``%6.1f`` values with one
  space between them and none at the end.
- **rowmajor** (grad1612_mpi_heat.c:191-203): row-major; every value
  ``"%6.1f "`` (a trailing space after each, the last included), one
  line per row.

Python's ``%`` formatting and C's ``%6.1f`` give the same bytes for the
same double. The writers format through the native formatter
(``native/heat2d_io.cpp``, built at first use into ``build/native/``), as
the JAX package's do; a failed build with a compiler present raises. Only
where no compiler exists do they use the Python formatter (a whole line
formatted by one ``%`` over a tuple). ``dat_writer()`` names the one that
runs, which the CLIs put in their run records.
"""

from __future__ import annotations

import numpy as np

from heat2d_tpu_torch.io.binary import _host_f32, write_text_atomic
from heat2d_tpu_torch.native import lib as native_lib


def _grid(u) -> np.ndarray:
    a = _host_f32(u)
    if a.ndim != 2:
        raise ValueError(f"expected a 2D grid, got shape {a.shape}")
    return a


def dat_writer() -> str:
    """The formatter the writers run: "native", or "python" where no C++
    compiler exists."""
    return "native" if native_lib.available() else "python"


def _native():
    """The native formatter, or None where no compiler exists (a failed
    build with one raises ``native.lib.NativeBuildError``)."""
    return native_lib.load() if native_lib.available() else None


def python_format_baseline(u) -> str:
    """The Python formatter of the baseline layout."""
    a = _grid(u)
    nx, ny = a.shape
    fmt = " ".join(["%6.1f"] * nx)
    return "".join(fmt % tuple(a[:, iy].tolist()) + "\n"
                   for iy in range(ny - 1, -1, -1))


def python_format_rowmajor(u) -> str:
    """The Python formatter of the row-major layout."""
    a = _grid(u)
    fmt = "%6.1f " * a.shape[1]
    return "".join(fmt % tuple(row) + "\n" for row in a.tolist())


def format_grid_baseline(u) -> str:
    """mpi_heat2Dn.c prtdat byte format (y-descending lines, x across)."""
    a = _grid(u)
    nat = _native()
    return nat.format_baseline(a) if nat else python_format_baseline(a)


def format_grid_rowmajor(u) -> str:
    """grad1612 writer byte format (row-major, trailing space per value)."""
    a = _grid(u)
    nat = _native()
    return nat.format_rowmajor(a) if nat else python_format_rowmajor(a)


def write_grid_baseline(u, path) -> None:
    write_text_atomic(format_grid_baseline(u), path)


def write_grid_rowmajor(u, path) -> None:
    write_text_atomic(format_grid_rowmajor(u), path)


def read_grid_text(path, layout: str = "rowmajor") -> np.ndarray:
    """Parse either .dat layout back into a row-major (nx, ny) float32 grid."""
    with open(path) as f:
        rows = [[float(tok) for tok in line.split()]
                for line in f if line.strip()]
    a = np.asarray(rows, dtype=np.float32)
    if layout == "rowmajor":
        return a
    if layout == "baseline":
        return a[::-1].T.copy()
    raise ValueError(f"unknown layout {layout!r}")
