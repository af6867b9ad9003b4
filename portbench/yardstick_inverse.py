"""The frozen arithmetic of the inverse cells: the work of one Adam
iteration of an initial-field recovery through the checkpointed adjoint,
counted from its sizes alone, as ``yardstick.py`` counts a solve.

An update is one cell advanced one step of the forward; an iteration
makes ``nx*ny*steps`` of them. Each takes heat5's 7 FLOPs three times:

- the forward, the step itself (``yardstick.FLOPS_PER_UPDATE``);
- the backward's recompute of the step from its segment's stored start;
- the pullback, the transposed step: a cell's own share and its four
  neighbours' scatter, as many operations as the step.

So 21 FLOPs an update, the least a checkpointed gradient needs. The
bytes are the iteration's grids read or written once each: the
parameters, the gradient, the observations, the mask, Adam's first and
second moments.
"""

from __future__ import annotations

from portbench.yardstick import CELL_BYTES, FLOPS_PER_UPDATE

#: FLOPs of one update of an iteration: forward, recompute, pullback.
FLOPS_PER_UPDATE = 3 * FLOPS_PER_UPDATE["heat5"]
#: The grids an iteration moves once each: params, gradient,
#: observations, mask, Adam's m and v.
GRIDS_PER_ITERATION = 6


def iteration_work(nx: int, ny: int, steps: int):
    """(cell updates, FLOPs, bytes) one Adam iteration needs:
    ``nx*ny*steps`` updates, ``FLOPS_PER_UPDATE`` each, and
    ``GRIDS_PER_ITERATION`` float32 grids once each."""
    updates = nx * ny * steps
    return (updates, updates * FLOPS_PER_UPDATE,
            GRIDS_PER_ITERATION * nx * ny * CELL_BYTES)
